"""Image-based KLT feature tracker: the real frontend.

Orchestrates the JAX frontend kernels (clahe/pyramid/GFTT in image.py,
forward+backward pyramidal LK in klt.py) into the reference's per-frame
tracking behavior (reference: xrslam/src/xrslam/core/
feature_tracker.cpp:24-153 FeatureTracker::work and
xrslam/src/xrslam/map/frame.cpp:55-174
Frame::{detect_keypoints,track_keypoints}):

  1. CLAHE preprocess + 3-level LK pyramid on arrival,
  2. rotation-predicted initial flow from the gyro preintegration of
     the inter-frame interval composed with camera/IMU extrinsics
     (frame.cpp:82-93),
  3. forward+backward pyramidal LK with border / displacement /
     round-trip gates (opencv_image.cpp:75-154),
  4. essential-matrix RANSAC inlier gate (frame.cpp:108-114),
  5. two-point rotation RANSAC + 70th-percentile misalignment angle →
     FT_NO_TRANSLATION tag (frame.cpp:115-134),
  6. track-length-priority Poisson-disk re-filter (frame.cpp:137-163),
  7. GFTT + spacing-filtered detection of new keypoints into free
     slots (frame.cpp:55-72).

Keypoint storage is fixed-capacity (C slots per frame) so every jitted
kernel compiles exactly once per image shape.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Config
from ..core import nputil
from ..core.detail import FeatureTrackerBase
from ..core.map import FrameRec, PipelineMap
from ..ransac import stereo as stereo_mod
from ..utils import inspection
from ..utils.fetch import fetch_packed, fetch_packed_start
from . import image as img_ops
from . import klt


def _poisson_accept(pts: np.ndarray, order: np.ndarray, keep_ok: np.ndarray,
                    min_dist: float) -> np.ndarray:
    """Greedy spacing filter over pts[order]: accept a point iff it is
    ≥ min_dist from every previously accepted point (reference
    utility/poisson_disk_filter.h grid filter, used at
    frame.cpp:148-163). Returns accept mask aligned with pts. Runs in
    the native runtime (native/xr_host.cpp xr_poisson_filter) when
    built."""
    from .. import native

    nat = native.poisson_filter(pts, order, keep_ok, min_dist)
    if nat is not None:
        return nat
    accept = np.zeros(len(pts), dtype=bool)
    cell = min_dist / np.sqrt(2.0)
    grid = {}
    for i in order:
        if not keep_ok[i]:
            continue
        p = pts[i]
        gx, gy = int(p[0] // cell), int(p[1] // cell)
        ok = True
        for dx in range(-2, 3):
            for dy in range(-2, 3):
                for j in grid.get((gx + dx, gy + dy), ()):
                    if np.sum((pts[j] - p) ** 2) < min_dist * min_dist:
                        ok = False
                        break
                if not ok:
                    break
            if not ok:
                break
        if ok:
            accept[i] = True
            grid.setdefault((gx, gy), []).append(i)
    return accept


@partial(jax.jit, static_argnames=("rot_thresh_deg", "mis_thresh_deg"))
def _post_klt_gates(key, nxt, status, bearings_prev, Kinv,
                    rot_thresh_deg: float, mis_thresh_deg: float):
    """Device-side post-KLT gates, fused so the whole frontend step
    needs ONE host readback (each separate fetch pays the full
    host<->device round trip):

      - bearing lift of the tracked pixel positions,
      - essential-matrix RANSAC inlier gate (reference frame.cpp:108-114),
      - 2-pt rotation RANSAC + 70th-percentile misalignment angle ->
        FT_NO_TRANSLATION (frame.cpp:115-134), including the percentile
        selection that previously ran on host.

    Both gates only take effect when >= 8 points survived KLT, matching
    the host-side `status.sum() >= 8` gate of the reference.

    Returns (b_next (C,3) unit bearings, status_out, no_translation ()).
    """
    C = nxt.shape[0]
    dt = bearings_prev.dtype
    h = jnp.concatenate([nxt.astype(dt), jnp.ones((C, 1), dt)], axis=1)
    b = h @ Kinv.T.astype(dt)
    b_next = b / jnp.linalg.norm(b, axis=1, keepdims=True)

    h_prev = bearings_prev / jnp.clip(bearings_prev[:, 2:3], 1e-9, None)
    h_next = b / jnp.clip(b[:, 2:3], 1e-9, None)
    k1, k2 = jax.random.split(key)
    _, e_mask, _ = stereo_mod.find_essential_matrix(
        k1, h_prev, h_next, valid=status, threshold=1.0)
    apply = jnp.sum(status) >= 8
    st = jnp.where(apply, status & e_mask, status)

    R_rot, r_mask, _ = stereo_mod.find_rotation_matrix(
        k2, bearings_prev, b_next, valid=st,
        threshold=np.pi / 180.0 * rot_thresh_deg)
    r_mask = r_mask & st
    cosang = jnp.clip(
        jnp.sum((bearings_prev @ R_rot.T) * b_next, axis=1), -1.0, 1.0)
    ang = jnp.degrees(jnp.arccos(cosang))
    ang_sorted = jnp.sort(jnp.where(r_mask, ang, jnp.inf))
    m = jnp.sum(r_mask)
    mis = jnp.where(
        m > 0, ang_sorted[jnp.clip((m * 7) // 10, 0, C - 1)], 0.0)
    no_trans = apply & (mis < mis_thresh_deg)
    return b_next, st, no_trans


def detect_no_translation(key, bearings_prev, bearings_next, valid, cfg) -> bool:
    """Pure-rotation (FT_NO_TRANSLATION) detector shared by the image
    tracker and the synthetic stub: 2-pt rotation RANSAC between the
    matched bearing sets, then the 70th-percentile rotation-misalignment
    angle against the config threshold (reference frame.cpp:115-134).
    bearings_* are fixed-capacity (C,3) unit bearings with `valid`."""
    R_rot, r_mask, _ = stereo_mod.find_rotation_matrix(
        key, jnp.asarray(bearings_prev), jnp.asarray(bearings_next),
        valid=jnp.asarray(valid),
        threshold=np.pi / 180.0 * cfg.rotation_ransac_threshold)
    R_rot = np.asarray(R_rot)
    r_mask = np.asarray(r_mask) & valid
    if r_mask.sum() > 0:
        cosang = np.clip(
            np.sum((bearings_prev @ R_rot.T) * bearings_next, axis=1), -1, 1)
        angles = np.sort(np.degrees(np.arccos(cosang[r_mask])))
        misalignment = angles[len(angles) * 7 // 10]
    else:
        misalignment = 0.0
    return misalignment < cfg.rotation_misalignment_threshold


@partial(jax.jit, static_argnames=("rot_thresh_deg", "mis_thresh_deg",
                                   "win", "iters", "eps", "border"))
def _chained_track_step(key, prev_pyr, cur_pyr, pts, valid, bear,
                        upd_keep, upd_pts, upd_mask, upd_bear,
                        R_pred, K, Kinv,
                        rot_thresh_deg, mis_thresh_deg,
                        win, iters, eps, border):
    """One frame of the device-chained frontend: apply the host's
    (lagged) slot update, rotation-predict initial flow, run fwd+bwd
    KLT from the DEVICE-side previous positions, and the fused
    essential/rotation gates — no host input from the previous frame's
    results is needed, so this dispatches before the previous pack has
    landed (Config.chained_frontend).

    Returns (nxt, status, b_next, no_trans); (nxt, status, b_next) is
    also the next frame's device state."""
    C = pts.shape[0]
    f32 = pts.dtype
    # host slot update (Poisson drops + new detections, one frame late)
    pts = jnp.where(upd_mask[:, None], upd_pts.astype(f32), pts)
    bear = jnp.where(upd_mask[:, None], upd_bear.astype(bear.dtype), bear)
    valid = (valid & upd_keep) | upd_mask

    # rotation-predicted initial flow (frame.cpp:82-93), in-program.
    # f32 operands at HIGHEST: a reduced-precision matmul (bf16/TF32)
    # makes ~0.4% bearing error, ~1 px of initial-flow error — enough
    # to flip the 0.5 px reverse-consistency gate
    HI = jax.lax.Precision.HIGHEST
    H, W = cur_pyr[0].shape
    pred_b = jnp.einsum("ij,nj->ni", R_pred.astype(bear.dtype), bear,
                        precision=HI)
    z = jnp.clip(pred_b[:, 2:3], 1e-6, None)
    uv = jnp.einsum("ij,nj->ni", K.astype(bear.dtype), pred_b / z,
                    precision=HI)[:, :2].astype(f32)
    inb = ((uv[:, 0] >= 0) & (uv[:, 0] < W) & (uv[:, 1] >= 0)
           & (uv[:, 1] < H) & (pred_b[:, 2] > 0))
    pts_init = jnp.where((inb & valid)[:, None], uv, pts)

    nxt, status = klt.track_keypoints(prev_pyr, cur_pyr, pts, pts_init,
                                      valid, win=win, iters=iters, eps=eps,
                                      border=border)
    bp = jnp.where(valid[:, None], bear,
                   jnp.array([0.0, 0.0, 1.0], bear.dtype))
    # nested jit inlines under trace
    b_next, status, no_trans = _post_klt_gates(
        key, nxt, status, bp, Kinv, rot_thresh_deg=rot_thresh_deg,
        mis_thresh_deg=mis_thresh_deg)
    return nxt, status, b_next, no_trans


@partial(jax.jit, static_argnames=("clip_limit", "tiles_x", "tiles_y",
                                   "levels"))
def _preprocess_image(im, clip_limit, tiles_x, tiles_y, levels):
    """CLAHE + pyramid. uint8 on the wire (4x less host->device
    bandwidth than f32, and the reference feeds CLAHE an 8-bit Mat
    anyway — opencv_image.cpp:156-161); floats still accepted."""
    imf = im.astype(jnp.float32) if im.dtype == jnp.uint8 else im * 255.0
    return img_ops.build_pyramid(
        img_ops.clahe(imf, clip_limit=clip_limit, tiles_x=tiles_x,
                      tiles_y=tiles_y),
        levels=levels)


class KLTFeatureTracker(FeatureTrackerBase):
    """Feeds the pipeline map from raw grayscale images.

    Frames carry `_image` ((H,W) float32 in [0,1]) set by
    VIOPipeline.track_camera_image; this tracker attaches `_pts`
    ((C,2) pixel coords) and `_pyr` (the CLAHE'd pyramid, kept until the
    next frame has been tracked — the reference's
    release_image_buffer lifetime, feature_tracker.cpp:126)."""

    def __init__(self, config: Config, capacity: int = 256,
                 pyramid_levels: int = 3):
        self.config = config
        self.capacity = capacity
        self.levels = pyramid_levels
        self._rng = np.random.default_rng(config.random)
        self._prev: Optional[FrameRec] = None
        self._Kinv_dev = None  # cached device K^-1 (intrinsics are fixed)
        self._fetch_worker_inst = None  # lazy (worker_overlap only)
        self._pending: Optional[dict] = None  # in-flight pipelined frame
        self.last_finished: Optional[FrameRec] = None
        # device-chained frontend (Config.chained_frontend): KLT chains
        # from device-side state so dispatch never waits on the host's
        # previous-frame bookkeeping
        self.chained = bool(getattr(config, "chained_frontend", False)
                            and config.worker_overlap
                            and config.pipelined_writeback
                            and not config.parsac_flag)
        self._dev: Optional[tuple] = None   # (pts, valid, bear) on device
        self._dev_frame_id = None           # frame the state corresponds to
        self._slot_upd: Optional[tuple] = None  # staged (keep,pts,mask,bear)
        self._pending_new: list = []  # staged first-obs of new detections

        cfg = config
        # module-level jit keyed by static CLAHE params: a per-instance
        # jax.jit closure would recompile the (large) CLAHE program for
        # every new tracker/pipeline instance
        self._preprocess = partial(
            _preprocess_image,
            clip_limit=float(cfg.feature_tracker_clahe_clip_limit),
            tiles_x=int(cfg.feature_tracker_clahe_width),
            tiles_y=int(cfg.feature_tracker_clahe_height),
            levels=int(pyramid_levels))

    # ------------------------------------------------------------------
    def track_frame(self, tracker_map: PipelineMap, frame: FrameRec,
                    rider=None, between=None) -> None:
        """One frame of tracking + detection.

        Structured as dispatch-everything / fetch-once: every device
        kernel for the frame (pyramid, KLT, RANSAC gates, GFTT) is
        dispatched asynchronously, then a SINGLE device→host transfer
        pulls all host-needed results — one round trip per frame
        instead of ~7. A
        `rider` fetch handle (the backend's deferred write-back buffer)
        gets its transfer folded into the same round trip.

        With a `between` callback (worker_overlap) the tracker runs a
        TWO-FRAME SOFTWARE PIPELINE: this frame's fetch is started on
        the persistent fetch worker and track_frame RETURNS with it in
        flight; the PREVIOUS frame was completed at the top of this
        call, after this frame's image upload. The round trip therefore
        rides behind the backend stage (`between`), the pipeline's IMU
        host work, the next image's decode + upload, and the next
        frame's dispatches — the host only blocks for whatever latency
        those could not hide (the reference hides the same latency with
        its FeatureTracker worker thread, utility/worker.h:8-58).
        `between` (the backend stage for the previous frame) runs after
        this frame's dispatches; a fetch handle it returns is pulled on
        the same worker."""
        from ..utils.timing import stage_timer

        from ..utils.fetch import trace_mark

        trace_mark(f"frame:{frame.id}")
        image = getattr(frame, "_image", None)
        assert image is not None, "KLTFeatureTracker needs frame._image"
        if image.dtype != np.uint8:
            im_dev = np.clip(image * 255.0 + 0.5, 0, 255).astype(np.uint8)
        else:
            im_dev = image
        with stage_timer("tracker_upload_time"):
            pyr = self._preprocess(jnp.asarray(im_dev))

        frame._pyr = pyr
        frame._pts = np.zeros((self.capacity, 2), dtype=np.float64)

        if self.chained and between is not None \
                and self._prev is not None and hasattr(self._prev, "_pyr"):
            # device-chained path: KLT dispatches from device state —
            # the previous frame's pack is finished AFTER this frame's
            # dispatch + submit, off the critical serial loop. The
            # state must correspond to the PREVIOUS frame (its pyramid
            # is the template); at bootstrap/fallback boundaries,
            # finishing the previous frame first seeds it from the
            # standard path's final host layout.
            if self._dev is None or self._dev_frame_id != self._prev.id:
                self.finish_pending()
            if self._dev is not None \
                    and self._dev_frame_id == self._prev.id:
                self._track_frame_chained(tracker_map, frame, rider,
                                          between)
                return

        # land the previous frame now — its fetch has been in flight
        # across the frame boundary; this frame's KLT dispatch needs its
        # final keypoint layout
        self.finish_pending()

        prev = self._prev
        fetch = {}
        track_ctx = None
        with stage_timer("tracker_dispatch_time"):
            if prev is not None and prev.n_keypoints() > 0 and hasattr(prev, "_pyr"):
                track_ctx = self._dispatch_track(prev, frame, fetch)

        # detection only on frames issued to the backend (reference
        # slidind_window_frame_tag gate, feature_tracker.cpp:128-129)
        detect = getattr(frame, "_detect_tag", True)
        if detect:
            cand, resp, cvalid = img_ops.gftt_candidates(
                frame._pyr[0], max_candidates=1024, quality_level=1e-3,
                border=20)
            fetch["cand"] = cand
            fetch["cvalid"] = cvalid

        if between is not None:
            # pipelined: the backend stage's host work overlaps the
            # KLT/GFTT programs already executing on device, and its
            # deferred write-back buffers ride a tracker pack — steady
            # state pays exactly ONE device→host round trip per frame.
            # The pull runs on the fetch worker and track_frame RETURNS
            # with it in flight; finish_pending() at the next frame's
            # call (or flush) completes it, which also lands the riders
            # before the backend asks for them.
            #
            # Two orderings:
            #  - rider is None (depth-1): run the backend FIRST, fold
            #    its fresh write-back into THIS pack — the pack then
            #    waits on this frame's solve programs on device.
            #  - rider pre-collected (pipelined_writeback, depth-2):
            #    the pack carries only EARLIER frames' solve buffers
            #    (already executed), so the pull never waits on the
            #    current frame's solve programs. The backend still runs
            #    BEFORE the submit, so its window uploads are queued
            #    ahead of the pull.
            import threading

            riders = []

            def _attach(pend):
                for i, h in enumerate(pend if isinstance(pend, (list, tuple))
                                      else [pend]):
                    if h is not None and h.flat is not None \
                            and h._event is None and h._buf is None \
                            and not getattr(h, "_riding", False):
                        h._riding = True
                        key = f"_rider{len(riders)}"
                        fetch[key] = h.flat
                        riders.append((key, h))

            def _submit():
                handle = fetch_packed_start(fetch, async_copy=False,
                                            label="pack") if fetch else None
                box = {}
                ev_b = threading.Event()

                def _pull_pack():
                    try:
                        if handle is not None:
                            box["vals"] = handle.get()
                    except BaseException as e:  # propagate to caller
                        box["err"] = e
                    finally:
                        ev_b.set()

                self._fetch_worker.submit(_pull_pack)
                return box, ev_b

            if rider is not None:
                _attach(rider)
                box, ev_b = _submit()
                between()
            else:
                pend = between()
                if pend is not None:
                    _attach(pend)
                box, ev_b = _submit()
            self._pending = {
                "frame": frame, "prev": prev, "ctx": track_ctx,
                "detect": detect, "box": box, "event": ev_b,
                "map": tracker_map, "image": image, "riders": riders,
            }
            self._prev = frame
            return

        riders = []
        if rider is not None:
            for i, h in enumerate(rider if isinstance(rider, (list, tuple))
                                  else [rider]):
                if h is not None and h.flat is not None \
                        and h._event is None and h._buf is None \
                        and not getattr(h, "_riding", False):
                    h._riding = True
                    fetch[f"_rider{i}"] = h.flat
                    riders.append((f"_rider{i}", h))
        with stage_timer("tracker_fetch_time"):
            vals = fetch_packed(fetch) if fetch else {}  # ONE transfer
        for key, h in riders:
            if key in vals:
                h.complete_with(vals.pop(key))

        if track_ctx is not None:
            self._finish_track(tracker_map, prev, frame, track_ctx, vals)
        if detect:
            self._finish_detect(tracker_map, frame, vals)

        if prev is not None and hasattr(prev, "_pyr"):
            del prev._pyr  # release_image_buffer
        self._finalize_frame(tracker_map, frame, image)
        self._prev = frame

    def finish_pending(self) -> None:
        """Complete the in-flight frame of the two-frame pipeline: wait
        for its packed fetch (already pulled — or being pulled — by the
        fetch worker), then run the host half of tracking + detection.
        No-op when nothing is pending."""
        from ..utils.timing import stage_timer

        p = self._pending
        if p is None:
            return
        self._pending = None
        with stage_timer("tracker_fetch_time"):
            p["event"].wait()
        if "err" in p["box"]:
            raise p["box"]["err"]
        vals = p["box"].get("vals", {})
        # land the backend's deferred buffers that rode this frame's
        # pack (write-back, localize result, ...): the next backend
        # stage finds them ready, no extra round trip
        for key, h in p.get("riders", ()):
            if key in vals:
                h.complete_with(vals.pop(key))
        frame, prev = p["frame"], p["prev"]
        tracker_map = p["map"]
        if p["ctx"] is not None and p["ctx"].get("chained"):
            keep = self._finish_track_chained(tracker_map, prev, frame, vals)
            if p["detect"]:
                self._finish_detect_chained(tracker_map, frame, vals, keep)
            else:
                # drops must still land on the device state
                upts = np.zeros((self.capacity, 2), np.float32)
                umask = np.zeros((self.capacity,), bool)
                ubear = np.zeros((self.capacity, 3))
                ubear[:, 2] = 1.0
                self._slot_upd = (keep, upts, umask, ubear)
        else:
            if p["ctx"] is not None:
                self._finish_track(tracker_map, prev, frame, p["ctx"], vals)
            if p["detect"]:
                self._finish_detect(tracker_map, frame, vals)
        if prev is not None and hasattr(prev, "_pyr"):
            del prev._pyr  # release_image_buffer
        self._finalize_frame(tracker_map, frame, p["image"])
        if self.chained and not (p["ctx"] or {}).get("chained") \
                and frame.track_ids.max() >= 0:
            # this frame went through the standard (host-layout) path:
            # (re)seed the device state from its FINAL compacted layout
            # so the next chained dispatch pairs consistent slots with
            # this frame's pyramid; any staged update is now stale
            self._dev = (
                jnp.asarray(frame._pts.astype(np.float32)),
                jnp.asarray(frame.track_ids >= 0),
                jnp.asarray(frame.bearings),
            )
            self._dev_frame_id = frame.id
            self._slot_upd = None
            self._pending_new = []

    # ------------------------------------------------------------------
    # device-chained frontend (Config.chained_frontend)
    # ------------------------------------------------------------------
    def _track_frame_chained(self, tracker_map: PipelineMap,
                             frame: FrameRec, rider, between) -> None:
        """Chained-mode frame: dispatch KLT from DEVICE state (stable
        keypoint slots), submit the pack, then finish the previous
        frame (its pull completed ~a frame ago) and run the backend
        stage. The serial pull→host-relayout→KLT loop of the standard
        path disappears: the pull only gates bookkeeping that tolerates
        one frame of lag (Poisson drops / detections land as a masked
        slot-update put consumed by the NEXT dispatch)."""
        import threading

        from ..utils.timing import stage_timer

        cfg = self.config
        C = self.capacity
        prev = self._prev
        fetch = {}
        ctx = None
        with stage_timer("tracker_dispatch_time"):
            if (self._dev is not None and prev is not None
                    and hasattr(prev, "_pyr")):
                if self._slot_upd is None:
                    keep = np.ones((C,), bool)
                    upts = np.zeros((C, 2), np.float32)
                    umask = np.zeros((C,), bool)
                    ubear = np.zeros((C, 3))
                    ubear[:, 2] = 1.0
                else:
                    keep, upts, umask, ubear = self._slot_upd
                    self._slot_upd = None
                if self._Kinv_dev is None:
                    self._Kinv_dev = jnp.asarray(np.linalg.inv(frame.K))
                # rotation-predicted flow matrix (frame.cpp:82-93)
                R = np.eye(3)
                if cfg.feature_tracker_predict_keypoints \
                        and len(frame.imu_t) > 0:
                    dq = self._gyro_delta_q(prev, frame)
                    q_cam = nputil.quat_mul(
                        nputil.quat_conj(prev.q_bc),
                        nputil.quat_mul(prev.q_bi, nputil.quat_mul(
                            dq, nputil.quat_mul(
                                nputil.quat_conj(frame.q_bi), frame.q_bc))))
                    R = nputil.quat_to_matrix(nputil.quat_conj(q_cam))
                self._last_R = R
                key = jax.random.PRNGKey(self._rng.integers(2**31))
                nxt, status, b_next, no_trans = _chained_track_step(
                    key, prev._pyr, frame._pyr,
                    self._dev[0], self._dev[1], self._dev[2],
                    jnp.asarray(keep), jnp.asarray(upts),
                    jnp.asarray(umask), jnp.asarray(ubear),
                    jnp.asarray(R), jnp.asarray(frame.K),
                    self._Kinv_dev,
                    rot_thresh_deg=float(cfg.rotation_ransac_threshold),
                    mis_thresh_deg=float(cfg.rotation_misalignment_threshold),
                    win=21, iters=30, eps=0.01, border=20)
                self._dev = (nxt, status, b_next)
                self._dev_frame_id = frame.id
                fetch["nxt"] = nxt
                fetch["status"] = status
                fetch["b_next"] = b_next
                fetch["no_trans"] = no_trans
                ctx = {"chained": True}

            detect = getattr(frame, "_detect_tag", True)
            if detect:
                cand, resp, cvalid = img_ops.gftt_candidates(
                    frame._pyr[0], max_candidates=1024, quality_level=1e-3,
                    border=20)
                fetch["cand"] = cand
                fetch["cvalid"] = cvalid

        riders = []
        for h in (rider or []):
            if h is not None and h.flat is not None and h._event is None \
                    and h._buf is None and not getattr(h, "_riding", False):
                h._riding = True
                k = f"_rider{len(riders)}"
                fetch[k] = h.flat
                riders.append((k, h))
        handle = fetch_packed_start(fetch, async_copy=False,
                                    label="pack") if fetch else None
        box = {}
        ev_b = threading.Event()

        def _pull_pack():
            try:
                if handle is not None:
                    box["vals"] = handle.get()
            except BaseException as e:
                box["err"] = e
            finally:
                ev_b.set()

        self._fetch_worker.submit(_pull_pack)

        # the previous frame's pull was submitted a full frame period
        # ago — finishing it here costs ~nothing and stages the slot
        # update for the NEXT dispatch; the backend stage then runs with
        # its tracker data landed, while THIS frame's pull is in flight
        self.finish_pending()
        between()

        self._pending = {
            "frame": frame, "prev": prev, "ctx": ctx,
            "detect": detect, "box": box, "event": ev_b,
            "map": tracker_map, "image": getattr(frame, "_image", None),
            "riders": riders,
        }
        self._prev = frame

    def _finish_track_chained(self, tracker_map: PipelineMap,
                              prev: FrameRec, frame: FrameRec, vals: dict):
        """Host half of chained tracking: slot-STABLE track extension +
        the track-length-priority Poisson re-filter; stages the keep
        mask for the device slot update."""
        cfg = self.config
        C = self.capacity
        nxt = np.asarray(vals["nxt"], dtype=np.float64)
        status = np.asarray(vals["status"]).copy()
        b_next = np.asarray(vals["b_next"], dtype=np.float64)
        if bool(vals["no_trans"]):
            frame.no_translation = True

        lengths = np.zeros((C,), dtype=np.int64)
        keep_ok = np.zeros((C,), dtype=bool)
        for i in np.nonzero(status)[0]:
            # the device tracked a superset (host drops land one frame
            # late); only slots with a live host track extend
            if prev.track_ids[i] < 0:
                continue
            tr = tracker_map.get_track(prev, int(i))
            if tr is None or tr.trash:
                continue
            lengths[i] = len(tr.obs)
            keep_ok[i] = True
        order = np.argsort(-lengths, kind="stable")
        accept = _poisson_accept(nxt, order, keep_ok,
                                 cfg.feature_tracker_min_keypoint_distance)
        keep = np.zeros((C,), dtype=bool)
        for i in np.nonzero(accept)[0]:
            tr = tracker_map.get_track(prev, int(i), create=True)
            frame.bearings[i] = b_next[i]
            frame._pts[i] = nxt[i]
            tracker_map.add_observation(tr, frame, int(i))
            tr.life += 1
            keep[i] = True
        # place detections staged by the previous finish: their first
        # observation lands HERE at the rotation-compensated position —
        # the same position the device injection tracks from, so the
        # observation chain stays CONTIGUOUS (the {k, k+2} gap broke
        # the subwindow extraction's chain assumption, ~5x f32 ATE)
        for s_, uv2, b2 in getattr(self, "_pending_new", ()):
            if frame.track_ids[s_] >= 0:
                continue  # slot got re-occupied (shouldn't happen)
            frame.bearings[s_] = b2
            frame._pts[s_] = uv2
            tracker_map.get_track(frame, s_, create=True)
            keep[s_] = True
        self._pending_new = []
        return keep

    def _finish_detect_chained(self, tracker_map: PipelineMap,
                               frame: FrameRec, vals: dict,
                               keep: np.ndarray):
        """Detection into FREE slots + the staged device injection."""
        cfg = self.config
        C = self.capacity
        used = np.nonzero(frame.track_ids >= 0)[0]
        upts = np.zeros((C, 2), np.float32)
        umask = np.zeros((C,), bool)
        ubear = np.zeros((C, 3))
        ubear[:, 2] = 1.0
        free = [i for i in range(C) if frame.track_ids[i] < 0]
        if "cand" in vals and free:
            cand = np.asarray(vals["cand"])
            cvalid = np.asarray(vals["cvalid"])
            n_pre = len(used)
            all_pts = np.concatenate([frame._pts[used], cand], axis=0)
            keep_ok = np.concatenate([np.ones(n_pre, bool), cvalid])
            order = np.arange(len(all_pts))
            accept = _poisson_accept(
                all_pts, order, keep_ok,
                cfg.feature_tracker_min_keypoint_distance)
            sel = np.nonzero(accept[n_pre:])[0]
            sel = sel[:cfg.feature_tracker_max_keypoint_detection]
            Kinv = np.linalg.inv(frame.K)
            # the injection lands one frame later: its KLT template is
            # sampled in the NEXT frame's previous pyramid, so map the
            # detection through the rotation prediction of the step in
            # flight (stale-template drift was ~3 px/frame, measured)
            Rl = getattr(self, "_last_R", None)
            H_img, W_img = (self._prev._pyr[0].shape
                            if self._prev is not None
                            and hasattr(self._prev, "_pyr")
                            else (None, None))
            fi = 0
            news = []
            for i in sel:
                if fi >= len(free):
                    break
                s = free[fi]
                fi += 1
                b = Kinv @ np.array([cand[i, 0], cand[i, 1], 1.0])
                b /= np.linalg.norm(b)
                b2, uv2 = b, cand[i]
                if Rl is not None:
                    b2 = Rl @ b
                    if b2[2] > 1e-6:
                        uvh = frame.K @ (b2 / b2[2])
                        uv2 = uvh[:2]
                    b2 = b2 / np.linalg.norm(b2)
                    if H_img is not None and not (
                            0 <= uv2[0] < W_img and 0 <= uv2[1] < H_img):
                        b2, uv2 = b, cand[i]  # rotated out: keep raw
                # the track's FIRST observation is recorded on the NEXT
                # frame at the rotation-compensated position — the same
                # position the device injection tracks from
                news.append((int(s), np.asarray(uv2, float),
                             np.asarray(b2, float)))
                upts[s] = uv2
                umask[s] = True
                ubear[s] = b2
            self._pending_new = news
        self._slot_upd = (keep, upts, umask, ubear)

    def _finalize_frame(self, tracker_map: PipelineMap, frame: FrameRec,
                        image: np.ndarray) -> None:
        """Post-tracking host work that needs the frame's final
        keypoints: depth sampling, painter tap, image release."""
        # sample the aligned depth image (if any) at the final keypoint
        # positions -> metric z-depth per keypoint (0 = no measurement)
        dimg = getattr(frame, "_depth_img", None)
        if dimg is not None:
            kd = np.zeros((self.capacity,), dtype=np.float64)
            Hd, Wd = dimg.shape
            for k in np.nonzero(frame.track_ids >= 0)[0]:
                u = int(round(frame._pts[k, 0]))
                v = int(round(frame._pts[k, 1]))
                if 0 <= u < Wd and 0 <= v < Hd:
                    kd[k] = float(dimg[v, u])
            frame.kp_depth = kd
            frame._depth_img = None

        # painter tap (reference InspectPainter, inspection.h:41-57)
        if inspection.inspect_get(inspection.PAINTER_ENABLE):
            active = np.nonzero(frame.track_ids >= 0)[0]
            lengths = np.array([
                len(t.obs) if (t := tracker_map.get_track(frame, int(k)))
                else 0 for k in active])
            inspection.inspect(inspection.PAINTER_FRAME, {
                "image": image, "pts": frame._pts[active].copy(),
                "lengths": lengths, "frame_id": frame.id, "t": frame.t,
            })

        frame._image = None
        self.last_finished = frame

    @property
    def _fetch_worker(self):
        from ..utils.fetch import FetchWorker

        if self._fetch_worker_inst is None:
            self._fetch_worker_inst = FetchWorker()
        return self._fetch_worker_inst

    # ------------------------------------------------------------------
    def _gyro_delta_q(self, prev: FrameRec, frame: FrameRec) -> np.ndarray:
        """Gyro-only Δq over the inter-frame IMU samples at the previous
        frame's bias — the preintegration delta the reference's
        keypoint prediction uses (frame.cpp:82-86)."""
        dq = np.array([1.0, 0.0, 0.0, 0.0])
        t_cur = prev.t
        for i in range(len(frame.imu_t)):
            dt = float(frame.imu_t[i] - t_cur)
            if dt <= 0:
                continue
            dq = nputil.quat_mul(dq, nputil.expmap((frame.imu_w[i] - prev.bg) * dt))
            t_cur = float(frame.imu_t[i])
        if frame.t > t_cur:
            # hold last gyro sample to the frame timestamp
            if len(frame.imu_t):
                dq = nputil.quat_mul(dq, nputil.expmap(
                    (frame.imu_w[-1] - prev.bg) * (frame.t - t_cur)))
        return nputil.quat_normalize(dq)

    def _dispatch_track(self, prev: FrameRec, frame: FrameRec, fetch: dict):
        """Host prep + async dispatch of KLT and the fused RANSAC gates.
        Device handles land in `fetch`; returns host context for
        _finish_track."""
        cfg = self.config
        C = self.capacity
        H, W = frame._pyr[0].shape
        slots = np.nonzero(prev.track_ids >= 0)[0]
        n = len(slots)
        valid = np.zeros((C,), dtype=bool)
        valid[:n] = True
        pts_prev = np.zeros((C, 2), dtype=np.float32)
        pts_prev[:n] = prev._pts[slots]
        bearings_prev = prev.bearings[slots]  # (n,3)

        # rotation-predicted initial flow (frame.cpp:82-93):
        # delta_key_q = (q_bc^† · q_bi · Δq_gyro · q_bi^† · q_bc)^†
        pts_init = pts_prev.copy()
        if cfg.feature_tracker_predict_keypoints and len(frame.imu_t) > 0:
            dq = self._gyro_delta_q(prev, frame)
            q_cam = nputil.quat_mul(
                nputil.quat_conj(prev.q_bc),
                nputil.quat_mul(prev.q_bi, nputil.quat_mul(
                    dq, nputil.quat_mul(nputil.quat_conj(frame.q_bi), frame.q_bc))))
            R = nputil.quat_to_matrix(nputil.quat_conj(q_cam))
            pred_b = bearings_prev @ R.T
            z = np.clip(pred_b[:, 2:3], 1e-6, None)
            uv = (frame.K @ (pred_b / z).T).T[:, :2]
            inb = ((uv[:, 0] >= 0) & (uv[:, 0] < W)
                   & (uv[:, 1] >= 0) & (uv[:, 1] < H) & (pred_b[:, 2] > 0))
            pts_init[:n] = np.where(inb[:, None], uv, pts_prev[:n]).astype(np.float32)

        nxt, status = klt.track_keypoints(
            prev._pyr, frame._pyr,
            jnp.asarray(pts_prev), jnp.asarray(pts_init), jnp.asarray(valid),
            win=21, iters=30, eps=0.01, border=20)
        status_klt = status

        # essential + rotation gates, fused on device (frame.cpp:108-134)
        bp = np.zeros((C, 3))
        bp[:, 2] = 1.0
        bp[:n] = bearings_prev
        if self._Kinv_dev is None:
            self._Kinv_dev = jnp.asarray(np.linalg.inv(frame.K))
        key = jax.random.PRNGKey(self._rng.integers(2**31))
        b_next, status, no_trans = _post_klt_gates(
            key, nxt, status, jnp.asarray(bp), self._Kinv_dev,
            rot_thresh_deg=float(cfg.rotation_ransac_threshold),
            mis_thresh_deg=float(cfg.rotation_misalignment_threshold))

        fetch["nxt"] = nxt
        fetch["status"] = status
        fetch["b_next"] = b_next
        fetch["no_trans"] = no_trans
        import os

        if os.environ.get("XR_DEBUG_TRACK"):
            fetch["status_klt"] = status_klt  # pre-gate KLT survivors
        return {"slots": slots, "n": n}

    def _finish_track(self, tracker_map: PipelineMap, prev: FrameRec,
                      frame: FrameRec, ctx: dict, vals: dict):
        """Host half of tracking: Poisson re-filter + track extension,
        using the batched readback in `vals`."""
        cfg = self.config
        C = self.capacity
        slots, n = ctx["slots"], ctx["n"]
        nxt = np.asarray(vals["nxt"], dtype=np.float64)
        status = np.asarray(vals["status"]).copy()
        if "status_klt" in vals:
            self._dbg_gate = (int(np.asarray(vals["status_klt"]).sum()),
                              int(status.sum()))
        status[n:] = False
        b_next = np.asarray(vals["b_next"], dtype=np.float64)
        if bool(vals["no_trans"]):
            frame.no_translation = True

        # track-length-priority Poisson re-filter (frame.cpp:137-163)
        lengths = np.zeros((C,), dtype=np.int64)
        keep_ok = np.zeros((C,), dtype=bool)
        for i in range(n):
            if not status[i]:
                continue
            tr = tracker_map.get_track(prev, int(slots[i]))
            if tr is None:
                continue
            if tr.trash:
                continue
            lengths[i] = len(tr.obs)
            keep_ok[i] = True
        order = np.argsort(-lengths, kind="stable")
        accept = _poisson_accept(nxt, order, keep_ok & status,
                                 cfg.feature_tracker_min_keypoint_distance)

        # extend tracks into the new frame's slots
        out_slot = 0
        for i in np.nonzero(accept)[0]:
            tr = tracker_map.get_track(prev, int(slots[i]), create=True)
            frame.bearings[out_slot] = b_next[i]
            frame._pts[out_slot] = nxt[i]
            tracker_map.add_observation(tr, frame, out_slot)
            tr.life += 1
            out_slot += 1

    # ------------------------------------------------------------------
    def _finish_detect(self, tracker_map: PipelineMap, frame: FrameRec,
                       vals: dict):
        cfg = self.config
        C = self.capacity
        used = np.nonzero(frame.track_ids >= 0)[0]
        free = C - len(used)
        if free <= 0:
            return
        # GFTT candidates came off the device in the frame's single
        # batched fetch; spacing suppression on host (the native grid
        # filter — a long sequential scan is the one part of detection
        # that does not belong on the accelerator)
        cand = np.asarray(vals["cand"])
        cvalid = np.asarray(vals["cvalid"])

        n_pre = len(used)
        all_pts = np.concatenate([frame._pts[used], cand], axis=0)
        keep_ok = np.concatenate([np.ones(n_pre, bool), cvalid])
        # presets first (existing keypoints always win), then candidates
        # in response order (gftt candidates are sorted descending)
        order = np.arange(len(all_pts))
        accept = _poisson_accept(
            all_pts, order, keep_ok,
            cfg.feature_tracker_min_keypoint_distance)
        sel = np.nonzero(accept[n_pre:])[0]
        sel = sel[:cfg.feature_tracker_max_keypoint_detection]
        pts = cand[sel]
        ok = np.ones(len(sel), dtype=bool)

        Kinv = np.linalg.inv(frame.K)
        slot = len(used)
        for i in np.nonzero(ok)[0]:
            if slot >= C:
                break
            b = Kinv @ np.array([pts[i, 0], pts[i, 1], 1.0])
            b /= np.linalg.norm(b)
            frame.bearings[slot] = b
            frame._pts[slot] = pts[i]
            tracker_map.get_track(frame, slot, create=True)
            slot += 1
