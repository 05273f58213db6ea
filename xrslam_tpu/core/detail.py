"""Sample synchronization + pipeline driver.

Mirrors XRSLAM::Detail and FrontendWorker (reference:
xrslam/src/xrslam/core/detail.cpp, frontend_worker.cpp):

  - gyroscope and accelerometer streams are paired by linear
    interpolation of the gyro to accel timestamps (detail.cpp:46-101),
  - camera frames buffer until the IMU stream catches up
    (detail.cpp:130-142),
  - every IMU sample yields a low-latency output pose by forward
    propagation from the last optimized state (detail.cpp:144-177,
    propagate_state :15-28),
  - frames are handed to the feature tracker, then issued to the
    frontend: Initializer until success, then SlidingWindowTracker;
    tracking failure resets to initialization (frontend_worker.cpp:28-86).

The threading of the reference (two Worker job loops) collapses to the
synchronous call chain — the semantics the reference itself has with
XRSLAM_ENABLE_THREADING=OFF (its PC default, SURVEY.md §1).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import jax
import numpy as np

from ..config import Config
from ..utils.timing import stage_timer
from . import nputil
from .initializer import Initializer
from .map import FrameRec, PipelineMap, new_frame_id
from .sliding_window import SlidingWindowTracker

GRAVITY = np.array([0.0, 0.0, -9.80665])


@dataclass
class OutputPose:
    t: float
    q: np.ndarray  # body-to-world [w,x,y,z]
    p: np.ndarray


class FeatureTrackerBase:
    """Produces per-frame keypoint bearings + track ids into the
    tracker map. The real KLT tracker and the synthetic stub share this
    interface."""

    def track_frame(self, tracker_map: PipelineMap, frame: FrameRec,
                    rider=None, between=None) -> None:
        """`rider` (optional): an in-flight fetch handle whose packed
        buffer the tracker should pull in its own single device fetch
        (utils.fetch._FetchHandle.complete_with) — combines the
        backend's deferred write-back with the tracker round trip.

        `between` (optional): a zero-arg callback the tracker must call
        AFTER dispatching its device programs and BEFORE its blocking
        fetch — the pipeline's overlapped backend stage (worker_overlap)
        runs there so its host work hides behind the tracker's device
        compute + fetch. May return a fetch handle to ride
        the same fetch (used when `rider` is None). A pipelined tracker
        may instead RETURN with its fetch still in flight; the frame is
        then completed by finish_pending() at the next call."""
        raise NotImplementedError

    def finish_pending(self) -> None:
        """Complete any in-flight pipelined frame (no-op for
        synchronous trackers)."""

    # most recently COMPLETED frame (pipelined trackers lag the frame
    # handed to track_frame by one); None before the first completion
    last_finished = None


class VIOPipeline:
    """The XRSLAM public-API engine: push IMU + camera samples, get
    poses (reference include/xrslam/xrslam.h:166-190)."""

    def __init__(self, config: Config, tracker: FeatureTrackerBase):
        self.config = config
        self.tracker = tracker
        self.tracker_map = PipelineMap()
        self.initializer: Optional[Initializer] = Initializer(config)
        self.swt: Optional[SlidingWindowTracker] = None
        # visual (re)localization client (reference owns it in
        # FrontendWorker, frontend_worker.cpp:21-26; queried from the
        # tracking loop, feature_tracker.cpp:116-121). Default backend:
        # the HTTP XRLocalization client when an endpoint is configured;
        # tests/apps may install a MapLocalizer via set_localizer().
        self.localizer = None
        if config.visual_localization_enable and \
                config.visual_localization_config_port:
            from ..localizer import HttpLocalizer

            self.localizer = HttpLocalizer(config)

        self.gyro_buf: List[tuple] = []   # (t, w)
        self.accel_buf: List[tuple] = []  # (t, a)
        self.imu_pending: List[tuple] = []  # fused (t, w, a)
        self.frame_pending: List[FrameRec] = []
        self.last_imu_t = -np.inf

        # forward-propagation state (detail.cpp propagate_state)
        self._prop: Optional[dict] = None
        self._imu_since_opt: List[tuple] = []
        # camera-rate PnP path: tracker-track-id -> landmark world point
        # (the reference's "keymap" mirror of the backend map,
        # feature_tracker.cpp:167-248 synchronize_keymap/mirror_map)
        self._keymap: dict = {}
        # boundary-sample bookkeeping (see _flush_frames)
        self._last_frame_t: Optional[float] = None
        self._last_taken: Optional[tuple] = None
        # per-pipeline frame counter for backend decimation (the
        # reference counts frames, feature_tracker.cpp:47-49; frame ids
        # are globally monotonic and would alias across instances)
        self._frame_count: int = 0
        # worker_overlap: issued-but-not-yet-processed frames whose
        # backend stage runs during a LATER frame's tracker round trip.
        # Depth 1 (overlap): frame t's backend runs inside frame t+1's
        # call. Depth 2 (pipelined_writeback): frame t's backend runs at
        # the TOP of frame t+2's call — BEFORE the host blocks on frame
        # t+1's in-flight pack — so the backend's host work (extraction,
        # uploads, solve dispatch) overlaps the in-flight pull
        # instead of extending the frame (uploads and execute dispatches
        # do not contend with an in-flight pull; only blocking pulls
        # serialize).
        self._issue_queue: List[FrameRec] = []

    def set_localizer(self, localizer) -> None:
        """Install a visual-localization backend (MapLocalizer /
        HttpLocalizer); requires config.visual_localization_enable for
        the tracking loop to actually query it."""
        self.localizer = localizer

    # ------------------------------------------------------------------
    # IMU ingestion (reference detail.cpp:46-101)
    # ------------------------------------------------------------------
    def track_gyroscope(self, t: float, w) -> Optional[OutputPose]:
        self.gyro_buf.append((t, np.asarray(w, dtype=float)))
        self._fuse()
        return self.predict_pose(t)

    def track_accelerometer(self, t: float, a) -> Optional[OutputPose]:
        self.accel_buf.append((t, np.asarray(a, dtype=float)))
        self._fuse()
        return self.predict_pose(t)

    def _fuse(self):
        """Interpolate gyro to each accel timestamp once both sides
        bracket it (reference interleaving of track_{gyroscope,
        accelerometer})."""
        while self.accel_buf and len(self.gyro_buf) >= 2:
            ta, a = self.accel_buf[0]
            # drop gyros older than needed
            while len(self.gyro_buf) > 2 and self.gyro_buf[1][0] <= ta:
                self.gyro_buf.pop(0)
            if len(self.gyro_buf) < 2:
                break
            t0, w0 = self.gyro_buf[0]
            t1, w1 = self.gyro_buf[1]
            if ta < t0:
                self.accel_buf.pop(0)  # accel predates gyro stream
                continue
            if ta > t1:
                break  # need more gyro
            lam = 0.0 if t1 == t0 else (ta - t0) / (t1 - t0)
            w = (1 - lam) * w0 + lam * w1
            self.accel_buf.pop(0)
            self._track_imu(ta, w, a)

    def _track_imu(self, t, w, a):
        if t <= self.last_imu_t:
            return
        self.last_imu_t = t
        self.imu_pending.append((t, w, a))
        self._imu_since_opt.append((t, w, a))
        self._flush_frames()

    # ------------------------------------------------------------------
    # camera ingestion
    # ------------------------------------------------------------------
    def track_camera(self, t: float, bearings: np.ndarray,
                     track_hint: Optional[np.ndarray] = None) -> None:
        """Push a camera frame. `bearings` is the fixed-capacity (C,3)
        unit-bearing array; `track_hint` optionally carries the stub
        tracker's correspondence ids (C,), -1 = empty."""
        f = self._make_frame(t, bearings)
        f._hint = track_hint
        self.frame_pending.append(f)
        self._flush_frames()

    def track_camera_image(self, t: float, image: np.ndarray,
                           capacity: int = 256,
                           depth: Optional[np.ndarray] = None) -> None:
        """Push a raw grayscale image ((H,W) float32 in [0,1]); the
        image-based feature tracker (frontend/tracker.py) fills the
        keypoint slots when the frame is processed — the
        XRSLAMPushSensorData(CAMERA) entry of the reference
        (xrslam-interface XRSLAMInternal.cpp:20, detail.cpp:103-128).

        `depth` optionally carries an aligned metric depth image
        ((H,W) float32 meters, 0 = invalid); the tracker samples it at
        each keypoint into FrameRec.kp_depth for depth-seeded landmark
        initialization."""
        cap = getattr(self.tracker, "capacity", capacity)
        f = self._make_frame(t, np.zeros((cap, 3), dtype=float))
        f._image = np.asarray(image, dtype=np.float32)
        f._depth_img = depth
        self.frame_pending.append(f)
        self._flush_frames()

    def _make_frame(self, t: float, bearings: np.ndarray) -> FrameRec:
        cfg = self.config
        f = FrameRec(
            id=new_frame_id(), t=t,
            q=np.array([1.0, 0, 0, 0]), p=np.zeros(3), v=np.zeros(3),
            bg=cfg.gyroscope_bias.copy(), ba=cfg.accelerometer_bias.copy(),
            q_bc=np.asarray(cfg.camera_to_body_rotation, dtype=float),
            p_bc=np.asarray(cfg.camera_to_body_translation, dtype=float),
            q_bi=np.asarray(cfg.imu_to_body_rotation, dtype=float),
            p_bi=np.asarray(cfg.imu_to_body_translation, dtype=float),
            K=np.asarray(cfg.camera_intrinsic, dtype=float),
            # K-scaled pixel-noise whitening (reference detail.cpp:107-109)
            sqrt_inv_cov2=np.diag([
                cfg.camera_intrinsic[0, 0] / np.sqrt(cfg.keypoint_noise_cov[0, 0]),
                cfg.camera_intrinsic[1, 1] / np.sqrt(cfg.keypoint_noise_cov[1, 1]),
            ]),
            bearings=bearings.astype(float),
            track_ids=np.full((bearings.shape[0],), -1, dtype=np.int64),
        )
        return f

    def _flush_frames(self):
        while self.frame_pending and self.last_imu_t >= self.frame_pending[0].t:
            f = self.frame_pending.pop(0)
            take = [s for s in self.imu_pending if s[0] <= f.t]
            self.imu_pending = [s for s in self.imu_pending if s[0] > f.t]
            # boundary sample: the preintegrator's first dt starts at its
            # first sample, so the span (prev_frame.t, first_sample) would
            # be dropped; the reference closes it by prepending the
            # previous frame's last sample re-stamped at that frame's
            # time (feature_tracker.cpp:79-88)
            if (take and self._last_frame_t is not None
                    and self._last_taken is not None
                    and take[0][0] - self._last_frame_t > 1e-5):
                take.insert(0, (self._last_frame_t,
                                self._last_taken[1], self._last_taken[2]))
            if take:
                f.imu_t = np.array([s[0] for s in take])
                f.imu_w = np.stack([s[1] for s in take])
                f.imu_a = np.stack([s[2] for s in take])
                self._last_taken = take[-1]
            self._last_frame_t = f.t
            self._process_frame(f)

    # ------------------------------------------------------------------
    def _process_frame(self, frame: FrameRec):
        # backend decimation (reference feature_tracker.cpp:47-49
        # slidind_window_frame_tag): every frame is tracked, but only
        # every Nth frame detects new keypoints and reaches the window
        # backend; always on while initializing
        issue_tag = (self.swt is None or
                     self._frame_count % self.config.sliding_window_tracker_frequent == 0)
        self._frame_count += 1
        frame._detect_tag = issue_tag
        image = getattr(frame, "_image", None)  # tracker clears the slot
        self.tracker_map.attach_frame(frame)
        # ride the backend's deferred write-back buffer along the
        # tracker's single fetch: one combined transfer instead of two
        # blocking syncs
        rider = None
        between = None
        import os as _os

        rider_ok = _os.environ.get("XR_FETCH_RIDER", "1") != "0"
        # parsac consumes materialized writes within the SAME backend
        # stage (judge_track_status priors), so its writes must ride the
        # pack that lands BEFORE that stage — the depth-1 ordering below
        if (self.config.worker_overlap and self.config.pipelined_writeback
                and not self.config.parsac_flag):
            # depth-2 pipeline: the tracker submits its pack pull FIRST
            # (carrying only EARLIER frames' solve buffers — the pull
            # never waits on new solve programs), THEN runs the backend
            # for the previous frame via `between` — its host work,
            # uploads and solve dispatches all happen while the pull is
            # in flight (puts/executes do not contend with a pull; the
            # solves' device execution queues behind the pull request,
            # which is fine — nothing waits on them until the write-back
            # rides the NEXT frame's pack).
            if rider_ok and self.swt is not None:
                rider = self.swt.collect_riders()

            def between():
                # the queue head's tracker pack always landed in this
                # frame's finish_pending (top of track_frame), so the
                # backend reads fully-extended tracks
                if self._issue_queue:
                    with stage_timer("backend_overlap_time"):
                        self._issue_frame(self._issue_queue.pop(0))
        elif self.config.worker_overlap:
            # overlapped backend (depth 1): the previous frame's backend
            # stage (initializer / sliding-window track) runs between
            # the tracker's device dispatch and its blocking fetch,
            # hiding ~all backend host work behind device compute +
            # the fetch. Returns the backend's freshly deferred
            # write-back handle so the tracker can enqueue its pull on
            # the fetch worker — it completes during inter-frame host
            # work and the NEXT backend stage's materialize_pending
            # finds it ready.
            def between():
                with stage_timer("backend_overlap_time"):
                    self._run_deferred_issue()
                if rider_ok and self.swt is not None:
                    return self.swt.collect_riders()
                return None
        elif self.swt is not None and rider_ok:
            rider = self.swt.collect_riders()
        with stage_timer("feature_tracker_time"):
            self.tracker.track_frame(self.tracker_map, frame, rider=rider,
                                     between=between)

        if self.swt is not None and self.config.visual_pnp_enable:
            # a pipelined tracker returns with `frame` still in flight;
            # PnP then runs on the latest COMPLETED frame (one-frame
            # lag, same as the reference's threaded tracker publishing
            # latest_state behind the camera)
            f_pnp = frame
            if getattr(self.tracker, "_pending", None) is not None:
                f_pnp = self.tracker.last_finished
            if f_pnp is not None:
                self._solve_pnp_highrate(f_pnp)

        # throttled visual-localization query while tracking (reference
        # feature_tracker.cpp:116-121: query with the frame image + the
        # SLAM-frame pose at the frame time)
        if (self.localizer is not None and self.swt is not None
                and self.config.visual_localization_enable):
            prop = self._propagate_full(frame.t)
            if prop is not None:
                _, q_b, p_b, _ = prop
                self.localizer.query_localization(
                    frame.t, image if image is not None else frame, q_b, p_b)

        # trim tracker map (reference feature_tracker.cpp map upkeep)
        cap = (self.config.feature_tracker_max_frames if self.swt
               else self.config.feature_tracker_max_init_frames)
        while len(self.tracker_map.frames) > cap:
            self.tracker_map.detach_frame(0)

        if issue_tag:
            if self.config.worker_overlap:
                # defer to a later frame's tracker round trip (depth 1:
                # the between-callback; depth 2: the top-of-frame
                # backend stage two frames later)
                self._issue_queue.append(frame)
            else:
                self._issue_frame(frame)

    def _run_deferred_issue(self):
        while self._issue_queue:
            self._issue_frame(self._issue_queue.pop(0))

    def flush(self) -> None:
        """Complete deferred work at end of stream (worker_overlap):
        finish the tracker's in-flight frame, issue the remaining
        tracked frames, and land any pending device write-back. No-op
        otherwise."""
        self.tracker.finish_pending()
        self._run_deferred_issue()
        if self.swt is not None:
            self.swt.materialize_pending()

    def _issue_frame(self, frame: FrameRec):
        """reference frontend_worker.cpp:28-86."""
        if self.swt is None:
            self.initializer.mirror_keyframe_map(self.tracker_map, frame.id)
            if self.initializer.map is not None:
                swt = self.initializer.initialize()
                if swt is not None:
                    self.swt = swt
                    self._refresh_prop_state()
        else:
            if self.swt.mirror_frame(self.tracker_map, frame.id):
                ok = self.swt.track()
                if ok:
                    self._refresh_prop_state()
                else:
                    self.swt = None
                    self.initializer = Initializer(self.config)

    def _refresh_prop_state(self):
        t, q, p, v, bg, ba = self.swt.get_latest_state()
        self._prop = dict(t=t, q=q.copy(), p=p.copy(), v=v.copy(),
                          bg=bg.copy(), ba=ba.copy())
        self._prop_cache = None  # new anchor: restart the cursor
        self._imu_since_opt = [s for s in self._imu_since_opt if s[0] > t]
        if self.config.visual_pnp_enable:
            self._refresh_keymap()

    # ------------------------------------------------------------------
    # camera-rate visual PnP pose path (reference feature_tracker.cpp
    # :95-112 XRSLAM_IOS branch; SURVEY.md §3.4)
    # ------------------------------------------------------------------
    def _refresh_keymap(self):
        """Mirror the backend's triangulated landmarks into a
        tracker-track-id -> world-point table (the reference's keymap
        re-sync after each backend iteration, synchronize_keymap
        feature_tracker.cpp:167-248 / frontend_worker.cpp:38-43)."""
        keymap = {}
        swt_map = self.swt.map
        tframes = {f.id: f for f in self.tracker_map.frames}
        for sf in swt_map.all_frames():
            tf = tframes.get(sf.id)
            if tf is None:
                continue
            for k in np.nonzero(sf.track_ids >= 0)[0]:
                wtr = swt_map.tracks.get(int(sf.track_ids[k]))
                if (wtr is None or not (wtr.valid and wtr.triangulated)
                        or wtr.p_w is None or wtr.outlier):
                    continue
                ttid = int(tf.track_ids[k])
                if ttid >= 0:
                    keymap[ttid] = wtr.p_w
        self._keymap = keymap

    def _solve_pnp_highrate(self, frame: FrameRec):
        """Pose-only PnP of the newest tracked frame against the keymap
        landmarks, published as the latest output state (reference
        attach_latest_frame + solve_pnp, feature_tracker.cpp:250-298;
        we actually run the solve the reference omits — see
        ransac.pnp.refine_pose_pnp)."""
        from ..ransac import pnp as pnp_mod

        cfg = self.config
        prop = self._propagate_full(frame.t)
        if prop is None:
            return
        t_prop, q_b, p_b, v_b = prop
        C = frame.track_ids.shape[0]
        X = np.zeros((C, 3))
        valid = np.zeros((C,), dtype=bool)
        for k in np.nonzero(frame.track_ids >= 0)[0]:
            p_w = self._keymap.get(int(frame.track_ids[k]))
            if p_w is not None:
                X[k] = p_w
                valid[k] = True
        if valid.sum() < cfg.visual_pnp_min_landmarks:
            return
        q_wc = nputil.quat_mul(q_b, frame.q_bc)
        p_wc = p_b + nputil.quat_rotate(q_b, frame.p_bc)
        q_wc2, p_wc2 = pnp_mod.refine_pose_pnp(
            q_wc, p_wc, X, frame.bearings, valid, frame.sqrt_inv_cov2,
            iters=cfg.solver_iteration_limit)
        from ..utils.fetch import fetch_packed

        q_wc2, p_wc2 = fetch_packed((q_wc2, p_wc2))  # one locked transfer
        q_b2 = nputil.quat_normalize(
            nputil.quat_mul(q_wc2, nputil.quat_conj(frame.q_bc)))
        p_b2 = p_wc2 - nputil.quat_rotate(q_b2, frame.p_bc)
        frame.q, frame.p, frame.v = q_b2, p_b2, v_b.copy()
        s = self._prop
        self._prop = dict(t=frame.t, q=q_b2, p=p_b2, v=v_b,
                          bg=s["bg"].copy(), ba=s["ba"].copy())
        self._prop_cache = None  # new anchor: restart the cursor
        self._imu_since_opt = [x for x in self._imu_since_opt if x[0] > frame.t]

    # ------------------------------------------------------------------
    def predict_pose(self, t: float) -> Optional[OutputPose]:
        """IMU-forward pose at time t from the last optimized state
        (reference detail.cpp:144-177) — the low-latency output path."""
        prop = self._propagate_full(t)
        if prop is None:
            return None
        t_cur, q, p, _ = prop
        # SLAM frame -> global (SfM map) frame once the localizer has
        # registered the transform (reference detail.cpp:170-175)
        if self.localizer is not None and self.localizer.is_initialized():
            q, p = self.localizer.transform(q, p)
        return OutputPose(t=t_cur, q=q, p=p)

    def _propagate_full(self, t: float):
        """Forward-propagate (q, p, v) to time t from the last optimized
        state (reference propagate_state, detail.cpp:15-28). Returns
        (t_reached, q, p, v) or None before initialization.

        Memoized: every IMU sample triggers an output pose, and
        re-integrating the whole since-opt buffer each time is
        O(samples²) per frame of host quaternion math — the cursor
        resumes from the last reached sample instead (reset whenever
        the optimized anchor state refreshes)."""
        if self._prop is None:
            return None
        s = self._prop
        c = getattr(self, "_prop_cache", None)
        if c is not None and c[0] <= t:
            t_cur, q, p, v = c
        else:
            q, p, v = s["q"], s["p"], s["v"]
            t_cur = s["t"]
        bg, ba = s["bg"], s["ba"]
        for (ti, w, a) in self._imu_since_opt:
            if ti <= t_cur or ti > t:
                continue
            dt = ti - t_cur
            # body-frame Euler step (reference propagate_state :15-28);
            # every update REBINDS (numpy ops allocate), so the cached
            # arrays are never mutated and need no defensive copies —
            # this runs per IMU sample and the copies dominated it
            v = v + dt * (nputil.quat_rotate(q, a - ba) + GRAVITY)
            p = p + dt * v
            q = nputil.quat_normalize(
                nputil.quat_mul(q, nputil.expmap((w - bg) * dt)))
            t_cur = ti
        self._prop_cache = (t_cur, q, p, v)
        # callers must treat the returned arrays as read-only
        return t_cur, q, p, v

    # ------------------------------------------------------------------
    @property
    def state(self) -> str:
        return "tracking" if self.swt is not None else "initializing"


class SyntheticTracker(FeatureTrackerBase):
    """Stub feature tracker fed by ground-truth correspondences
    (SURVEY.md §7 minimum end-to-end slice): the frame's `_hint` array
    holds a persistent synthetic track id per keypoint slot; keypoints
    sharing an id across frames join the same map track.

    With a `config`, it also runs the same FT_NO_TRANSLATION detector as
    the image tracker (rotation RANSAC + misalignment percentile,
    reference frame.cpp:115-134) over the matched bearings, so
    bearing-level e2e tests exercise the pure-rotation subframe
    machine."""

    def __init__(self, config: Optional[Config] = None):
        self._id_map = {}
        self._prev: Optional[FrameRec] = None
        self.config = config
        import jax as _jax

        self._key = _jax.random.PRNGKey(0 if config is None else config.random)

    def track_frame(self, tracker_map: PipelineMap, frame: FrameRec,
                    rider=None, between=None) -> None:
        if between is not None:
            between()  # no device round trip to overlap with; run now
        hint = getattr(frame, "_hint", None)
        if hint is None:
            return
        for k in np.nonzero(hint >= 0)[0]:
            h = int(hint[k])
            tid = self._id_map.get(h)
            tr = tracker_map.tracks.get(tid) if tid is not None else None
            if tr is None:
                tr = tracker_map.get_track(frame, int(k), create=True)
                self._id_map[h] = tr.id
            else:
                tracker_map.add_observation(tr, frame, int(k))
            tr.life += 1

        prev = self._prev
        if self.config is not None and prev is not None:
            from ..frontend.tracker import detect_no_translation
            import jax as _jax

            C = frame.bearings.shape[0]
            bp = np.zeros((C, 3))
            bp[:, 2] = 1.0
            bn = bp.copy()
            valid = np.zeros((C,), dtype=bool)
            i = 0
            for k in np.nonzero(frame.track_ids >= 0)[0]:
                tr = tracker_map.tracks.get(int(frame.track_ids[k]))
                kp = tr.obs.get(prev.id) if tr is not None else None
                if kp is None:
                    continue
                bp[i] = prev.bearings[kp]
                bn[i] = frame.bearings[k]
                valid[i] = True
                i += 1
            if valid.sum() >= 8:
                self._key, sk = _jax.random.split(self._key)
                if detect_no_translation(sk, bp, bn, valid, self.config):
                    frame.no_translation = True
        self._prev = frame
