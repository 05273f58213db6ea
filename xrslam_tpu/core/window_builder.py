"""Bridge between the host-side PipelineMap and the fixed-shape solver
arrays (WindowState/WindowData).

Extraction selects an ordered frame list and a track filter, producing
padded (K_slots, L_slots) arrays; write-back pushes optimized states
and landmark world points into the map. Shapes are static per
configuration so every solve reuses one compiled executable.

The reference equivalent is Solver::add_frame_states /
add_track_states / add_factor dynamic problem construction
(reference: xrslam/src/xrslam/estimation/solver.cpp:84-170).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

import jax.numpy as jnp
import numpy as np

from ..estimation.window import MargPrior, WindowData, WindowState
from ..imu import preintegration as pre
from . import nputil
from .map import FrameRec, PipelineMap, TrackRec


@dataclass
class WindowMeta:
    """Bookkeeping to write solver results back into the map.

    Carries host (numpy) twins of the WindowData index/mask arrays the
    orchestration code branches on: reading them back off the device
    would cost a blocking transfer each, and they were built on the
    host in the first place."""

    frames: List[FrameRec]
    track_ids: List[int]          # landmark slot -> track id
    anchor_bearing: np.ndarray    # (L,3) anchor bearings (for p_w writeback)
    ref_idx: np.ndarray           # (L,) int32 anchor slots
    landmark_mask: np.ndarray     # (L,) bool
    obs_mask: np.ndarray          # (K,L) bool
    preint_mask: np.ndarray       # (K,) bool
    imu_dev: tuple = None         # device (t,w,a,t_end,count) buffers — lets
                                  # a follow-up stage re-integrate at new
                                  # bias linearization without re-upload


# Allowed IMU-buffer capacities. Shapes must be static per jit cache
# entry, so the capacity is quantized to a small ladder: callers size
# the buffer to the next bucket >= the actual sample count, giving at
# most len(IMU_CAP_BUCKETS) compiles of the integrate path over a run
# while making silent truncation impossible (the round-3 rotation-merge
# path overflowed a hard cap of 128 and dropped IMU tail samples).
IMU_CAP_BUCKETS = (64, 96, 128, 192, 256, 384, 512, 768, 1024, 1536, 2048)


def bucket_imu_cap(n: int) -> int:
    """Smallest allowed capacity >= n (reference keeps unbounded
    std::vector buffers, preintegrator.h:44-48; our fixed-shape
    equivalent must never drop samples)."""
    for b in IMU_CAP_BUCKETS:
        if n <= b:
            return b
    raise RuntimeError(
        f"IMU interval holds {n} samples — beyond the largest supported "
        f"buffer ({IMU_CAP_BUCKETS[-1]}); check the frame/IMU rates")


def needed_imu_cap(frame_lists, floor: int = 0) -> int:
    """Bucketed capacity covering every interval's sample count."""
    needed = floor
    for fl in frame_lists:
        needed = max(needed, sum(len(f.imu_t) for f in fl))
    return bucket_imu_cap(needed)


def interval_samples(frames_between: List[FrameRec], cap: int):
    """Concatenate raw IMU samples of the given frames into a
    fixed-capacity buffer (t (cap,), w (cap,3), a (cap,3), count, t0).

    Timestamps are REBASED to the interval's first sample (t0, float64,
    subtracted on the host): absolute EuRoC-era times (~1.4e9 s) have
    ~128 s resolution in float32, so un-rebased buffers integrate to
    dt=0 in an f32 run — the bug that silently collapsed the f32 VI-init
    scale to the 0.001 gate edge. Callers must pass end times relative
    to t0 as well."""
    if frames_between:
        ts = np.concatenate([f.imu_t for f in frames_between])
        ws = np.concatenate([f.imu_w for f in frames_between])
        accs = np.concatenate([f.imu_a for f in frames_between])
    else:
        ts = np.zeros((0,))
        ws = np.zeros((0, 3))
        accs = np.zeros((0, 3))
    if len(ts) > cap:
        # dropping tail samples silently corrupts preintegration deltas;
        # callers must size via needed_imu_cap/bucket_imu_cap
        raise RuntimeError(
            f"IMU buffer overflow: {len(ts)} samples > cap {cap} — "
            "caller must bucket the capacity (needed_imu_cap)")
    n = len(ts)
    t_buf = np.zeros((cap,))
    w_buf = np.zeros((cap, 3))
    a_buf = np.zeros((cap, 3))
    t0 = float(ts[0]) if n else 0.0
    t_buf[:n] = ts[:n] - t0
    w_buf[:n] = ws[:n]
    a_buf[:n] = accs[:n]
    return t_buf, w_buf, a_buf, n, t0


def triangulate_track(tr, frames_by_id) -> Optional[np.ndarray]:
    """Multi-view DLT with cheirality check over all of a track's
    observing frames (reference map/track.cpp:46-76).

    Depth-camera extension: when any observing frame carries a metric
    keypoint depth (FrameRec.kp_depth, from XRSLAM_SENSOR_DEPTH_CAMERA
    input — XRSLAM.h:22,56-60), the landmark is seeded directly from
    the measured z-depth along the bearing, skipping the two-view
    requirement and the cheirality gate (a single depth observation
    fully determines the point)."""
    for fid, k in tr.obs.items():
        f = frames_by_id.get(fid)
        if f is None or f.kp_depth is None:
            continue
        z = float(f.kp_depth[k])
        if z <= 1e-3:
            continue
        b = f.bearings[k]
        if b[2] <= 1e-6:  # corrupt/behind-camera bearing: fall through to DLT
            continue
        x_c = b / b[2] * z
        q_wc, p_wc = f.camera_pose()
        return nputil.quat_rotate(q_wc, x_c) + p_wc

    rows = []
    Ps = []
    for fid, k in tr.obs.items():
        f = frames_by_id.get(fid)
        if f is None:
            continue
        q_wc, p_wc = f.camera_pose()
        R = nputil.quat_to_matrix(q_wc).T
        T = -(R @ p_wc)
        P = np.concatenate([R, T[:, None]], axis=1)  # (3,4)
        b = f.bearings[k]
        rows.append(b[0] * P[2] - b[2] * P[0])
        rows.append(b[1] * P[2] - b[2] * P[1])
        Ps.append(P)
    if len(Ps) < 2:
        return None
    A = np.stack(rows)
    _, _, vt = np.linalg.svd(A, full_matrices=True)
    h = vt[-1]
    for P in Ps:
        qz = P @ h
        if not (qz[2] * h[3] > 0):
            return None
    return h[:3] / h[3]


# device-constant caches: every jnp.asarray/zeros at extract time is a
# separate host->device transfer; these never change, so build them
# once per (shape, dtype)
_CONST_CACHE: dict = {}


def _marg_zeros(K: int, dtype):
    key = ("marg", K, jnp.dtype(dtype).name)
    if key not in _CONST_CACHE:
        _CONST_CACHE[key] = MargPrior.zeros(K, 0, dtype=dtype)
    return _CONST_CACHE[key]


def _false_scalar():
    if "false" not in _CONST_CACHE:
        _CONST_CACHE["false"] = jnp.zeros((), dtype=bool)
    return _CONST_CACHE["false"]


def extract_window(
    pmap: PipelineMap,
    frames: List[FrameRec],
    K_slots: int,
    L_slots: int,
    noise: pre.ImuNoise,
    track_filter: Optional[Callable[[TrackRec], bool]] = None,
    anchor_must_be_in_window: bool = True,
    imu_cap: int = 256,
    with_preint: bool = True,
    all_frames_between: Optional[List[List[FrameRec]]] = None,
    dtype=None,
):
    """Build (WindowState, WindowData, WindowMeta) from `frames`.

    `dtype=None` extracts in the canonical compute dtype — float64 when
    x64 is enabled (CPU tests), float32 otherwise (requesting f64
    without x64 would truncate anyway, with a warning per call).

    - landmark slots are filled with tracks passing `track_filter` that
      are observed by ≥1 window frame and whose first *window*
      observation defines the anchor (matching the reference where the
      first observing frame is the inverse-depth anchor,
      map/track.cpp:90-101),
    - preintegration entry j integrates the raw IMU samples between
      window frames j-1 and j (`all_frames_between[j]` lists the map
      frames whose sample buffers cover that interval; default: just
      frame j, i.e. consecutive map frames),
    - frame fix flags are taken from the FrameRec tags.
    """
    from ..utils.timing import stage_timer

    with stage_timer("window_extract_time"):
        return _extract_window_impl(
            pmap, frames, K_slots, L_slots, noise, track_filter,
            anchor_must_be_in_window, imu_cap, with_preint,
            all_frames_between, dtype)


def _extract_window_impl(
    pmap, frames, K_slots, L_slots, noise, track_filter,
    anchor_must_be_in_window, imu_cap, with_preint,
    all_frames_between, dtype,
):
    import jax

    if dtype is None:
        dtype = jax.dtypes.canonicalize_dtype(jnp.float64)
    K = len(frames)
    assert K <= K_slots
    fid_to_slot = {f.id: i for i, f in enumerate(frames)}

    # ---- frame states ----
    def padK(arrs, d):
        out = np.zeros((K_slots,) + arrs[0].shape) if arrs else np.zeros((K_slots,) + d)
        for i, a in enumerate(arrs):
            out[i] = a
        return out

    q = padK([f.q for f in frames], (4,))
    q[K:, 0] = 1.0
    p = padK([f.p for f in frames], (3,))
    v = padK([f.v for f in frames], (3,))
    bg = padK([f.bg for f in frames], (3,))
    ba = padK([f.ba for f in frames], (3,))
    q_bc = padK([f.q_bc for f in frames], (4,))
    q_bc[K:, 0] = 1.0
    p_bc = padK([f.p_bc for f in frames], (3,))
    q_bi = padK([f.q_bi for f in frames], (4,))
    q_bi[K:, 0] = 1.0
    p_bi = padK([f.p_bi for f in frames], (3,))
    w2 = padK([f.sqrt_inv_cov2 for f in frames], (2, 2))

    # ---- tracks / landmarks ----
    track_filter = track_filter or (lambda t: True)
    chosen: List[TrackRec] = []
    seen = set()
    for f in frames:
        for k in np.nonzero(f.track_ids >= 0)[0]:
            tid = int(f.track_ids[k])
            if tid in seen:
                continue
            seen.add(tid)
            tr = pmap.tracks.get(tid)
            if tr is None or not track_filter(tr):
                continue
            n_in_window = sum(1 for fid in tr.obs if fid in fid_to_slot)
            if n_in_window < 1:
                continue
            chosen.append(tr)
            if len(chosen) >= L_slots:
                break
        if len(chosen) >= L_slots:
            break

    bearings = np.zeros((K_slots, L_slots, 3))
    bearings[..., 2] = 1.0
    obs_mask = np.zeros((K_slots, L_slots), dtype=bool)
    inv_depth = np.zeros((L_slots,))
    lm_mask = np.zeros((L_slots,), dtype=bool)
    track_ids = [tr.id for tr in chosen]
    anchor_bearing = np.zeros((L_slots, 3))
    anchor_bearing[:, 2] = 1.0

    # vectorized per-frame fill (the per-(track, obs) python loop cost
    # ~8 ms/extract on the 2-CPU host — a real slice of sequence fps)
    tid_to_slot = {tid: l for l, tid in enumerate(track_ids)}
    for s, f in enumerate(frames):
        ks = np.nonzero(f.track_ids >= 0)[0]
        if len(ks) == 0:
            continue
        ls = np.fromiter((tid_to_slot.get(int(t), -1)
                          for t in f.track_ids[ks]), np.int64, len(ks))
        sel = ls >= 0
        if not sel.any():
            continue
        b = f.bearings[ks[sel]]
        bearings[s, ls[sel]] = b / np.linalg.norm(b, axis=1, keepdims=True)
        obs_mask[s, ls[sel]] = True
    n_ch = len(chosen)
    # anchor = first observing window slot (reference: the first
    # observing frame is the inverse-depth anchor, map/track.cpp:90-101)
    ref_idx = np.where(obs_mask.any(axis=0),
                       obs_mask.argmax(axis=0), 0).astype(np.int32)
    anchor_bearing[:n_ch] = bearings[ref_idx[:n_ch], np.arange(n_ch)]
    if n_ch:
        # inverse depth of the stored world point in the anchor camera;
        # rotation preserves the norm, so only the camera center matters
        p_wc_all = np.stack([f.p + nputil.quat_rotate(f.q, f.p_bc)
                             for f in frames])
        has = np.array([tr.p_w is not None for tr in chosen])
        if has.any():
            idxs = np.nonzero(has)[0]
            X = np.stack([chosen[i].p_w for i in idxs])
            rng = np.linalg.norm(X - p_wc_all[ref_idx[idxs]], axis=1)
            inv_depth[idxs] = 1.0 / np.maximum(rng, 1e-9)
            lm_mask[idxs] = True

    # ---- preintegration: one batched integrate over all K intervals ----
    # the passed imu_cap is a floor; the actual capacity is bucketed up
    # to cover every interval so merged/skipped-frame intervals can
    # never silently truncate (see IMU_CAP_BUCKETS)
    if with_preint:
        lists = [(all_frames_between[j] if all_frames_between is not None
                  else [frames[j]]) for j in range(1, K)]
        imu_cap = needed_imu_cap(lists, floor=imu_cap)
    pmask = np.zeros((K_slots,), dtype=bool)
    bg_lin = np.zeros((K_slots, 3))
    ba_lin = np.zeros((K_slots, 3))
    t_bufs = np.zeros((K_slots, imu_cap))
    w_bufs = np.zeros((K_slots, imu_cap, 3))
    a_bufs = np.zeros((K_slots, imu_cap, 3))
    t_ends = np.zeros((K_slots,))
    counts = np.zeros((K_slots,), dtype=np.int32)
    for j in range(K_slots):
        if not with_preint or j == 0 or j >= K:
            continue
        between = (all_frames_between[j] if all_frames_between is not None
                   else [frames[j]])
        t_buf, w_buf, a_buf, n, t0 = interval_samples(between, imu_cap)
        if n == 0:
            continue
        t_bufs[j], w_bufs[j], a_bufs[j] = t_buf, w_buf, a_buf
        t_ends[j] = frames[j].t - t0
        counts[j] = n
        pmask[j] = True
        bg_lin[j] = frames[j - 1].bg
        ba_lin[j] = frames[j - 1].ba
    frame_mask = np.zeros((K_slots,), dtype=bool)
    frame_mask[:K] = True
    fix_pose = np.zeros((K_slots,), dtype=bool)
    fix_motion = np.zeros((K_slots,), dtype=bool)
    for i, f in enumerate(frames):
        fix_pose[i] = f.fix_pose
        fix_motion[i] = f.fix_motion

    # ONE packed host->device transfer for the whole extraction instead
    # of ~25 separate uploads
    from ..utils.fetch import put_packed

    npdt = np.dtype(jnp.dtype(dtype).name)
    (q_d, p_d, v_d, bg_d, ba_d, invd_d, qbc_d, pbc_d, qbi_d, pbi_d,
     bearings_d, w2_d, tb_d, wb_d, ab_d, te_d, bglin_d, balin_d,
     obs_d, ref_d, pmask_d, fmask_d, fpose_d, fmot_d, lm_d, flm_d,
     counts_d) = put_packed((
         q.astype(npdt), p.astype(npdt), v.astype(npdt), bg.astype(npdt),
         ba.astype(npdt), inv_depth.astype(npdt), q_bc.astype(npdt),
         p_bc.astype(npdt), q_bi.astype(npdt), p_bi.astype(npdt),
         bearings.astype(npdt), w2.astype(npdt), t_bufs.astype(npdt),
         w_bufs.astype(npdt), a_bufs.astype(npdt), t_ends.astype(npdt),
         bg_lin.astype(npdt), ba_lin.astype(npdt),
         obs_mask, ref_idx, pmask, frame_mask, fix_pose, fix_motion,
         lm_mask, np.zeros((L_slots,), dtype=bool), counts))

    imu_dev = (tb_d, wb_d, ab_d, te_d, counts_d)
    preint = pre.integrate_batch(tb_d, wb_d, ab_d, te_d, bglin_d, balin_d,
                                 noise, counts_d)

    state = WindowState(q=q_d, p=p_d, v=v_d, bg=bg_d, ba=ba_d,
                        inv_depth=invd_d)
    data = WindowData(
        q_bc=qbc_d, p_bc=pbc_d, q_bi=qbi_d, p_bi=pbi_d,
        bearings=bearings_d,
        obs_mask=obs_d,
        ref_idx=ref_d,
        sqrt_inv_cov2=w2_d,
        preint=preint,
        preint_mask=pmask_d,
        bg_lin=bglin_d,
        ba_lin=balin_d,
        frame_mask=fmask_d,
        fix_pose=fpose_d,
        fix_motion=fmot_d,
        landmark_mask=lm_d,
        fix_landmark=flm_d,
        marg=_marg_zeros(K_slots, dtype),
        use_marg=_false_scalar(),
    )
    meta = WindowMeta(frames=frames, track_ids=track_ids,
                      anchor_bearing=anchor_bearing,
                      ref_idx=ref_idx, landmark_mask=lm_mask,
                      obs_mask=obs_mask, preint_mask=pmask,
                      imu_dev=imu_dev)
    return state, data, meta


def write_back_start(state: WindowState, extra=None,
                     async_copy: bool = False):
    """Stage the write_back fetch set for a later
    write_back(..., prefetched=handle). async_copy=False by default:
    the deferral itself (solve overlapping host work, fetch at next
    mirror_frame) is what overlaps the transfer with host work."""
    from ..utils.fetch import fetch_packed_start

    return fetch_packed_start(
        (state.q, state.p, state.v, state.bg, state.ba, state.inv_depth,
         extra), async_copy=async_copy, label="pend")


def write_back(pmap: PipelineMap, state: WindowState, data: WindowData,
               meta: WindowMeta, write_landmarks: bool = True,
               frame_subset: Optional[set] = None, extra=None,
               prefetched=None):
    """Push optimized states back into the map. `extra` is an optional
    pytree of device arrays fetched in the SAME packed transfer as the
    states and returned (host copies). `prefetched` is a handle from
    write_back_start(state, extra) to complete instead of fetching."""
    from ..utils.timing import stage_timer

    with stage_timer("window_write_time"):
        return _write_back_impl(pmap, state, data, meta, write_landmarks,
                                frame_subset, extra, prefetched)


def _write_back_impl(pmap, state, data, meta, write_landmarks, frame_subset,
                     extra=None, prefetched=None):
    from ..utils.fetch import fetch_packed

    # ONE device fetch for everything the host needs: jax.device_get
    # copies PER LEAF (6 blocking transfers here); fetch_packed concats
    # on device and pulls a single buffer.
    if prefetched is not None:
        qs, ps, vs, bgs, bas, invd, extra_out = prefetched.get()
    else:
        qs, ps, vs, bgs, bas, invd, extra_out = fetch_packed(
            (state.q, state.p, state.v, state.bg, state.ba, state.inv_depth,
             extra))
    for i, f in enumerate(meta.frames):
        if frame_subset is not None and f.id not in frame_subset:
            continue
        if f.fix_pose and f.fix_motion:
            continue
        if not f.fix_pose:
            f.q = nputil.quat_normalize(qs[i])
            f.p = ps[i].copy()
        if not f.fix_motion:
            f.v = vs[i].copy()
            f.bg = bgs[i].copy()
            f.ba = bas[i].copy()
    if write_landmarks:
        refs = meta.ref_idx
        lm_ok = meta.landmark_mask
        for l, tid in enumerate(meta.track_ids):
            tr = pmap.tracks.get(tid)
            if tr is None or not lm_ok[l]:
                continue
            af = meta.frames[int(refs[l])]
            q_wc, p_wc = af.camera_pose()
            d = max(float(invd[l]), 1e-9)
            x_c = meta.anchor_bearing[l] / d
            tr.p_w = nputil.quat_rotate(q_wc, x_c) + p_wc
    return extra_out
