"""Sliding-window VIO backend.

Host orchestration of the jitted window solves, mirroring the
reference's SlidingWindowTracker (reference:
xrslam/src/xrslam/core/sliding_window_tracker.cpp):

  track():
    [parsac] judge_track_status / update_track_status  (:578-790)
    localize_newframe                                   (:119-143)
    manage_keyframe                                     (:145-223)
    keyframe:  track_landmark, refine_window, slide_window (:225-368)
    subframe:  refine_subwindow                         (:370-465)

All solves run on fixed (K_slots, L_slots) arrays so each of the three
solve variants (localize / refine_window / refine_subwindow) compiles
exactly once.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Config
from ..estimation.marginalization import marginalize_frame as marginalize_window_frame
from ..estimation.solver import (SolveOptions, landmark_gates,
                                 solve_chained, solve_window)
from ..estimation.window import ES_SIZE, MargPrior
from ..imu import preintegration as pre
from ..ransac import parsac as parsac_mod
from ..ransac import pnp as pnp_mod
from ..ransac import stereo as stereo_mod
from ..utils.fetch import fetch_packed
from ..utils.timing import stage_timer
from . import nputil
from .map import FrameRec, PipelineMap
from .window_builder import (
    extract_window, interval_samples, needed_imu_cap, triangulate_track,
    write_back, write_back_start,
)


@jax.jit
def _predict_slot(state, data, idx):
    """IMU-forward prediction of window slot `idx` from slot idx-1
    using the extraction's own preintegration delta (reference
    preintegrator.cpp:102-112 predict on IMU-frame poses) — runs inside
    the device program, so the parsac-off path needs NO separate
    prediction upload."""
    from ..geometry import lie

    i = idx - 1
    g = lambda x, j: jax.lax.dynamic_index_in_dim(x, j, 0, keepdims=False)
    q_prev, p_prev, v_prev = g(state.q, i), g(state.p, i), g(state.v, i)
    bg_prev, ba_prev = g(state.bg, i), g(state.ba, i)
    q_bi_i, p_bi_i = g(data.q_bi, i), g(data.p_bi, i)
    q_bi_j, p_bi_j = g(data.q_bi, idx), g(data.p_bi, idx)
    delta = jax.tree.map(lambda x: g(x, idx), data.preint)
    q_i = lie.quat_mul(q_prev, q_bi_i)
    p_i = p_prev + lie.quat_rotate(q_prev, p_bi_i)
    qj, pj, vj, _, _ = pre.predict(q_i, p_i, v_prev, bg_prev, ba_prev,
                                   delta)
    q_b = lie.quat_normalize(lie.quat_mul(qj, lie.quat_conj(q_bi_j)))
    p_b = pj - lie.quat_rotate(q_b, p_bi_j)
    # no IMU in the interval (delta == identity) -> previous state
    has = g(data.preint.t, idx) > 0
    q_b = jnp.where(has, q_b, q_prev)
    p_b = jnp.where(has, p_b, p_prev)
    vj = jnp.where(has, vj, v_prev)
    upd = lambda arr, val: jax.lax.dynamic_update_index_in_dim(
        arr, val.astype(arr.dtype), idx, 0)
    return state._replace(
        q=upd(state.q, q_b), p=upd(state.p, p_b), v=upd(state.v, vj),
        bg=upd(state.bg, bg_prev), ba=upd(state.ba, ba_prev))


@jax.jit
def _prior_T_parsac(q_b, p_b, q_bc, p_bc):
    """World→camera 4×4 prior from a staged device-side body-pose
    prediction (the host twin lives in judge_track_status)."""
    from ..geometry import lie

    q_wc = lie.quat_mul(q_b, q_bc)
    p_wc = p_b + lie.quat_rotate(q_b, p_bc)
    Rcw = lie.quat_to_matrix(q_wc).T
    T = jnp.eye(4, dtype=p_b.dtype)
    return T.at[:3, :3].set(Rcw).at[:3, 3].set(-(Rcw @ p_wc))


@jax.jit
def _inject_patch(state, pend_st, fmap, fmask, lmap, lmask):
    """Masked slot override of an extraction's initial values from a
    pending solve's device state (see _inject_solved). fmap/lmap are
    full-width index arrays (unmatched slots masked), so every call
    with the same (K, L, K_pending) shapes reuses one executable."""
    from ..geometry import lie

    qn = lie.quat_normalize(pend_st.q[fmap])
    fm = fmask[:, None]
    return state._replace(
        q=jnp.where(fm, qn.astype(state.q.dtype), state.q),
        p=jnp.where(fm, pend_st.p[fmap].astype(state.p.dtype), state.p),
        v=jnp.where(fm, pend_st.v[fmap].astype(state.v.dtype), state.v),
        bg=jnp.where(fm, pend_st.bg[fmap].astype(state.bg.dtype), state.bg),
        ba=jnp.where(fm, pend_st.ba[fmap].astype(state.ba.dtype), state.ba),
        inv_depth=jnp.where(
            lmask, pend_st.inv_depth[lmap].astype(state.inv_depth.dtype),
            state.inv_depth),
    )


class SlidingWindowTracker:
    # rotation-subframe merge trigger (reference hardcodes 9 with 3->1
    # grouping, sliding_window_tracker.cpp:375-377)
    ROT_MERGE_TRIGGER = 9

    def __init__(self, pmap: PipelineMap, config: Config):
        self.map = pmap
        self.config = config
        self.noise = pre.ImuNoise(
            cov_w=jnp.asarray(config.gyroscope_noise_cov),
            cov_a=jnp.asarray(config.accelerometer_noise_cov),
            cov_bg=jnp.asarray(config.gyroscope_bias_noise_cov),
            cov_ba=jnp.asarray(config.accelerometer_bias_noise_cov),
        )
        # +2: a subframe lift (manage_keyframe rotation cases) inserts an
        # extra keyframe in the same step that attached the new frame,
        # so the window briefly holds size+2 frames before slide_window
        # trims it (reference grows the Ceres problem dynamically)
        self.K_slots = config.sliding_window_size + 2
        self.L_slots = config.window_landmark_slots
        # Subwindow slots: 1 keyframe + the larger of (a) the rotation
        # case, merge-bounded at ROT_MERGE_TRIGGER subframes (reference
        # hardcodes 9, sliding_window_tracker.cpp:375), and (b) the
        # translational case, bounded by config subframe_size — plus 1
        # slack for the attach-then-solve ordering. Derived, not
        # hardcoded, so raising sliding_window_subframe_size in config
        # cannot overflow the fixed-shape subwindow arrays (extraction
        # still asserts K <= K_slots, so any miscount fails loudly).
        self.K_sub = 1 + max(self.ROT_MERGE_TRIGGER,
                             config.sliding_window_subframe_size) + 1
        self.marg: Optional[MargPrior] = None
        dt_canon = jax.dtypes.canonicalize_dtype(jnp.float64)
        self.bin_conf = parsac_mod.initial_bin_confidences(dt_canon)
        # separate persistent bin state for the 2D-2D essential PARSAC
        # (the reference keeps a distinct function-static vector,
        # stereo.cpp:146-151)
        self.bin_conf_2d2d = parsac_mod.initial_bin_confidences(dt_canon)
        self._rng = np.random.default_rng(config.random)
        self._key = jax.random.PRNGKey(config.random)
        self.m_th: float = 0.0
        # tracker-map handle for static-tag cross-propagation
        # (reference sliding_window_tracker.cpp:771-789)
        self._tracker_map: Optional[PipelineMap] = None
        # solver_time_limit bookkeeping (reference enforces
        # max_solver_time_in_seconds via Ceres, solver.cpp:186; a jitted
        # fixed-iteration scan cannot early-exit on wall clock, so the
        # semantic here is: measure the steady-state per-iteration
        # time of each solve variant and clamp the NEXT solves'
        # iteration count to fit the budget)
        self._iter_seconds: dict = {}
        self._solve_calls: dict = {}
        self._solve_samples: dict = {}  # per-variant startup timings
        # deferred localize result: (device WindowState, target FrameRec,
        # slot) — see localize_newframe(defer_write=True)
        self._loc_result = None
        # staged device-side parsac pose prediction (see _predict_frame)
        self._pred_parsac = None
        # deferred SUBFRAME write-back: the fused subframe solve is
        # dispatched but its result is NOT fetched until the next
        # frame's mirror_frame — the solve overlaps the next frame's
        # host work (PNG decode, tracker prep) and the blocking fetch
        # shrinks to a pure round trip. This reproduces the reference's
        # threaded semantics where the backend lags the tracker by one
        # frame and outputs are IMU-forward-propagated from the last
        # optimized state (frontend_worker.cpp worker loop +
        # detail.cpp:144-177 predict_pose).
        self._pending_writes: list = []  # FIFO of deferred write-backs
        self._latest_solved = None   # (t,q,p,v,bg,ba) fallback snapshot
        self._pending_loc = None     # staged localize result (lift cases)
        # write-back pipeline depth: with pipelined_writeback the solve
        # results may stay un-materialized for up to TWO frames (their
        # buffers ride the tracker pack SUBMITTED BEFORE the backend
        # stage runs, so the pack never waits on the current frame's
        # solve programs); every extraction corrects its stale host
        # reads by injecting the pending solves' device states
        # (_inject_solved). Depth 1 reproduces the round-4 semantics
        # exactly (drain-before-mirror).
        self.max_pending = 2 if (config.pipelined_writeback
                                 and config.worker_overlap
                                 and config.deferred_subframe_write
                                 and not config.parsac_flag) else 1
        # event counters for inspection + the RD-VIO e2e proofs
        self.stats = {
            "subframe_lifts": 0,       # rotation/translation lift cases
            "rotation_subframes": 0,   # frames kept as rotation subframes
            "rotation_merges": 0,      # 3->1 subframe compressions
            "rotation_solves": 0,      # rotation-only refine_subwindow runs
            "tracks_unstatic": 0,      # tracks losing TT_STATIC via PARSAC
        }

    # ------------------------------------------------------------------
    def _next_key(self):
        self._key, k = jax.random.split(self._key)
        return k

    def _budget_chained(self, chain_key: str, l_opts: SolveOptions,
                        s_opts: SolveOptions) -> SolveOptions:
        """Clamp the subwindow share of a chained solve so the whole
        program fits the time budget (localize share untouched)."""
        limit = self.config.solver_time_limit
        est = self._iter_seconds.get(chain_key)
        if not self._limit_active() or not est:
            return s_opts
        fit = max(1, int(limit / est) - l_opts.iterations)
        if fit < s_opts.iterations:
            import dataclasses

            ladder = [1, 2, 3, 5, 8, 15, 30]
            fit = max([v for v in ladder if v <= fit] or [1])
            return dataclasses.replace(s_opts, iterations=fit)
        return s_opts

    def _budgeted_iterations(self, variant: str) -> int:
        """Iteration count for a solve variant under solver_time_limit
        (match reference solver.cpp:186 max_solver_time_in_seconds)."""
        iters = self.config.solver_iteration_limit
        limit = self.config.solver_time_limit
        est = self._iter_seconds.get(variant)
        if limit and limit > 0 and est:
            fit = max(1, int(limit / est))
            if fit < iters:
                # quantize to a small ladder: `iterations` is a static
                # jit arg, so every distinct value is a new executable
                ladder = [1, 2, 3, 5, 8, 15, 30]
                iters = max([v for v in ladder if v <= fit] or [1])
        return iters

    def _limit_active(self) -> bool:
        limit = self.config.solver_time_limit
        return bool(limit) and 0 < limit < 1.0e5

    # timed startup calls per solve variant (call 0 compiles and is
    # skipped; the next _CALIB_SAMPLES calls are synced + timed and the
    # MEDIAN fixes the per-iteration estimate — a single wall-clock
    # sample can be an outlier and mis-clamp solver_time_limit)
    _CALIB_SAMPLES = 3

    def _note_solve(self, variant: str, result, iterations: int):
        """Startup-only timing of a solve variant: call 0 compiles
        (wall time is compile-polluted, skipped); calls 1..3 are synced
        and timed, and their median fixes the executable's
        per-iteration cost; every later call runs fully async — the
        time limit then clamps iteration counts (reference
        solver.cpp:186 max_solver_time_in_seconds) without adding a
        single blocking sync to steady state or disabling the fused
        solve_chained path."""
        n = self._solve_calls.get(variant, 0)
        self._solve_calls[variant] = n + 1
        if (n < 1 or n > self._CALIB_SAMPLES
                or variant in self._iter_seconds or iterations <= 0):
            return
        from ..utils.fetch import TRANSFER_LOCK

        t0 = time.perf_counter()
        with TRANSFER_LOCK:
            jax.block_until_ready(result)
        dt = time.perf_counter() - t0
        samples = self._solve_samples.setdefault(variant, [])
        samples.append(dt / iterations)
        if len(samples) >= self._CALIB_SAMPLES:
            samples.sort()
            self._iter_seconds[variant] = samples[len(samples) // 2]

    def _solve_timed(self, variant: str, state, data, opts: SolveOptions):
        """solve_window + the one-time per-variant timing of
        _note_solve (no-op without a configured solver_time_limit)."""
        if not self._limit_active():
            return solve_window(state, data, opts)
        st, info = solve_window(state, data, opts)
        self._note_solve(variant, st, opts.iterations)
        return st, info

    def keyframes(self) -> List[FrameRec]:
        return self.map.frames

    def last_frame_chain(self) -> FrameRec:
        """Last keyframe or its last subframe (the temporal latest)."""
        kf = self.map.frames[-1]
        return kf.subframes[-1] if kf.subframes else kf

    def get_latest_state(self):
        """Latest OPTIMIZED state (reference FrontendWorker
        latest_state). With a subframe write-back in flight this is the
        previous frame's solved state — consumers (predict_pose)
        IMU-forward-propagate past it, exactly the reference's threaded
        output path."""
        if self._pending_writes and self._latest_solved is not None:
            return self._latest_solved
        f = self.last_frame_chain()
        return f.t, f.q, f.p, f.v, f.bg, f.ba

    def _apply_write(self, pend) -> None:
        out = write_back(self.map, pend["st"], pend["data"], pend["meta"],
                         write_landmarks=pend.get("write_landmarks", False),
                         extra=pend.get("extra"),
                         prefetched=pend["pf"])
        # refresh the output anchor to the newest frame this write
        # materialized (solved values are now in the host records)
        newest = None
        for f in pend["meta"].frames:
            if not (f.fix_pose and f.fix_motion):
                if newest is None or f.t > newest.t:
                    newest = f
        if newest is not None:
            self._latest_solved = (newest.t, newest.q.copy(),
                                   newest.p.copy(), newest.v.copy(),
                                   newest.bg.copy(), newest.ba.copy())
        cb = pend.get("cb")
        if cb is not None:
            cb(out)

    def materialize_pending(self) -> None:
        """Fetch + apply ALL deferred write-backs oldest-first (by now
        the solves have long finished on device and the buffers usually
        rode a tracker transfer). The staged localize result lands
        FIRST so a window write-back of the same frame wins, matching
        the split path's write order."""
        self._materialize_loc()
        while self._pending_writes:
            self._apply_write(self._pending_writes.pop(0))

    def _materialize_for_mirror(self) -> None:
        """The mirror_frame-time landing policy: apply every pending
        write whose buffer has already ARRIVED (rode an earlier tracker
        pack — free), then block only as needed to keep at most
        max_pending-1 solves outstanding before the next one is
        dispatched. Depth 1 degenerates to the full drain (round-4
        semantics); depth 2 leaves the newest solve in flight so the
        tracker pack it rides never waits on solve programs."""
        self._materialize_loc()
        while self._pending_writes and \
                self._pending_writes[0]["pf"]._buf is not None:
            self._apply_write(self._pending_writes.pop(0))
        while len(self._pending_writes) >= self.max_pending:
            self._apply_write(self._pending_writes.pop(0))

    def _queue_write(self, **pend) -> None:
        self._pending_writes.append(pend)
        while len(self._pending_writes) > self.max_pending:
            self._apply_write(self._pending_writes.pop(0))

    def _inject_solved(self, state, frames, meta=None):
        """Correct an extraction's initial values from solves whose
        write-back has not landed yet (pipelined_writeback): the
        extraction read host records up to max_pending solves stale;
        override the affected slots with the pending solves' device
        states, oldest→newest so the newest solve wins. Device-to-device
        — no transfer; the slot maps are fixed-shape masked index
        arrays so the jitted patch compiles once per (K, L, K_pending)
        signature (dynamic-length gathers would recompile per frame).
        Exactness: an injected slot receives precisely the value
        write_back would have put into the host record (the host
        normalize is mirrored on device), so the solve sequence is
        identical to the drain-before-mirror schedule."""
        if not self._pending_writes:
            return state
        K = int(state.q.shape[0])
        L = int(state.inv_depth.shape[0])
        for pend in self._pending_writes:
            pmeta = pend["meta"]
            idx = {f.id: j for j, f in enumerate(pmeta.frames)}
            # inject every matching frame (incl. currently-fixed ones:
            # a fixed slot's pending value equals what the host record
            # will hold once the write lands, so the injection is the
            # correct anchor either way)
            fmap = np.zeros((K,), np.int32)
            fmask = np.zeros((K,), bool)
            for i, f in enumerate(frames):
                j = idx.get(f.id)
                if j is not None:
                    fmap[i] = j
                    fmask[i] = True
            # landmarks: inverse depth transfers only between slots
            # with the SAME anchor ray (window slides re-anchor tracks)
            lmap = np.zeros((L,), np.int32)
            lmask = np.zeros((L,), bool)
            if meta is not None and pend.get("write_landmarks"):
                pslot = {}
                for l, tid in enumerate(pmeta.track_ids):
                    if pmeta.landmark_mask[l]:
                        pslot[tid] = l
                for l2, tid in enumerate(meta.track_ids):
                    if not meta.landmark_mask[l2]:
                        continue
                    l = pslot.get(tid)
                    if l is None:
                        continue
                    if meta.frames[meta.ref_idx[l2]].id \
                            == pmeta.frames[pmeta.ref_idx[l]].id:
                        lmap[l2] = l
                        lmask[l2] = True
            if not (fmask.any() or lmask.any()):
                continue
            state = _inject_patch(state, pend["st"], fmap, fmask, lmap,
                                  lmask)
        return state

    def _defer_writes(self) -> bool:
        # PARSAC consumes the refined previous pose on host each frame
        # (judge_track_status prior) — but mirror_frame's
        # _materialize_for_mirror lands every due write BEFORE track()
        # reaches the parsac stage, so depth-1 deferral is safe with
        # parsac too (the write-back rides the tracker pack instead of
        # paying its own blocking round trip; max_pending stays 1 under
        # parsac). Locked by test_synthetic_overlap_parity[True].
        return self.config.deferred_subframe_write

    # ------------------------------------------------------------------
    def mirror_frame(self, tracker_map: PipelineMap, frame_id: int) -> bool:
        """Pull the new frame from the tracker map: clone it, splice the
        IMU samples of skipped frames, extend tracks that continue from
        the window's latest frame, integrate + predict
        (reference :31-80)."""
        # land deferred solves before host code reads frame states
        # (prediction, extraction, PARSAC); with pipelined_writeback the
        # newest solve may stay in flight — extractions correct their
        # stale host reads via _inject_solved
        self._materialize_for_mirror()
        self._tracker_map = tracker_map
        frame_i = self.last_frame_chain()
        idx_i = tracker_map.frame_index_by_id(frame_i.id)
        idx_j = tracker_map.frame_index_by_id(frame_id)
        if idx_i is None or idx_j is None:
            return False
        old_i = tracker_map.frames[idx_i]
        old_j = tracker_map.frames[idx_j]

        new_j = old_j.clone_shallow()
        # accumulate IMU of skipped frames (idx_i, idx_j)
        between = tracker_map.frames[idx_i + 1: idx_j + 1]
        new_j.imu_t = np.concatenate([f.imu_t for f in between])
        new_j.imu_w = np.concatenate([f.imu_w for f in between])
        new_j.imu_a = np.concatenate([f.imu_a for f in between])

        # extend tracks: keypoints of frame_i that continue into frame_j
        new_track_ids = np.full_like(new_j.track_ids, -1)
        for ki in np.nonzero(old_i.track_ids >= 0)[0]:
            tr_old = tracker_map.tracks.get(int(old_i.track_ids[ki]))
            if tr_old is None:
                continue
            kj = tr_old.obs.get(old_j.id)
            if kj is None:
                continue
            # the window-side track continuing frame_i's keypoint ki
            tr_new = self.map.get_track(frame_i, int(ki), create=True)
            new_track_ids[kj] = tr_new.id
            if tr_old.static is False:
                tr_new.static = False
        new_j.track_ids = new_track_ids
        self.map.attach_frame(new_j)
        # map.attach indexes observations into window tracks
        for k in np.nonzero(new_j.track_ids >= 0)[0]:
            tid = int(new_j.track_ids[k])
            if tid in self.map.tracks:
                self.map.tracks[tid].obs[new_j.id] = int(k)

        # predict pose from preintegration
        self._predict_frame(frame_i, new_j)
        return True

    def _predict_frame(self, frame_i: FrameRec, frame_j: FrameRec):
        from ..geometry import lie
        from ..utils.fetch import put_packed

        self._pred_dev = None
        self._pred_frame = None
        self._pred_parsac = None
        frame_j.bg = frame_i.bg.copy()
        frame_j.ba = frame_i.ba.copy()
        if not self.config.parsac_flag:
            # NO separate upload: the window extraction already ships
            # the interval's IMU and integrates its preintegration
            # delta; _apply_pred composes the prediction IN-PROGRAM
            # from those device-resident arrays (_predict_slot). Host
            # values (upload placeholders until write_back) hold the
            # previous frame's state. One fewer put + one fewer
            # dispatch per frame.
            frame_j.q, frame_j.p = frame_i.q.copy(), frame_i.p.copy()
            frame_j.v = frame_i.v.copy()
            self._pred_frame = frame_j
            return
        # PARSAC's prior-pose PnP needs the predicted pose — integrate
        # + predict on device and STAGE the result: judge_track_status
        # composes its prior pose in-program from these arrays and the
        # host copy lands in judge's single combined pull (no separate
        # blocking fetch per frame)
        cap = needed_imu_cap([[frame_j]], floor=256)
        t_buf, w_buf, a_buf, n, t0 = interval_samples([frame_j], cap)
        if n == 0:
            frame_j.q, frame_j.p, frame_j.v = frame_i.q.copy(), frame_i.p.copy(), frame_i.v.copy()
            return
        # compose at the IMU, then back to body (reference
        # preintegrator.cpp:102-112 predict on imu poses)
        q_i = nputil.quat_mul(frame_i.q, frame_i.q_bi)
        p_i = frame_i.p + nputil.quat_rotate(frame_i.q, frame_i.p_bi)
        (t_d, w_d, a_d, te_d, qi_d, pi_d, vi_d, bg_d, ba_d, qbi_d,
         pbi_d) = put_packed((t_buf, w_buf, a_buf,
                              np.asarray(frame_j.t - t0), q_i, p_i,
                              frame_i.v, frame_i.bg, frame_i.ba,
                              frame_j.q_bi, frame_j.p_bi))
        d = pre.integrate(t_d, w_d, a_d, te_d, bg_d, ba_d, self.noise,
                          count=n, compute_sqrt_inv=False)
        qj, pj, vj, _, _ = pre.predict(qi_d, pi_d, vi_d, bg_d, ba_d, d)
        q_b_dev = lie.quat_normalize(lie.quat_mul(qj, lie.quat_conj(qbi_d)))
        p_b_dev = pj - lie.quat_rotate(q_b_dev, pbi_d)
        frame_j.q, frame_j.p = frame_i.q.copy(), frame_i.p.copy()
        frame_j.v = frame_i.v.copy()
        self._pred_parsac = (frame_j, q_b_dev, p_b_dev, vj)

    def _land_pred_parsac(self, extra=None):
        """Fetch + apply the staged parsac prediction (one packed
        transfer; `extra` device leaves ride it and are returned)."""
        pp = getattr(self, "_pred_parsac", None)
        if pp is None:
            return fetch_packed(extra) if extra is not None else None
        self._pred_parsac = None
        frame_j, q_b_dev, p_b_dev, vj = pp
        if extra is not None:
            q_b, p_b, vj_h, out = fetch_packed(
                (q_b_dev, p_b_dev, vj, extra))
        else:
            q_b, p_b, vj_h = fetch_packed((q_b_dev, p_b_dev, vj))
            out = None
        frame_j.q = nputil.quat_normalize(q_b)
        frame_j.p = p_b
        frame_j.v = vj_h
        return out

    # ------------------------------------------------------------------
    def track(self) -> bool:
        if self.config.parsac_flag:
            with stage_timer("parsac_time"):
                if self.judge_track_status():
                    self.update_track_status()
        # the keyframe/subframe decision is computed first (it never
        # depends on the localize result); on the (majority) subframe
        # path BOTH backend solves — the new-frame localization and the
        # subwindow refine — run on the subwindow's arrays as ONE fused
        # device program (solve_chained): one extraction, one dispatch,
        # one fetch per frame instead of three blocking syncs
        verdict = self._keyframe_decision()
        if verdict != "subframe":
            if any(f.kp_depth is not None for f in self.map.all_frames()):
                # depth-camera mode: host triangulation (depth-seeded,
                # window_builder.triangulate_track) needs the localized
                # pose on host — legacy split path
                with stage_timer("localize_newframe_time"):
                    self.localize_newframe(defer_write=True)
                self.manage_keyframe(verdict)
                self._materialize_localize()
                self.track_landmark()
                with stage_timer("bundle_adjustor_solve_time"):
                    self.refine_window()
            else:
                with stage_timer("bundle_adjustor_solve_time"):
                    self._fused_keyframe_step(verdict)
            with stage_timer("bundle_adjustor_marginalization_time"):
                self.slide_window()
        else:
            target = self.map.frames[-1]
            self.manage_keyframe(verdict)
            with stage_timer("subwindow_solve_time"):
                self._fused_subframe_step(target)
        self._loc_result = None
        return True

    def _fused_keyframe_step(self, verdict: str) -> None:
        """The keyframe backend as ONE device chain — localize → inject
        → in-program triangulation of the new keyframe's candidate
        tracks → full-window VI-BA → landmark gates
        (solve_keyframe_chain; reference :119-358) — with the write-back
        deferred to ride the next tracker transfer. The reference's
        split (localize / track_landmark / refine) forces a blocking
        pose fetch between the stages; chaining on device removes the
        last steady-state sync of the pipeline."""
        from ..estimation.solver import solve_keyframe_chain
        from ..utils.fetch import fetch_packed_start

        with stage_timer("localize_newframe_time"):
            l_state, l_data, l_meta, target, l_slot = self._prepare_localize()
        l_opts = SolveOptions(iterations=self._budgeted_iterations("localize"))

        # prediction anchor while the write-back is in flight: the
        # temporally-latest frame whose host record holds SOLVED values
        # (everything except the not-yet-written target)
        frames0 = list(self.map.frames)
        anchor = frames0[-1]
        if len(frames0) >= 2:
            anchor = (frames0[-2].subframes[-1] if frames0[-2].subframes
                      else frames0[-2])
        anchor_state = (anchor.t, anchor.q.copy(), anchor.p.copy(),
                        anchor.v.copy(), anchor.bg.copy(), anchor.ba.copy())

        self.manage_keyframe(verdict)

        frames = list(self.map.frames)
        new_kf = frames[-1]
        # candidate tracks for in-program triangulation: the newest
        # keyframe's untriangulated tracks (reference :225-245)
        cand_ids = set()
        for k in np.nonzero(new_kf.track_ids >= 0)[0]:
            tr = self.map.tracks.get(int(new_kf.track_ids[k]))
            if tr is not None and not tr.triangulated:
                cand_ids.add(tr.id)
        base_filter = self._refine_track_filter(frames)
        state, data, meta = extract_window(
            self.map, frames, self.K_slots, self.L_slots, self.noise,
            track_filter=lambda t: base_filter(t) or t.id in cand_ids,
            all_frames_between=self._kf_between(frames),
            imu_cap=128,
        )
        state = self._inject_solved(state, frames, meta)
        if self.marg is None:
            self.marg = MargPrior.gauge_fix(self.K_slots, self.L_slots, state)
        data = data._replace(marg=self.marg, use_marg=jnp.asarray(True))

        cand_mask = np.zeros((self.L_slots,), dtype=bool)
        for l, tid in enumerate(meta.track_ids):
            cand_mask[l] = tid in cand_ids

        try:
            s2 = frames.index(target)
            inject = True
        except ValueError:
            # lifted-subframe cases: the localize target is a subframe,
            # not a window slot — its host record gets the localized
            # state via the staged loc fetch below
            s2 = 0
            inject = False
        fuv = np.stack([[f.K[0, 0], f.K[1, 1]] for f in frames]
                       + [[1.0, 1.0]] * (self.K_slots - len(frames)))
        r_opts = SolveOptions(iterations=self._budgeted_iterations("refine"))
        st1, st2, gates, tri_ok = solve_keyframe_chain(
            l_state, l_data, l_opts, state, data, r_opts,
            jnp.asarray(l_slot, jnp.int32), jnp.asarray(s2, jnp.int32),
            jnp.asarray(inject), jnp.asarray(cand_mask),
            jnp.asarray(fuv, dtype=state.p.dtype))
        if self._limit_active():
            self._note_solve("kf_chain", st2,
                             l_opts.iterations + r_opts.iterations)

        data_eff = data._replace(
            landmark_mask=(data.landmark_mask | tri_ok) & gates[0])
        self._last_window = (st2, data_eff, meta)

        # host-side effective landmark set: existing seeded landmarks +
        # every triangulation candidate (rejects cleaned up in the
        # flags callback once the verdicts arrive)
        lm_eff = meta.landmark_mask | cand_mask
        meta_eff = dataclasses.replace(meta, landmark_mask=lm_eff)

        def apply_flags(extra_out):
            (g_ok, _rpe), t_ok = extra_out
            g_ok = np.asarray(g_ok)
            t_ok = np.asarray(t_ok)
            # candidate verdicts (reference :225-245 flag setting);
            # a candidate is kept only if triangulation AND the
            # post-solve gates accept it
            for l, tid in enumerate(meta.track_ids):
                if not cand_mask[l]:
                    continue
                tr = self.map.tracks.get(tid)
                if tr is None:
                    continue
                if t_ok[l]:
                    tr.triangulated = True
                    tr.valid = True
                    tr.static = True
                    tr.life = max(tr.life, 1)
                else:
                    tr.triangulated = False
                    tr.valid = False
                    tr.p_w = None
            ok_eff = g_ok & (t_ok | ~cand_mask)
            self._apply_landmark_gates(meta_eff, ok_eff)
            covered = {tid for l, tid in enumerate(meta.track_ids)
                       if lm_eff[l]}
            self._revalidate_landmarks(frames, skip_ids=covered)

        pf_loc = None
        if not inject:
            pf_loc = fetch_packed_start(
                (st1.q[l_slot], st1.p[l_slot], st1.v[l_slot],
                 st1.bg[l_slot], st1.ba[l_slot]),
                async_copy=False, label="loc")

        if self._defer_writes():
            if self._latest_solved is None or not self._pending_writes:
                self._latest_solved = anchor_state
            pf = write_back_start(st2, extra=(gates, tri_ok))
            self._queue_write(st=st2, data=data_eff, meta=meta_eff,
                              pf=pf, extra=(gates, tri_ok),
                              cb=apply_flags, write_landmarks=True)
            if pf_loc is not None:
                self._pending_loc = dict(pf=pf_loc, target=target)
        else:
            if pf_loc is not None:
                self._apply_loc(pf_loc, target)
            out = write_back(self.map, st2, data_eff, meta_eff,
                             extra=(gates, tri_ok), write_landmarks=True)
            apply_flags(out)

    def _apply_loc(self, pf, target: FrameRec) -> None:
        q, p, v, bg, ba = pf.get()
        target.q = nputil.quat_normalize(q)
        target.p = p
        target.v = v
        target.bg = bg
        target.ba = ba

    def _materialize_loc(self) -> None:
        """Land a staged localize result (lifted-subframe keyframe
        cases; the buffer rode the tracker transfer)."""
        pl = self._pending_loc
        if pl is None:
            return
        self._pending_loc = None
        self._apply_loc(pl["pf"], pl["target"])

    def collect_riders(self):
        """Deferred device→host buffers that should ride the next
        tracker transfer (write-backs, staged localize result). Each
        handle rides at most one pack (the tracker marks it _riding)."""
        out = []
        if self._pending_loc is not None:
            out.append(self._pending_loc["pf"])
        for pend in self._pending_writes:
            out.append(pend["pf"])
        return [h for h in out if not getattr(h, "_riding", False)]

    def prepare_fused_subframe(self, target: FrameRec):
        """Host half of the fused subframe step: subwindow extraction +
        the localize-stage masking. Returns a ctx dict holding the
        solve_chained operands + finish bookkeeping (or None when the
        keyframe has no subframes). Public so the multi-sequence driver
        (tools/multiseq.py) can batch N sequences' chained solves on
        the data axis (SURVEY §2.3) and then finish each with
        finish_fused_subframe."""
        prep = self._prepare_subwindow()
        if prep is None:
            return None
        s_state, s_data, s_meta, s_opts, variant, kf, saved = prep
        frames = s_meta.frames
        s2 = len(frames) - 1
        assert frames[s2] is target
        K = self.K_sub
        pm = np.zeros((K,), dtype=bool)
        pm[s2] = bool(s_meta.preint_mask[s2])
        fix = np.ones((K,), dtype=bool)
        fix[s2] = False
        l_data = s_data._replace(
            preint_mask=jnp.asarray(pm),
            fix_pose=jnp.asarray(fix),
            fix_motion=jnp.asarray(fix),
            fix_landmark=jnp.ones_like(s_data.fix_landmark),
            obs_mask=jnp.asarray(s_meta.obs_mask),          # pre-variant obs
            landmark_mask=jnp.asarray(s_meta.landmark_mask),
        )
        if variant == "subwindow_rot":
            # reprojection priors only exist for triangulated statics
            l_data = l_data._replace(landmark_mask=s_data.landmark_mask)
        l_state = self._apply_pred(s_state, frames, s_data)
        # under a solver_time_limit the chained program is budgeted as
        # ONE executable: its per-total-iteration cost (measured once
        # post-compile by _note_solve) clamps the subwindow share while
        # the localize share keeps its ladder value — the fused
        # single-dispatch path stays intact either way
        chain_key = "chained:" + variant
        l_opts = SolveOptions(iterations=self._budgeted_iterations("localize"))
        s_opts = self._budget_chained(chain_key, l_opts, s_opts)
        return dict(l_state=l_state, l_data=l_data, l_opts=l_opts,
                    s_state=s_state, s_data=s_data, s_opts=s_opts,
                    s2=s2, variant=variant, chain_key=chain_key,
                    kf=kf, saved=saved, meta=s_meta, frames=frames)

    def finish_fused_subframe(self, ctx, st2):
        """Apply a fused subframe solve result (defer/write + restore
        fix flags)."""
        kf, saved, frames = ctx["kf"], ctx["saved"], ctx["frames"]
        s_data, s_meta = ctx["s_data"], ctx["meta"]
        if self._limit_active():
            self._note_solve(ctx["chain_key"], st2,
                             ctx["l_opts"].iterations
                             + ctx["s_opts"].iterations)
        kf.fix_pose, kf.fix_motion = saved
        if self._defer_writes() and len(frames) >= 2:
            if self._latest_solved is None or not self._pending_writes:
                # frames[-2] is the newest frame whose host record is
                # already solved (materialized when this frame arrived);
                # with older writes still pending, _apply_write keeps
                # the anchor fresh as they land instead
                f = frames[-2]
                self._latest_solved = (f.t, f.q.copy(), f.p.copy(),
                                       f.v.copy(), f.bg.copy(), f.ba.copy())
            pf = write_back_start(st2)
            self._queue_write(st=st2, data=s_data, meta=s_meta, pf=pf)
        else:
            write_back(self.map, st2, s_data, s_meta, write_landmarks=False)

    def _fused_subframe_step(self, target: FrameRec):
        """Localize + subwindow refine as one device program over the
        subwindow arrays. The localize stage is the same math as
        localize_newframe (reference :119-143) expressed as a fix-mask
        variant of the subwindow system: every frame but the target
        fixed, every landmark fixed, preintegration only prev→target —
        tracks observed by the target always have their previous-frame
        observation in the subwindow (KLT chains are contiguous), so the
        reprojection-prior set matches the full-window extraction."""
        ctx = self.prepare_fused_subframe(target)
        if ctx is None:  # no subframes (unreachable on this path)
            self.localize_newframe(defer_write=True)
            self._materialize_localize()
            return
        broker = getattr(self, "solve_broker", None)
        if broker is not None:
            # multi-sequence data-parallel mode: the broker collects
            # every lockstepped sequence's chained solve this frame and
            # dispatches them as ONE batched program (tools/multiseq.py)
            broker.submit(self, ctx)
            return
        s2 = jnp.asarray(ctx["s2"], jnp.int32)
        _, st2, _ = solve_chained(
            ctx["l_state"], ctx["l_data"], ctx["l_opts"],
            ctx["s_state"], ctx["s_data"], ctx["s_opts"], s2, s2)
        self.finish_fused_subframe(ctx, st2)

    # ------------------------------------------------------------------
    def _prepare_localize(self):
        """Host half of localize_newframe: window extraction + factor
        masking + the device-resident IMU-prediction patch. Returns
        (state, data, meta, target, slot)."""
        frames = list(self.map.frames)
        kf = frames[-2] if len(frames) >= 2 else frames[0]
        prev = kf.subframes[-1] if kf.subframes else kf
        target = frames[-1]
        # window: keyframes (minus last two) + prev + target, all fixed
        # except target; preint chain only prev->target
        wframes = [f for f in frames[:-1]] + ([prev] if prev is not kf else []) + [target]
        # ensure prev is second-to-last (preint entry for target)
        if prev is not kf:
            wframes = [f for f in frames[:-1]] + [prev, target]
        saved = [(f.fix_pose, f.fix_motion) for f in wframes]
        for f in wframes[:-1]:
            f.fix_pose = True
            f.fix_motion = True
        state, data, meta = extract_window(
            self.map, wframes, self.K_slots + 2, self.L_slots, self.noise,
            track_filter=lambda t: t.all_tagged("valid", "triangulated", "static"),
            with_preint=True, imu_cap=96,
        )
        for f, (fp, fm) in zip(wframes, saved):
            f.fix_pose, f.fix_motion = fp, fm
        # correct stale host reads from in-flight solves, then the
        # device-resident IMU prediction of the target (parsac-off path)
        state = self._inject_solved(state, wframes, meta)
        state = self._apply_pred(state, wframes, data)
        # only the last preint entry (prev -> target) is a factor
        pm = np.zeros((self.K_slots + 2,), dtype=bool)
        pm[len(wframes) - 1] = bool(meta.preint_mask[len(wframes) - 1])
        data = data._replace(
            preint_mask=jnp.asarray(pm),
            fix_landmark=jnp.ones_like(data.fix_landmark),
        )
        return state, data, meta, target, len(wframes) - 1

    def localize_newframe(self, defer_write: bool = False):
        """Solve only the new frame against preintegration from the
        previous frame + reprojection priors of its triangulated static
        tracks (reference :119-143).

        With defer_write the solved state is NOT fetched: it is kept in
        self._loc_result as (device_state, target_frame, slot) for the
        follow-up solve to consume on device (subframe path) or for
        _materialize_localize to fetch when the host genuinely needs the
        pose (keyframe path)."""
        state, data, meta, target, slot = self._prepare_localize()
        st, _ = self._solve_timed("localize", state, data, SolveOptions(
            iterations=self._budgeted_iterations("localize")))
        if defer_write:
            from ..utils.fetch import fetch_packed_start

            # staged (not async-copied): the fetch rides a later packed
            # pull (see write_back_start)
            pf = fetch_packed_start(
                (st.q[slot], st.p[slot], st.v[slot], st.bg[slot],
                 st.ba[slot]), async_copy=False)
            self._loc_result = (st, target, slot, pf)
        else:
            write_back(self.map, st, data, meta, write_landmarks=False,
                       frame_subset={target.id})

    def _materialize_localize(self):
        """Fetch the deferred localize result into the target frame's
        host record (one packed transfer)."""
        if getattr(self, "_loc_result", None) is None:
            return
        st, target, slot, pf = self._loc_result
        self._loc_result = None
        q, p, v, bg, ba = pf.get()
        target.q = nputil.quat_normalize(q)
        target.p = p
        target.v = v
        target.bg = bg
        target.ba = ba

    def _apply_pred(self, state, frames, data=None):
        """Patch the IMU prediction of the newest frame into its window
        slot (host record still carries the previous frame's state on
        the parsac-off path). Computed IN-PROGRAM from the extraction's
        own preintegration delta (`data`) — no separate upload."""
        pd = getattr(self, "_pred_dev", None)
        if pd is not None:
            try:
                idx = frames.index(pd[0])
            except ValueError:
                return state
            self._pred_dev = None
            return state._replace(
                q=state.q.at[idx].set(pd[1].astype(state.q.dtype)),
                p=state.p.at[idx].set(pd[2].astype(state.p.dtype)),
                v=state.v.at[idx].set(pd[3].astype(state.v.dtype)),
            )
        pf = getattr(self, "_pred_frame", None)
        if pf is None or data is None:
            return state
        try:
            idx = frames.index(pf)
        except ValueError:
            return state
        if idx <= 0:
            return state
        self._pred_frame = None
        return _predict_slot(state, data, jnp.asarray(idx, jnp.int32))

    def _override_from_localize(self, state, frames):
        """Patch the deferred localize target's state into another
        window's slots, device-to-device (no host round trip)."""
        loc = getattr(self, "_loc_result", None)
        if loc is None:
            return state
        st_loc, target, slot = loc[0], loc[1], loc[2]
        try:
            idx = frames.index(target)
        except ValueError:
            return state
        return state._replace(
            q=state.q.at[idx].set(st_loc.q[slot]),
            p=state.p.at[idx].set(st_loc.p[slot]),
            v=state.v.at[idx].set(st_loc.v[slot]),
            bg=state.bg.at[idx].set(st_loc.bg[slot]),
            ba=state.ba.at[idx].set(st_loc.ba[slot]),
        )

    # ------------------------------------------------------------------
    def _keyframe_decision(self) -> str:
        """Pure (non-mutating) classification of the new frame
        (reference :145-223). manage_keyframe CONSUMES this verdict —
        there is exactly one copy of the decision logic, so track()'s
        early fused-path dispatch and the later map mutation cannot
        diverge. Verdicts:
          'lift_rotation'    — last (rotation) subframe lifts to
                               keyframe; new frame is also a keyframe
          'lift_translation' — last (translational) subframe lifts to
                               keyframe; new frame becomes its rotation
                               subframe
          'overflow'         — subframe budget full -> new keyframe
          'forced'           — too few mapped landmarks -> new keyframe
          'subframe'         — attach as subframe
        A verdict is a keyframe case iff it is not 'subframe'."""
        kf_i = self.map.frames[-2]
        new_j = self.map.frames[-1]
        cfg = self.config
        if kf_i.subframes:
            if kf_i.subframes[-1].no_translation:
                if not new_j.no_translation:
                    return "lift_rotation"
            else:
                if new_j.no_translation:
                    return "lift_translation"
                if len(kf_i.subframes) >= cfg.sliding_window_subframe_size:
                    return "overflow"
        mapped = 0
        for k in np.nonzero(new_j.track_ids >= 0)[0]:
            tr = self.map.tracks.get(int(new_j.track_ids[k]))
            if tr is not None and tr.all_tagged("valid", "triangulated", "static"):
                mapped += 1
        if mapped < cfg.sliding_window_force_keyframe_landmarks:
            return "forced"
        return "subframe"

    def manage_keyframe(self, verdict: Optional[str] = None) -> bool:
        """Apply the subframe/keyframe state machine for the given
        _keyframe_decision verdict (computed here if not supplied)
        (reference :145-223). Returns True if the new frame (or a
        lifted subframe) became a keyframe."""
        if verdict is None:
            verdict = self._keyframe_decision()
        kf_i = self.map.frames[-2]
        new_j = self.map.frames[-1]

        if verdict == "lift_rotation":
            # last rotation subframe becomes a keyframe before new_j
            lifted = kf_i.subframes.pop()
            lifted.keyframe = True
            self.map.attach_frame(lifted, len(self.map.frames) - 1)
            new_j.keyframe = True
            self.stats["subframe_lifts"] += 1
            return True
        if verdict == "lift_translation":
            # lift last translational subframe to keyframe; new_j
            # becomes its rotation subframe
            lifted = kf_i.subframes.pop()
            lifted.keyframe = True
            nj = self.map.detach_frame(len(self.map.frames) - 1)
            lifted.subframes.append(nj)
            self.map.attach_frame(lifted)
            self.stats["subframe_lifts"] += 1
            return True
        if verdict in ("overflow", "forced"):
            new_j.keyframe = True
            return True

        assert verdict == "subframe", verdict
        sub = self.map.detach_frame(len(self.map.frames) - 1)
        if sub.no_translation:
            self.stats["rotation_subframes"] += 1
        kf_i.subframes.append(sub)
        # re-index: detach removed obs; restore them under the subframe
        for k in np.nonzero(sub.track_ids >= 0)[0]:
            tid = int(sub.track_ids[k])
            if tid in self.map.tracks:
                self.map.tracks[tid].obs[sub.id] = int(k)
        return False

    # ------------------------------------------------------------------
    def track_landmark(self):
        """Triangulate the new keyframe's untriangulated tracks
        (reference :225-245, map/track.cpp:46-76)."""
        new_j = self.map.frames[-1]
        frames_by_id = {f.id: f for f in self.map.all_frames()}
        for k in np.nonzero(new_j.track_ids >= 0)[0]:
            tr = self.map.tracks.get(int(new_j.track_ids[k]))
            if tr is None or tr.triangulated:
                continue
            p = triangulate_track(tr, frames_by_id)
            if p is not None:
                tr.p_w = p
                tr.triangulated = True
                tr.valid = True
                tr.static = True
                tr.life = 1
            else:
                tr.triangulated = False
                tr.valid = False

    # ------------------------------------------------------------------
    def _kf_between(self, frames: List[FrameRec]):
        """IMU-interval frame lists for a keyframe window: entry j
        covers subframes of keyframe j-1 plus keyframe j (reference
        keyframe_preintegration assembly, :300-316)."""
        out = [[]]
        for j in range(1, len(frames)):
            out.append(list(frames[j - 1].subframes) + [frames[j]])
        return out

    def refine_window(self):
        """Full sliding-window VI-BA with the marginalization prior
        (reference :247-358)."""
        frames = list(self.map.frames)
        state, data, meta = extract_window(
            self.map, frames, self.K_slots, self.L_slots, self.noise,
            track_filter=self._refine_track_filter(frames),
            all_frames_between=self._kf_between(frames),
            imu_cap=128,
        )
        state = self._inject_solved(state, frames, meta)
        if self.marg is None:
            self.marg = MargPrior.gauge_fix(self.K_slots, self.L_slots, state)
        data = data._replace(marg=self.marg, use_marg=jnp.asarray(True))
        st, info = self._solve_timed("refine", state, data, SolveOptions(
            iterations=self._budgeted_iterations("refine")))
        # depth/RPE landmark gates run on device with the solve and come
        # back in write_back's single packed fetch (the host-loop
        # equivalent cost ~90 ms/keyframe)
        fuv = np.stack([[f.K[0, 0], f.K[1, 1]] for f in frames]
                       + [[1.0, 1.0]] * (self.K_slots - len(frames)))
        gates = landmark_gates(st, data, jnp.asarray(fuv, dtype=st.p.dtype))
        # keep the solved window for slide_window's marginalization;
        # landmarks the gates just rejected must not contribute to the
        # prior (the re-extraction path would exclude them), so mask
        # them out with the DEVICE ok flags
        self._last_window = (
            st, data._replace(landmark_mask=data.landmark_mask & gates[0]),
            meta)

        def apply_gates(extra_out):
            ok, _rpe = extra_out
            from ..utils.fetch import locked_asarray

            self._apply_landmark_gates(meta, locked_asarray(ok))
            # the reference re-validates EVERY triangulated track each
            # keyframe — including currently-invalid ones, which can
            # win TT_VALID back (sliding_window_tracker.cpp:325-352).
            # The device gates only cover tracks occupying window
            # landmark slots; run the host twin over the rest so no
            # track keeps a stale verdict.
            covered = {tid for l, tid in enumerate(meta.track_ids)
                       if meta.landmark_mask[l]}
            self._revalidate_landmarks(frames, skip_ids=covered)

        if self._defer_writes():
            # keyframe write-back deferred exactly like the subframe
            # path: the fetch rides the next frame's tracker transfer;
            # gate verdicts land one frame late — the reference's
            # threaded-backend lag (frontend_worker.cpp worker loop).
            # The localize stage already materialized the target's
            # pose, so the latest-state snapshot stays fresh.
            f = frames[-1]
            self._latest_solved = (f.t, f.q.copy(), f.p.copy(),
                                   f.v.copy(), f.bg.copy(), f.ba.copy())
            pf = write_back_start(st, extra=gates)
            self._queue_write(st=st, data=data, meta=meta, pf=pf,
                              extra=gates, cb=apply_gates,
                              write_landmarks=True)
        else:
            out = write_back(self.map, st, data, meta, extra=gates)
            apply_gates(out)

    def _refine_track_filter(self, frames):
        kf_ids = {f.id for f in frames}

        def ok(tr):
            return (tr.valid and tr.static and tr.first_frame_id() in kf_ids)
        return ok

    def _apply_landmark_gates(self, meta, ok: np.ndarray):
        """Apply device-computed landmark_gates verdicts to the map
        (reference :325-352 landmark re-validation)."""
        for l, tid in enumerate(meta.track_ids):
            if not meta.landmark_mask[l]:
                continue
            tr = self.map.tracks.get(tid)
            if tr is None:
                continue
            tr.valid = bool(ok[l])
            tr.trash = not tr.valid
        self.map.prune_tracks(lambda t: t.trash and not t.static)

    def _revalidate_landmarks(self, frames, skip_ids=frozenset()):
        """Depth and RPE gates after the window solve — host twin of the
        device landmark_gates, applied to triangulated tracks NOT
        covered by the window landmark slots (`skip_ids`); the verdict
        can resurrect TT_VALID, matching the reference's every-track
        re-validation (reference :325-352). Device/host parity is
        guarded by tests/test_solver.py::test_landmark_gates_match_host.

        Vectorized over all (track, window-observation) pairs: the
        per-pair quaternion math as a python loop cost ~80 ms/keyframe
        on this 2-CPU host and dominated the keyframe stage."""
        slot = {f.id: i for i, f in enumerate(frames)}
        trs = [tr for tr in self.map.tracks.values()
               if tr.id not in skip_ids and tr.triangulated
               and tr.p_w is not None]
        if not trs:
            return
        R_cw = np.stack([nputil.quat_to_matrix(
            nputil.quat_mul(f.q, f.q_bc)).T for f in frames])      # (F,3,3)
        p_wc = np.stack([f.p + nputil.quat_rotate(f.q, f.p_bc)
                         for f in frames])                          # (F,3)
        fuv = np.stack([[f.K[0, 0], f.K[1, 1]] for f in frames])    # (F,2)
        ti, fi, bo = [], [], []
        for t_idx, tr in enumerate(trs):
            for fid, k in tr.obs.items():
                s = slot.get(fid)
                if s is None:
                    continue
                ti.append(t_idx)
                fi.append(s)
                bo.append(frames[s].bearings[k])
        n_tr = len(trs)
        if not ti:
            pair_ok = np.ones((0,), bool)
            ti_a = np.zeros((0,), np.intp)
            rpe_sum = np.zeros(n_tr)
            cnt = np.zeros(n_tr)
            depth_bad = np.zeros(n_tr, bool)
        else:
            ti_a = np.asarray(ti, np.intp)
            fi_a = np.asarray(fi, np.intp)
            b = np.stack(bo)                                        # (N,3)
            X = np.stack([trs[i].p_w for i in ti_a])                # (N,3)
            y = np.einsum("nij,nj->ni", R_cw[fi_a], X - p_wc[fi_a])
            z = y[:, 2]
            depth_pair_bad = (z <= 1.0e-3) | (z > 50.0)
            zs = np.where(np.abs(z) > 1e-12, z, 1e-12)
            bz = np.where(np.abs(b[:, 2]) > 1e-12, b[:, 2], 1e-12)
            du = (y[:, 0] / zs - b[:, 0] / bz) * fuv[fi_a, 0]
            dv = (y[:, 1] / zs - b[:, 1] / bz) * fuv[fi_a, 1]
            rpe = np.hypot(du, dv)
            rpe_sum = np.zeros(n_tr)
            cnt = np.zeros(n_tr)
            depth_bad = np.zeros(n_tr, bool)
            np.add.at(rpe_sum, ti_a, rpe)
            np.add.at(cnt, ti_a, 1.0)
            np.logical_or.at(depth_bad, ti_a, depth_pair_bad)
        ok_all = ~depth_bad & (rpe_sum / np.maximum(cnt, 1.0) < 3.0)
        for i, tr in enumerate(trs):
            tr.valid = bool(ok_all[i])
            tr.trash = not tr.valid
        self.map.prune_tracks(lambda t: t.trash and not t.static)

    # ------------------------------------------------------------------
    def slide_window(self):
        """Marginalize the oldest keyframe(s) (reference :360-368)."""
        while len(self.map.frames) > self.config.sliding_window_size:
            frames = list(self.map.frames)
            last = getattr(self, "_last_window", None)
            if last is not None and last[2].frames == frames \
                    and last[2].imu_dev is not None:
                # refine_window just solved THIS window: marginalize at
                # its device-resident solution, re-integrating the kept
                # IMU buffers at the SOLVED bias linearization — the
                # same numbers the re-extraction would produce, minus
                # the host rebuild and the ~100 KB re-upload
                st, data, meta = last
                tb, wb, ab, te, cnt = meta.imu_dev
                bg_lin = jnp.concatenate([st.bg[:1], st.bg[:-1]], axis=0)
                ba_lin = jnp.concatenate([st.ba[:1], st.ba[:-1]], axis=0)
                preint = pre.integrate_batch(tb, wb, ab, te, bg_lin, ba_lin,
                                             self.noise, cnt)
                state = st
                data = data._replace(preint=preint, bg_lin=bg_lin,
                                     ba_lin=ba_lin)
            else:
                # re-extraction reads host frame states: land any
                # deferred keyframe write first (rare multi-slide case)
                self.materialize_pending()
                state, data, meta = extract_window(
                    self.map, frames, self.K_slots, self.L_slots, self.noise,
                    track_filter=self._refine_track_filter(frames),
                    all_frames_between=self._kf_between(frames),
                    imu_cap=128,
                )
                if self.marg is None:
                    self.marg = MargPrior.gauge_fix(self.K_slots, self.L_slots, state)
                data = data._replace(marg=self.marg, use_marg=jnp.asarray(True))
            self._last_window = None
            self.marg = marginalize_window_frame(state, data, victim=0)
            victim = self.map.frames[0]
            for sub in victim.subframes:
                self.map.untrack_frame(sub)
            victim.subframes.clear()
            self.map.detach_frame(0)
            # drop tracks that lost their anchor entirely
            self.map.prune_tracks(lambda t: len(t.obs) == 0)

    # ------------------------------------------------------------------
    def refine_subwindow(self):
        """Subframe-only optimization; rotation-only variant for
        pure-rotation subframes (reference :370-465)."""
        prep = self._prepare_subwindow()
        if prep is None:
            return
        state, data_r, meta, opts, variant, kf, saved = prep
        # feed the deferred localize solution of the newest subframe in
        # on device (its host record still holds the IMU prediction)
        state = self._override_from_localize(state, meta.frames)
        st, _ = self._solve_timed(variant, state, data_r, opts)
        kf.fix_pose, kf.fix_motion = saved
        write_back(self.map, st, data_r, meta, write_landmarks=False)

    def _prepare_subwindow(self):
        """Host half of refine_subwindow: subframe merge + window
        extraction + factor masking. Returns (state, data, meta, opts,
        variant, kf, saved_fix_flags) or None when there is nothing to
        solve."""
        kf = self.map.frames[-1]
        if not kf.subframes:
            return None
        rotation_mode = kf.subframes[0].no_translation

        if rotation_mode and len(kf.subframes) >= self.ROT_MERGE_TRIGGER:
            # compress: merge each group of 3 into its last frame
            self.stats["rotation_merges"] += 1
            groups = len(kf.subframes) // 3
            merged = []
            for g in range(groups):
                grp = kf.subframes[g * 3:(g + 1) * 3]
                tgt = grp[-1]
                tgt.imu_t = np.concatenate([f.imu_t for f in grp])
                tgt.imu_w = np.concatenate([f.imu_w for f in grp])
                tgt.imu_a = np.concatenate([f.imu_a for f in grp])
                for src in grp[:-1]:
                    self.map.untrack_frame(src)
                merged.append(tgt)
            merged += kf.subframes[groups * 3:]
            kf.subframes = merged

        frames = [kf] + list(kf.subframes)
        saved = (kf.fix_pose, kf.fix_motion)
        kf.fix_pose = True
        kf.fix_motion = True
        last_sub = kf.subframes[-1]
        kf_anchor_ids = {f.id for f in self.map.frames}

        if rotation_mode:
            def tf(tr):
                if last_sub.id not in tr.obs or not tr.valid:
                    return False
                return True
        else:
            def tf(tr):
                if not tr.all_tagged("valid", "triangulated", "static"):
                    return False
                anchored_kf = tr.first_frame_id() in kf_anchor_ids
                anchored_in_sub = tr.first_frame_id() in {f.id for f in frames[1:]}
                return anchored_kf or anchored_in_sub

        state, data, meta = extract_window(
            self.map, frames, self.K_sub, self.L_slots, self.noise,
            track_filter=tf, imu_cap=128,
        )
        state = self._inject_solved(state, frames, meta)
        # tracks anchored at the (fixed) keyframe act as priors: depth
        # fixed (reference create_reprojection_prior_factor)
        refs = meta.ref_idx
        fix_lm = refs == 0
        if rotation_mode:
            # rotation factors act on untriangulated tracks of the last
            # subframe; triangulated static ones become reproj priors
            lm_mask = meta.landmark_mask
            tri = np.zeros_like(lm_mask)
            for l, tid in enumerate(meta.track_ids):
                tr = self.map.tracks.get(tid)
                tri[l] = bool(tr and tr.triangulated and tr.static)
            # reproj only for triangulated; rotation factor for the rest
            data_r = data._replace(
                landmark_mask=jnp.asarray(lm_mask & tri),
                fix_landmark=jnp.asarray(fix_lm | tri),
            )
            opts = SolveOptions(iterations=self._budgeted_iterations("subwindow_rot"),
                                use_rotation=True)
            # rotation factors: only last subframe obs of untriangulated
            obs = meta.obs_mask.copy()
            keep = np.zeros_like(obs)
            keep[len(frames) - 1] = obs[len(frames) - 1]
            keep[refs[None, :] == np.arange(self.K_sub)[:, None]] = True
            rot_mask = lm_mask & ~tri
            obs_rot = obs & keep & rot_mask[None, :]
            obs_rep = obs & keep & tri[None, :]
            data_r = data_r._replace(obs_mask=jnp.asarray(obs_rep | obs_rot))
            self.stats["rotation_solves"] += 1
            variant = "subwindow_rot"
        else:
            data_r = data._replace(fix_landmark=jnp.asarray(fix_lm))
            opts = SolveOptions(iterations=self._budgeted_iterations("subwindow"))
            variant = "subwindow"
        return state, data_r, meta, opts, variant, kf, saved

    # ------------------------------------------------------------------
    # PARSAC dynamic-object rejection (reference :578-790)
    # ------------------------------------------------------------------
    def judge_track_status(self) -> bool:
        curr = self.map.frames[-1]
        kf = self.map.frames[-2]
        P3D, P2D, lens, kps = [], [], [], []
        for k in np.nonzero(curr.track_ids >= 0)[0]:
            tr = self.map.tracks.get(int(curr.track_ids[k]))
            if tr is None or not (tr.valid and tr.triangulated) or tr.p_w is None:
                continue
            b = curr.bearings[k]
            P2D.append(b[:2] / b[2])
            P3D.append(tr.p_w)
            lens.append(max(tr.life, 0))
            kps.append(int(k))
        if len(P2D) < 20:
            self._land_pred_parsac()  # frame pose still has to land
            return False
        N_CAP = 256
        n = min(len(P2D), N_CAP)
        X = np.zeros((N_CAP, 3))
        x2 = np.zeros((N_CAP, 2))
        ln = np.zeros((N_CAP,), dtype=np.int64)
        X[:n] = np.stack(P3D)[:n]
        x2[:n] = np.stack(P2D)[:n]
        ln[:n] = np.asarray(lens)[:n]
        valid = np.zeros((N_CAP,), dtype=bool)
        valid[:n] = True

        # prior pose: composed ON DEVICE from the staged IMU prediction
        # when one is pending — the host pose then lands in the same
        # packed pull as the PnP mask (one round trip instead of two)
        pp = getattr(self, "_pred_parsac", None)
        if pp is not None and pp[0] is curr:
            prior_T = _prior_T_parsac(pp[1], pp[2],
                                      jnp.asarray(curr.q_bc),
                                      jnp.asarray(curr.p_bc))
        else:
            q_wc, p_wc = curr.camera_pose()
            Rcw = nputil.quat_to_matrix(q_wc).T
            tcw = -(Rcw @ p_wc)
            prior_np = np.eye(4)
            prior_np[:3, :3] = Rcw
            prior_np[:3, 3] = tcw
            prior_T = jnp.asarray(prior_np)
        fu = curr.K[0, 0]
        T, mask, overlap, self.bin_conf, ok = pnp_mod.find_pnp_matrix_parsac_imu(
            self._next_key(), jnp.asarray(X), jnp.asarray(x2), jnp.asarray(ln),
            prior_T, self.bin_conf,
            self.config.parsac_dynamic_probability,
            valid=jnp.asarray(valid), threshold=1.0 / fu,
            norm_scale=self.config.parsac_norm_scale,
        )
        # ONE locked packed pull for the mask + the staged prediction
        # (fetch_packed serializes on TRANSFER_LOCK: with worker_overlap
        # this runs inside between() while the FetchWorker thread pulls)
        mask = np.asarray(self._land_pred_parsac(extra=mask))

        # epipolar ambiguity check between keyframe and current frame
        # using the IMU-predicted relative pose (reference :612-716)
        q_wc, p_wc = curr.camera_pose()
        q_kfc, p_kfc = kf.camera_pose()
        R_kf = nputil.quat_to_matrix(q_kfc)
        R_cu = nputil.quat_to_matrix(q_wc)
        Rrel = R_cu.T @ R_kf          # kf cam -> cur cam
        trel = R_cu.T @ (p_kfc - p_wc)
        tx = np.array([[0, -trel[2], trel[1]],
                       [trel[2], 0, -trel[0]],
                       [-trel[1], trel[0], 0]])
        E = tx @ Rrel
        Kk = kf.K
        Kc = curr.K
        F = np.linalg.inv(Kk.T) @ E @ np.linalg.inv(Kc)

        # vectorized symmetric epipolar distances (one numpy pass over
        # all matched keypoints; only the map lookups stay per-point)
        sel_i, b1s, b2s = [], [], []
        for i, k in enumerate(kps[:n]):
            tr = self.map.tracks.get(int(curr.track_ids[k]))
            kj = tr.obs.get(kf.id) if tr else None
            if kj is None:
                continue
            sel_i.append(i)
            b1s.append(kf.bearings[kj])
            b2s.append(curr.bearings[k])
        if len(sel_i) < 40:
            return False
        b1s = np.stack(b1s)
        b2s = np.stack(b2s)
        p1 = (b1s / b1s[:, 2:3]) @ Kk.T
        p2 = (b2s / b2s[:, 2:3]) @ Kc.T
        l1 = p1 @ F.T
        l2 = p2 @ F
        d1 = np.abs(np.sum(p2 * l1, axis=1)) / np.maximum(
            np.hypot(l1[:, 0], l1[:, 1]), 1e-12)
        d2 = np.abs(np.sum(p1 * l2, axis=1)) / np.maximum(
            np.hypot(l2[:, 0], l2[:, 1]), 1e-12)
        d = d1 + d2
        m_sel = mask[np.asarray(sel_i, dtype=np.intp)]
        in_d = d[m_sel]
        out_d = d[~m_sel]
        if len(in_d) < 20 or len(out_d) < 20:
            return False
        th1 = float(np.median(in_d))
        th2 = float(np.median(out_d))
        if th2 < th1 * 2:
            return False  # ambiguous
        self.m_th = 0.5 * (th1 + th2)
        # tracker-map twin of curr (same id, same keypoint layout) so
        # the fresh per-frame verdict refreshes BOTH sides; without the
        # positive (inlier -> static) direction, one false PnP rejection
        # would ratchet a static track non-static forever through the
        # cross-propagation in update_track_status
        old_frame = None
        if self._tracker_map is not None:
            oi = self._tracker_map.frame_index_by_id(curr.id)
            if oi is not None:
                old_frame = self._tracker_map.frames[oi]
        for i, k in enumerate(kps[:n]):
            tr = self.map.tracks.get(int(curr.track_ids[k]))
            if tr is None:
                continue
            old_tr = None
            if old_frame is not None and old_frame.track_ids[k] >= 0:
                old_tr = self._tracker_map.tracks.get(int(old_frame.track_ids[k]))
            if mask[i]:
                tr.outlier = False
                tr.static = True
                if old_tr is not None:
                    old_tr.static = True
            else:
                tr.outlier = True
                if tr.static:
                    self.stats["tracks_unstatic"] += 1
                tr.static = False
                if old_tr is not None:
                    old_tr.static = False
        return True

    def update_track_status(self):
        """2D-2D essential PARSAC vs recent keyframes; tracks
        consistently flagged as outliers lose TT_STATIC, and the static
        status is cross-propagated both ways between the window track
        and the tracker-map track (reference :741-790). Note: the
        reference's final loop looks up `old_frame` (a tracker-map
        frame) inside the *window-side* track's keypoint map, which can
        never match across maps — so upstream the un-static'ing and
        propagation are inert; we implement the documented intent
        (RD-VIO paper Sec. IV-B) instead."""
        curr = self.map.frames[-1]
        n_check = self.config.parsac_keyframe_check_size
        start = max(len(self.map.frames) - 1 - n_check, 0)
        C = curr.track_ids.shape[0]
        outlier_cnt = np.zeros(C, dtype=int)
        match_cnt = np.zeros(C, dtype=int)
        # dispatch ALL per-keyframe PARSAC calls (bin confidences chain
        # on-device call to call), then fetch every mask in ONE
        # transfer instead of one blocking sync per mask
        pending = []
        for i in range(start, len(self.map.frames) - 1):
            fr = self.map.frames[i]
            p1, p2, idxs = [], [], []
            for ki in np.nonzero(fr.track_ids >= 0)[0]:
                tr = self.map.tracks.get(int(fr.track_ids[ki]))
                kj = tr.obs.get(curr.id) if tr else None
                if kj is None:
                    continue
                b1 = fr.bearings[ki]
                b2 = curr.bearings[kj]
                p1.append(b1[:2] / b1[2])
                p2.append(b2[:2] / b2[2])
                idxs.append(int(kj))
            if len(p1) < 10:
                continue
            N_CAP = 256
            nn = min(len(p1), N_CAP)
            a1 = np.zeros((N_CAP, 3))
            a1[:, 2] = 1.0
            a2 = a1.copy()
            a1[:nn, :2] = np.stack(p1)[:nn]
            a2[:nn, :2] = np.stack(p2)[:nn]
            vv = np.zeros((N_CAP,), dtype=bool)
            vv[:nn] = True
            # m_th was established by judge_track_status (track() only
            # calls us after it returns True), matching the reference's
            # filter_parsac_2d2d threshold m_th/K(0,0) (:545)
            thr = self.m_th / fr.K[0, 0]
            _, mask, _, self.bin_conf_2d2d = stereo_mod.find_essential_matrix_parsac(
                self._next_key(), jnp.asarray(a1), jnp.asarray(a2),
                self.bin_conf_2d2d, valid=jnp.asarray(vv), threshold=thr,
                norm_scale=self.config.parsac_norm_scale, n_hyp=32,
            )
            pending.append((mask, nn, idxs))
        for mask, nn, idxs in zip(fetch_packed([m for m, _, _ in pending]),
                                  [nn for _, nn, _ in pending],
                                  [ix for _, _, ix in pending]):
            mask = np.asarray(mask)
            for j in range(nn):
                match_cnt[idxs[j]] += 1
                if not mask[j]:
                    outlier_cnt[idxs[j]] += 1

        # tracker-map frame with the same id: window frames are clones,
        # so keypoint indices align 1:1
        old_frame = None
        if self._tracker_map is not None:
            oi = self._tracker_map.frame_index_by_id(curr.id)
            if oi is not None:
                old_frame = self._tracker_map.frames[oi]

        outlier_th = len(self.map.frames) // 2
        for k in np.nonzero(curr.track_ids >= 0)[0]:
            tr = self.map.tracks.get(int(curr.track_ids[k]))
            if tr is None:
                continue
            if outlier_cnt[k] > outlier_th / 2 and outlier_cnt[k] > 0.8 * match_cnt[k]:
                if tr.static:
                    self.stats["tracks_unstatic"] += 1
                tr.static = False
            # static-tag cross-propagation window <-> tracker map
            # (reference :771-789 intent)
            if old_frame is not None and old_frame.track_ids[k] >= 0:
                old_tr = self._tracker_map.tracks.get(int(old_frame.track_ids[k]))
                if old_tr is not None and (not old_tr.static or not tr.static):
                    tr.static = False
                    old_tr.static = False
