"""Batched Gauss-Newton/Levenberg-Marquardt solver with explicit Schur
complement over landmarks.

Replaces the reference's Ceres facade (reference:
xrslam/src/xrslam/estimation/solver.cpp:176-190 — SPARSE_SCHUR +
DOGLEG, Cauchy(1.0) robust loss, ≤`iteration_limit` iterations) with a
fixed-iteration LM loop on fixed-shape window arrays:

  1. residuals + Jacobian blocks per factor class (factors.py),
  2. dense frame Hessian H (K·15 × K·15) + landmark diagonal assembled
     with one-hot scatter einsums (no dynamic indexing),
  3. scalar Schur elimination of inverse-depth landmarks — the same
     reduction Ceres' SPARSE_SCHUR performs, and the same math as the
     reference's hand-rolled LandmarkInfo elimination
     (ceres/marginalization_factor.h:382-397),
  4. damped dense solve of the reduced camera system + back-substitution,
  5. accept/reject trust-region step with multiplicative damping.

Everything is jit-compilable with static (K, L, iterations); the same
machinery serves `refine_window`, `refine_subwindow`,
`localize_newframe`, the initializer's vision-only BA, and (sharded)
multi-device BA.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from . import factors
from .window import ES_SIZE, WindowData, WindowState, retract


@dataclass(frozen=True)
class SolveOptions:
    iterations: int = 10
    use_reproj: bool = True
    use_preint: bool = True
    use_rotation: bool = False   # rotation-only subwindow mode
    lm_init: float = 1e-4
    lm_up: float = 10.0
    lm_down: float = 0.5
    lm_min: float = 1e-10
    lm_max: float = 1e10


def _free_masks(data: WindowData, dtype):
    """Per-entry free masks: (K,15) frame entries, (L,) landmarks."""
    K = data.frame_mask.shape[0]
    pose_free = data.frame_mask & ~data.fix_pose
    motion_free = data.frame_mask & ~data.fix_motion
    idx = jnp.arange(ES_SIZE)
    f = jnp.where(
        idx[None, :] < 6, pose_free[:, None], motion_free[:, None]
    ).astype(dtype)
    flm = (data.landmark_mask & ~data.fix_landmark).astype(dtype)
    return f, flm


def assemble(state: WindowState, data: WindowData, opts: SolveOptions,
             axis_name=None):
    """Build the GN normal equations.

    Returns (H (K,15,K,15), b (K,15), Hll (L,), Hfl (K,15,L), bl (L,),
    cost ()) — with fixed/masked entries eliminated (zero rows/cols,
    unit diagonal).

    With `axis_name` set (inside shard_map over landmark columns — the
    distributed-Schur sharding of SURVEY.md §2.3), the landmark-indexed
    inputs are the local shard; the frame-block H/b/cost are psum-reduced
    over the mesh axis while Hll/Hfl/bl stay local to the shard.
    """
    K = state.q.shape[0]
    L = state.inv_depth.shape[0]
    dt = state.p.dtype

    H = jnp.zeros((K, ES_SIZE, K, ES_SIZE), dtype=dt)
    b = jnp.zeros((K, ES_SIZE), dtype=dt)
    Hll = jnp.zeros((L,), dtype=dt)
    Hfl = jnp.zeros((K, ES_SIZE, L), dtype=dt)
    bl = jnp.zeros((L,), dtype=dt)
    cost = jnp.zeros((), dtype=dt)

    R1 = jax.nn.one_hot(data.ref_idx, K, dtype=dt) * data.landmark_mask[:, None].astype(dt)

    if opts.use_reproj:
        # reverse-mode Jacobians are broken inside shard_map (JAX 0.9,
        # see factors.reproj_residual_jac) → forward mode when sharded
        r, Jt, Jr6, Jd, m = factors.reproj_residual_jac(
            state, data, mode="rev" if axis_name is None else "fwd")
        w, c = factors.cauchy_weights(r, m)
        cost = cost + jnp.sum(c)
        wf = w[..., None]
        r = r * wf
        Jt = Jt * wf[..., None]
        Jr6 = Jr6 * wf[..., None]
        Jd = Jd * wf

        # pose-block (6-dim, offset 0) contributions
        P = jnp.zeros((K, 6, K, 6), dtype=dt)
        eyeK = jnp.eye(K, dtype=dt)
        P = P + jnp.einsum("klri,klrj,km->kimj", Jt, Jt, eyeK)
        Htr = jnp.einsum("klri,klrj,lm->kimj", Jt, Jr6, R1)
        P = P + Htr + jnp.transpose(Htr, (2, 3, 0, 1))
        P = P + jnp.einsum("klri,klrj,lm,ln->minj", Jr6, Jr6, R1, R1)
        H = H.at[:, 0:6, :, 0:6].add(P)

        b = b.at[:, 0:6].add(
            jnp.einsum("klri,klr->ki", Jt, r) + jnp.einsum("klri,klr,lm->mi", Jr6, r, R1)
        )
        Hfl = Hfl.at[:, 0:6, :].add(
            jnp.einsum("klri,klr->kil", Jt, Jd) + jnp.einsum("klri,klr,lm->mil", Jr6, Jd, R1)
        )
        Hll = Hll + jnp.einsum("klr,klr->l", Jd, Jd)
        bl = bl + jnp.einsum("klr,klr->l", Jd, r)

    if opts.use_rotation:
        r, Jq, m = factors.rotation_residual_jac(state, data)
        w, c = factors.cauchy_weights(r, m)
        cost = cost + jnp.sum(c)
        r = r * w[..., None]
        Jq = Jq * w[..., None, None]
        H = H.at[:, 0:3, :, 0:3].add(
            jnp.einsum("klri,klrj,km->kimj", Jq, Jq, jnp.eye(K, dtype=dt))
        )
        b = b.at[:, 0:3].add(jnp.einsum("klri,klr->ki", Jq, r))

    # --- shard boundary: everything above is landmark-indexed (local
    # shard); reduce the frame-block system over the landmark axis.
    # preint/marg below are frame-only and computed replicated.
    if axis_name is not None:
        H = jax.lax.psum(H, axis_name)
        b = jax.lax.psum(b, axis_name)
        cost = jax.lax.psum(cost, axis_name)

    if opts.use_preint:
        rp, Ji, Jj, mp = factors.preint_residual_jac(state, data)
        cost = cost + 0.5 * jnp.sum(rp * rp)
        idx_j = jnp.arange(K)
        oh_j = jnp.eye(K, dtype=dt)
        oh_i = jax.nn.one_hot(jnp.maximum(idx_j - 1, 0), K, dtype=dt)
        for Ja, oha in ((Ji, oh_i), (Jj, oh_j)):
            b = b + jnp.einsum("nra,nr,nk->ka", Ja, rp, oha)
            for Jb, ohb in ((Ji, oh_i), (Jj, oh_j)):
                H = H + jnp.einsum("nra,nrb,nk,nm->kamb", Ja, Jb, oha, ohb)

    # marginalization prior (always assembled; zero when inactive)
    rm, Jm, _ = factors.marg_residual_jac(state, data)
    cost = cost + 0.5 * jnp.sum(rm * rm)
    KM = K * ES_SIZE
    H = H + (Jm.T @ Jm).reshape(K, ES_SIZE, K, ES_SIZE)
    b = b + (Jm.T @ rm).reshape(K, ES_SIZE)

    # eliminate fixed/invalid entries
    f, flm = _free_masks(data, dt)
    H = H * f[:, :, None, None] * f[None, None, :, :]
    Hd = H.reshape(KM, KM)
    Hd = Hd + jnp.diag(1.0 - f.reshape(-1))
    # free entries no factor touches (e.g. positions in rotation-only
    # solves — the reference leaves such Ceres blocks without residuals,
    # i.e. constant) get a unit diagonal so the solve stays nonsingular
    # and their update is exactly zero
    zero_info = (jnp.diag(Hd) < 1e-12) & (f.reshape(-1) > 0)
    Hd = Hd + jnp.diag(zero_info.astype(dt))
    H = Hd.reshape(K, ES_SIZE, K, ES_SIZE)
    b = b * f
    # landmarks with no effective observations are frozen too
    flm = flm * (Hll > 1e-12).astype(dt)
    Hfl = Hfl * f[:, :, None] * flm[None, None, :]
    Hll = jnp.where(flm > 0, Hll, 1.0)
    bl = bl * flm

    return H, b, Hll, Hfl, bl, cost


def compute_cost(state: WindowState, data: WindowData, opts: SolveOptions,
                 axis_name=None) -> jnp.ndarray:
    """Total robustified cost (no Jacobians)."""
    cost = jnp.zeros((), dtype=state.p.dtype)
    if opts.use_reproj:
        r, _, _, _, m = factors.reproj_residual_jac(state, data)
        _, c = factors.cauchy_weights(r, m)
        cost = cost + jnp.sum(c)
    if opts.use_rotation:
        r, _, m = factors.rotation_residual_jac(state, data)
        _, c = factors.cauchy_weights(r, m)
        cost = cost + jnp.sum(c)
    if axis_name is not None:
        cost = jax.lax.psum(cost, axis_name)
    if opts.use_preint:
        rp, _, _, _ = factors.preint_residual_jac(state, data)
        cost = cost + 0.5 * jnp.sum(rp * rp)
    rm, _, _ = factors.marg_residual_jac(state, data)
    cost = cost + 0.5 * jnp.sum(rm * rm)
    return cost


def _solve_from(sys, state: WindowState, opts: SolveOptions, lam,
                axis_name=None) -> WindowState:
    """One damped-GN step from an already-assembled system: Schur-
    eliminate landmarks, solve the reduced camera system, back-
    substitute, retract. Returns the candidate state.

    Sharded mode (`axis_name`): the Schur complement's landmark
    reduction Hfl·Hll⁻¹·Hflᵀ is computed per landmark shard and
    psum-reduced — the distributed SPARSE_SCHUR of SURVEY.md §2.3; the
    reduced (K·15)² camera solve is replicated (it is tiny), and the
    landmark back-substitution stays shard-local."""
    H, b, Hll, Hfl, bl, _cost = sys
    K = state.q.shape[0]
    KM = K * ES_SIZE

    Hd = H.reshape(KM, KM)
    Hfl2 = Hfl.reshape(KM, -1)

    # LM damping on both frame and landmark diagonals
    Hd = Hd + lam * jnp.diag(jnp.diag(Hd))
    Hll_d = Hll * (1.0 + lam)

    # Schur complement over landmarks: S = Hff − Hfl Hll⁻¹ Hflᵀ
    inv_Hll = 1.0 / Hll_d
    S_lm = (Hfl2 * inv_Hll[None, :]) @ Hfl2.T
    rhs_lm = Hfl2 @ (inv_Hll * bl)
    if axis_name is not None:
        S_lm = jax.lax.psum(S_lm, axis_name)
        rhs_lm = jax.lax.psum(rhs_lm, axis_name)
    S = Hd - S_lm
    rhs = -(b.reshape(-1) - rhs_lm)

    # dense solve of the reduced camera system (small: K·15 ≤ ~200).
    # Jacobi column scaling first: the 1e15 gauge prior (reference
    # estimation/marginalization_factor.h:31-32) puts ~1e30 on some
    # diagonal entries, and an unscaled Cholesky at that conditioning
    # returns garbage steps — the same Jacobian scaling Ceres applies.
    d = jax.lax.rsqrt(jnp.clip(jnp.diag(S), 1e-30, None))
    Sn = S * d[:, None] * d[None, :]
    # Cholesky (assume_a="pos") of the Jacobi-scaled SPD system
    df = d * jax.scipy.linalg.solve(Sn, d * rhs, assume_a="pos")
    dl = -(bl + Hfl2.T @ df) * inv_Hll

    return retract(state, df.reshape(K, ES_SIZE), dl)


def _lm_step(state: WindowState, data: WindowData, opts: SolveOptions, lam,
             axis_name=None):
    """One damped-GN step: assemble + _solve_from. Returns
    (candidate_state, cost_at_state). Kept for tests/direct use; the
    LM loop in solve_window_core uses the one-assemble-per-iteration
    deferred accept/reject form instead."""
    sys = assemble(state, data, opts, axis_name)
    return _solve_from(sys, state, opts, lam, axis_name), sys[5]


def solve_window_core(
    state: WindowState, data: WindowData, opts: SolveOptions = SolveOptions(),
    axis_name=None,
):
    """LM loop with deferred accept/reject: exactly ONE system assembly
    (residuals + Jacobians + cost) per iteration. The candidate from
    iteration i is evaluated by iteration i+1's assembly; on rejection
    the previously accepted system is reused with a larger damping —
    the classic LM bookkeeping, and half the work of the naive
    assemble-then-recost loop.

    `axis_name` enables the landmark-sharded mode (see _solve_from);
    pass it when calling from inside shard_map
    (xrslam_tpu.parallel.sharded)."""
    sys0 = assemble(state, data, opts, axis_name)
    cost0 = sys0[5]
    # 0·cost0 ties lam0's varying-axes type to the data (needed when a
    # shard_map'd batch axis makes the scan carry axis-varying)
    lam0 = jnp.asarray(opts.lm_init, dtype=state.p.dtype) + 0.0 * cost0
    cand0 = _solve_from(sys0, state, opts, lam0, axis_name)

    def body(carry, _):
        st_best, cost_best, sys_best, lam, st_cand = carry
        sys_cand = assemble(st_cand, data, opts, axis_name)
        cost_cand = sys_cand[5]
        good = jnp.isfinite(cost_cand) & (cost_cand < cost_best)
        sel = lambda a, c: jnp.where(good, c, a)
        st_base = jax.tree.map(sel, st_best, st_cand)
        sys_base = jax.tree.map(sel, sys_best, sys_cand)
        cost_base = jnp.where(good, cost_cand, cost_best)
        lam_next = jnp.clip(
            jnp.where(good, lam * opts.lm_down, lam * opts.lm_up),
            opts.lm_min, opts.lm_max,
        )
        st_next = _solve_from(sys_base, st_base, opts, lam_next, axis_name)
        return (st_base, cost_base, sys_base, lam_next, st_next), cost_base

    (state, cost, _, lam, _), cost_hist = jax.lax.scan(
        body, (state, cost0, sys0, lam0, cand0), None, length=opts.iterations
    )
    return state, {"cost0": cost0, "cost": cost, "cost_history": cost_hist, "lambda": lam}


@partial(jax.jit, static_argnames=("opts1", "opts2"))
def solve_chained_batch(states1, datas1, opts1, states2, datas2, opts2,
                        slots):
    """Data-parallel solve_chained over N sequences: takes TUPLES of
    per-sequence (state, data) pytrees and stacks them IN-PROGRAM —
    stacking ~45 leaves x N outside the jit would cost hundreds of
    separate dispatches. One dispatch runs every sequence's fused
    localize+refine subframe solve on the data axis (tools/multiseq.py,
    SURVEY §2.3 data-parallel row; single-chip limit of sharding the
    same axis over a mesh). `slots` is an int32 (N,) array of target
    slots. Returns a tuple of N solved subwindow states."""
    st1 = jax.tree.map(lambda *xs: jnp.stack(xs), *states1)
    d1 = jax.tree.map(lambda *xs: jnp.stack(xs), *datas1)
    st2 = jax.tree.map(lambda *xs: jnp.stack(xs), *states2)
    d2 = jax.tree.map(lambda *xs: jnp.stack(xs), *datas2)

    def one(a, b, c, d, s):
        return _solve_chained_core(a, b, opts1, c, d, opts2, s, s)

    _, out2, _ = jax.vmap(one)(st1, d1, st2, d2, slots)
    return tuple(jax.tree.map(lambda x, i=i: x[i], out2)
                 for i in range(len(states1)))


@partial(jax.jit, static_argnames=("opts1", "opts2"))
def solve_chained(state1: WindowState, data1: WindowData, opts1: SolveOptions,
                  state2: WindowState, data2: WindowData, opts2: SolveOptions,
                  s1, s2):
    """Two window solves in ONE device program: solve window 1 (the
    new-frame localization), inject its frame-`s1` state into window
    2's slot `s2`, solve window 2 (the subwindow refine). This is the
    subframe path of SlidingWindowTracker.track() fused to a single
    dispatch + a single fetch. s1/s2 are traced scalars so
    varying window sizes reuse one executable."""
    return _solve_chained_core(state1, data1, opts1, state2, data2, opts2,
                               s1, s2)


def _solve_chained_core(state1, data1, opts1, state2, data2, opts2, s1, s2):
    st1, _ = solve_window_core(state1, data1, opts1)

    def put(dst, src):
        row = jax.lax.dynamic_index_in_dim(src, s1, axis=0, keepdims=True)
        zero = jnp.zeros((), dtype=jnp.asarray(s2).dtype)  # match index dtypes
        return jax.lax.dynamic_update_slice(
            dst, row.astype(dst.dtype), (s2,) + (zero,) * (dst.ndim - 1))

    state2 = state2._replace(
        q=put(state2.q, st1.q), p=put(state2.p, st1.p),
        v=put(state2.v, st1.v), bg=put(state2.bg, st1.bg),
        ba=put(state2.ba, st1.ba))
    st2, info2 = solve_window_core(state2, data2, opts2)
    return st1, st2, info2


@partial(jax.jit, static_argnames=("opts1", "opts2"))
def solve_keyframe_chain(state1: WindowState, data1: WindowData,
                         opts1: SolveOptions,
                         state2: WindowState, data2: WindowData,
                         opts2: SolveOptions,
                         s1, s2, inject, cand, fuv):
    """The ENTIRE keyframe backend step as one device program
    (reference SlidingWindowTracker::track keyframe branch,
    sliding_window_tracker.cpp:82-117):

      1. localize the new frame (window 1; reference :119-143),
      2. inject its solved frame-`s1` state into the full window's
         slot `s2` (skipped when `inject` is false — the lifted-
         subframe cases where the target is not a window slot),
      3. triangulate the new keyframe's candidate landmarks in-program
         (`cand` mask; replaces the host track_landmark, :225-245),
      4. full-window VI-BA over window 2 with the newly triangulated
         landmarks participating (:247-358),
      5. landmark depth/RPE re-validation gates (:325-352).

    Returns (st1, st2, (gate_ok, mean_rpe), tri_ok, tri_invd). The
    host applies flags one frame later from the deferred write-back —
    no blocking fetch anywhere in the keyframe step."""
    from .triangulate import triangulate_landmarks

    st1, _ = solve_window_core(state1, data1, opts1)

    def put(dst, src):
        row = jax.lax.dynamic_index_in_dim(src, s1, axis=0, keepdims=True)
        zero = jnp.zeros((), dtype=jnp.asarray(s2).dtype)
        upd = jax.lax.dynamic_update_slice(
            dst, row.astype(dst.dtype), (s2,) + (zero,) * (dst.ndim - 1))
        return jnp.where(inject, upd, dst)

    state2 = state2._replace(
        q=put(state2.q, st1.q), p=put(state2.p, st1.p),
        v=put(state2.v, st1.v), bg=put(state2.bg, st1.bg),
        ba=put(state2.ba, st1.ba))

    tri_invd, tri_ok = triangulate_landmarks(state2, data2, cand)
    state2 = state2._replace(
        inv_depth=jnp.where(tri_ok, tri_invd, state2.inv_depth))
    data2 = data2._replace(landmark_mask=data2.landmark_mask | tri_ok)

    st2, _ = solve_window_core(state2, data2, opts2)
    gates = landmark_gates_core(st2, data2, fuv)
    return st1, st2, gates, tri_ok


@jax.jit
def landmark_gates(state: WindowState, data: WindowData, fuv: jnp.ndarray):
    """Jitted standalone entry of landmark_gates_core."""
    return landmark_gates_core(state, data, fuv)


def landmark_gates_core(state: WindowState, data: WindowData,
                        fuv: jnp.ndarray):
    """Post-solve landmark re-validation, on device (reference
    sliding_window_tracker.cpp:325-352 runs the same depth/RPE gates as
    a host loop over every track; at 256 landmark slots the host loop
    costs ~90 ms/keyframe on a 2-CPU host while this is one fused
    kernel fetched with the solve results).

    fuv: (K,2) per-frame focal lengths (fu, fv).
    Returns (ok (L,) bool, mean_rpe (L,) px): depth at every observing
    window frame in (1e-3, 50] and mean reprojection error < 3 px.
    """
    from ..geometry import lie

    q_wc = jax.vmap(lie.quat_mul)(state.q, data.q_bc)
    p_wc = state.p + jax.vmap(lie.quat_rotate)(state.q, data.p_bc)
    L = state.inv_depth.shape[0]
    bref = jnp.take_along_axis(
        data.bearings, data.ref_idx[None, :, None], axis=0)[0]  # (L,3)
    q_ref = q_wc[data.ref_idx]
    p_ref = p_wc[data.ref_idx]
    d = jnp.maximum(state.inv_depth, 1e-9)
    p_w = jax.vmap(lie.quat_rotate)(q_ref, bref / d[:, None]) + p_ref  # (L,3)

    rel = p_w[None, :, :] - p_wc[:, None, :]                  # (K,L,3)
    y = jax.vmap(jax.vmap(lie.quat_rotate_inv, in_axes=(None, 0)))(q_wc, rel)
    m = data.obs_mask & data.landmark_mask[None, :]
    z = jnp.where(jnp.abs(y[..., 2]) > 1e-12, y[..., 2], 1e-12)
    b = data.bearings
    bz = jnp.where(jnp.abs(b[..., 2]) > 1e-12, b[..., 2], 1e-12)
    du = (y[..., 0] / z - b[..., 0] / bz) * fuv[:, None, 0]
    dv = (y[..., 1] / z - b[..., 1] / bz) * fuv[:, None, 1]
    rpe = jnp.hypot(du, dv)
    cnt = jnp.sum(m, axis=0)
    mean_rpe = jnp.sum(jnp.where(m, rpe, 0.0), axis=0) / jnp.maximum(cnt, 1)
    depth_ok = jnp.all(jnp.where(m, (y[..., 2] > 1.0e-3) & (y[..., 2] <= 50.0),
                                 True), axis=0)
    ok = depth_ok & (mean_rpe < 3.0)
    return ok, mean_rpe


@partial(jax.jit, static_argnames=("opts",))
def solve_window(
    state: WindowState, data: WindowData, opts: SolveOptions = SolveOptions()
):
    """Single-device jitted solve (the (shapes, opts) pair keys the
    executable cache, so every same-shape solve — each pipeline step,
    each test — reuses one compilation).

    Returns (state, info dict with cost trajectory).
    """
    return solve_window_core(state, data, opts)
