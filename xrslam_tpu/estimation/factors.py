"""Factor residuals and Jacobian blocks, vectorized over the window.

Each factor follows the reference's math exactly:
  - reprojection in the observed bearing's S² tangent frame
    (reference: estimation/ceres/reprojection_factor.h:21-50)
  - 15-dof IMU preintegration with first-order bias correction and
    body-sensor extrinsic composition
    (reference: estimation/ceres/preintegration_factor.h:20-75)
  - rotation-only bearing prior for pure-rotation subwindows
    (reference: estimation/ceres/rotation_factor.h:13-60)
  - dense marginalization prior
    (reference: estimation/ceres/marginalization_factor.h:28-73)

Jacobians are obtained by forward-mode autodiff of the residual
composed with the error-state retraction (q ⊞ δθ = q·exp(δθ)) at δ = 0
— mathematically identical to the reference's hand-derived local
Jacobians, with `jax.jacfwd` replacing 400 lines of chain rule. This is
exact, not numeric differencing.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..geometry import lie
from ..imu.preintegration import GRAVITY, PreintDelta
from .window import ES_SIZE, WindowData, WindowState, state_error


# --------------------------------------------------------------------------
# Reprojection factor
# --------------------------------------------------------------------------

def _reproj_residual_core(
    q_tgt, p_tgt, q_ref, p_ref, inv_depth,
    z_ref, local_tangent, q_bc_ref, p_bc_ref, q_bc_tgt, p_bc_tgt, sqrt_inv_cov2,
):
    """2-residual bearing reprojection (reference
    reprojection_factor.h:35-51). local_tangent columns are
    [b1 b2 z_tgt] built from the observed target bearing."""
    y_ref = z_ref / inv_depth
    y_ref_center = lie.quat_rotate(q_bc_ref, y_ref) + p_bc_ref
    x = lie.quat_rotate(q_ref, y_ref_center) + p_ref
    y_tgt_center = lie.quat_rotate_inv(q_tgt, x - p_tgt)
    y_tgt = lie.quat_rotate_inv(q_bc_tgt, y_tgt_center - p_bc_tgt)
    u = local_tangent.T @ y_tgt
    r = u[:2] / u[2]
    return sqrt_inv_cov2 @ r


def reproj_residual_jac(state: WindowState, data: WindowData,
                        mode: str = "rev"):
    """All (K,L) reprojection residuals + Jacobian blocks.

    `mode`: "rev" (2 VJP sweeps, the default) or "fwd" (13 JVP
    tangents). Reverse-mode AD produces
    WRONG Jacobians inside shard_map in JAX 0.9 (the primal is exact,
    the cotangent propagation across the manual-axes boundary is not),
    so sharded solves must pass mode="fwd" — solver.assemble does this
    automatically when given an axis_name.

    Returns (r, J_t, J_r, J_d, w_mask):
      r   (K,L,2)    weighted residuals (zeroed where masked)
      J_t (K,L,2,6)  d r / d(θ_tgt, p_tgt)
      J_r (K,L,2,6)  d r / d(θ_ref, p_ref)
      J_d (K,L,2)    d r / d inv_depth
      m   (K,L)      active-observation mask (obs valid, landmark valid,
                     tgt != ref — the anchor's own residual is identically
                     0 and excluded, matching the reference which adds
                     factors only for non-anchor observations)
    """
    K, L = data.obs_mask.shape
    ref = data.ref_idx  # (L,)

    # NaN hygiene: masked observations may hold garbage; substitute a
    # safe unit-z bearing and unit inverse depth so the (masked-out)
    # math stays finite — multiplying by the mask does not remove NaNs.
    e_z = jnp.zeros_like(data.bearings).at[..., 2].set(1.0)
    bearings = jnp.where(data.obs_mask[..., None], data.bearings, e_z)
    lm_valid = data.landmark_mask
    invd_raw = state.inv_depth
    invd = jnp.where(
        lm_valid,
        jnp.where(jnp.abs(invd_raw) < 1e-12, 1e-12, invd_raw),
        1.0,
    )

    q_ref = state.q[ref]          # (L,4)
    p_ref = state.p[ref]          # (L,3)
    q_bc_ref = data.q_bc[ref]
    p_bc_ref = data.p_bc[ref]
    z_ref = bearings[ref, jnp.arange(L)]  # (L,3) anchor bearing

    # local tangent per observation (K,L,3,3) from observed bearing
    b12 = lie.s2_tangential_basis(bearings)      # (K,L,3,2)
    local_tangent = jnp.concatenate([b12, bearings[..., None]], axis=-1)

    def per_obs(dx, q_tgt, p_tgt, q_ref, p_ref, invd, z_ref, lt, qbr, pbr, qbt, pbt, w2):
        # dx = 13 local params: θt, pt, θr, pr, d
        q_t = lie.quat_mul(q_tgt, lie.expmap(dx[0:3]))
        p_t = p_tgt + dx[3:6]
        q_r = lie.quat_mul(q_ref, lie.expmap(dx[6:9]))
        p_r = p_ref + dx[9:12]
        d = invd + dx[12]
        return _reproj_residual_core(q_t, p_t, q_r, p_r, d, z_ref, lt, qbr, pbr, qbt, pbt, w2)

    zero13 = jnp.zeros(13, dtype=state.p.dtype)

    jac = jax.jacrev if mode == "rev" else jax.jacfwd

    def obs_rj(q_tgt, p_tgt, qr, pr, invd, zr, lt, qbr, pbr, qbt, pbt, w2):
        f = lambda dx: per_obs(dx, q_tgt, p_tgt, qr, pr, invd, zr, lt,
                               qbr, pbr, qbt, pbt, w2)
        return f(zero13), jac(f)(zero13)

    # vmap over L then K
    def per_frame(q_tgt, p_tgt, qbt, pbt, w2, lts, zs_tgt_unused):
        return jax.vmap(
            lambda qr, pr, d, zr, lt, qbr, pbr: obs_rj(
                q_tgt, p_tgt, qr, pr, d, zr, lt, qbr, pbr, qbt, pbt, w2
            )
        )(q_ref, p_ref, invd, z_ref, lts, q_bc_ref, p_bc_ref)

    r, J = jax.vmap(per_frame)(
        state.q, state.p, data.q_bc, data.p_bc, data.sqrt_inv_cov2,
        local_tangent, data.bearings,
    )
    # r (K,L,2), J (K,L,2,13)
    m = data.obs_mask & data.landmark_mask[None, :] & (jnp.arange(K)[:, None] != ref[None, :])
    mf = m.astype(r.dtype)
    r = r * mf[..., None]
    J = J * mf[..., None, None]
    return r, J[..., 0:6], J[..., 6:12], J[..., 12], m


def cauchy_weights(r: jnp.ndarray, active: jnp.ndarray):
    """IRLS weights for Ceres CauchyLoss(1.0) (reference solver.cpp:36):
    ρ(s)=log(1+s), weight = sqrt(ρ'(s)) with s = ||r||². Returns
    (weights (K,L), robust cost contribution (K,L))."""
    s = jnp.sum(r * r, axis=-1)
    w = jnp.sqrt(1.0 / (1.0 + s))
    cost = 0.5 * jnp.log1p(s) * active.astype(r.dtype)
    return w, cost


# --------------------------------------------------------------------------
# Preintegration factor
# --------------------------------------------------------------------------

def _preint_residual_core(
    q_i, p_i, v_i, bg_i, ba_i, q_j, p_j, v_j, bg_j, ba_j,
    delta: PreintDelta, bg_lin, ba_lin, q_bi_i, p_bi_i, q_bi_j, p_bi_j,
):
    """15-residual preintegration error, weighted by the delta's sqrt
    information (reference preintegration_factor.h:40-75,160)."""
    g = jnp.asarray(GRAVITY, dtype=p_i.dtype)
    qi = lie.quat_mul(q_i, q_bi_i)
    pi = p_i + lie.quat_rotate(q_i, p_bi_i)
    qj = lie.quat_mul(q_j, q_bi_j)
    pj = p_j + lie.quat_rotate(q_j, p_bi_j)

    dt = delta.t
    dbg = bg_i - bg_lin
    dba = ba_i - ba_lin

    q_corr = lie.quat_mul(delta.q, lie.expmap(delta.dq_dbg @ dbg))
    r_q = lie.logmap(lie.quat_mul(lie.quat_conj(q_corr), lie.quat_mul(lie.quat_conj(qi), qj)))
    r_p = lie.quat_rotate_inv(qi, pj - pi - dt * v_i - 0.5 * dt * dt * g) - (
        delta.p + delta.dp_dbg @ dbg + delta.dp_dba @ dba
    )
    r_v = lie.quat_rotate_inv(qi, v_j - v_i - dt * g) - (
        delta.v + delta.dv_dbg @ dbg + delta.dv_dba @ dba
    )
    r = jnp.concatenate([r_q, r_p, r_v, bg_j - bg_i, ba_j - ba_i])
    return delta.sqrt_inv_cov @ r


def preint_residual_jac(state: WindowState, data: WindowData):
    """Residuals + Jacobians of all K-1 consecutive preintegration
    factors (entry j connects j-1 → j).

    Returns (r (K,15), J_i (K,15,15), J_j (K,15,15), mask (K,)); entry 0
    is zeroed.
    """
    K = state.q.shape[0]

    def per_pair(dx, qi, pi, vi, bgi, bai, qj, pj, vj, bgj, baj,
                 delta, bglin, balin, qbii, pbii, qbij, pbij):
        # dx = 30 local params (frame i 15, frame j 15)
        def app(q, p, v, bg, ba, d):
            return (
                lie.quat_mul(q, lie.expmap(d[0:3])), p + d[3:6], v + d[6:9],
                bg + d[9:12], ba + d[12:15],
            )
        si = app(qi, pi, vi, bgi, bai, dx[0:15])
        sj = app(qj, pj, vj, bgj, baj, dx[15:30])
        return _preint_residual_core(*si, *sj, delta, bglin, balin, qbii, pbii, qbij, pbij)

    zero30 = jnp.zeros(30, dtype=state.p.dtype)

    def pair_rj(args):
        r = per_pair(zero30, *args)
        J = jax.jacfwd(per_pair)(zero30, *args)
        return r, J

    idx_j = jnp.arange(K)
    idx_i = jnp.maximum(idx_j - 1, 0)
    args = (
        state.q[idx_i], state.p[idx_i], state.v[idx_i], state.bg[idx_i], state.ba[idx_i],
        state.q, state.p, state.v, state.bg, state.ba,
        data.preint, data.bg_lin, data.ba_lin,
        data.q_bi[idx_i], data.p_bi[idx_i], data.q_bi, data.p_bi,
    )
    r, J = jax.vmap(lambda *a: pair_rj(a))(*args)
    m = data.preint_mask & (idx_j > 0)
    mf = m.astype(r.dtype)
    r = r * mf[:, None]
    J = J * mf[:, None, None]
    return r, J[..., 0:15], J[..., 15:30], m


# --------------------------------------------------------------------------
# Rotation prior factor (pure-rotation subwindows)
# --------------------------------------------------------------------------

def rotation_residual_jac(state: WindowState, data: WindowData):
    """2-residual rotation-only bearing alignment per observation
    (reference rotation_factor.h:24-60): optimizes only the target
    orientation; the reference/anchor pose is read from the state but
    not differentiated.

    Returns (r (K,L,2), J_t (K,L,2,3) wrt θ_tgt, mask (K,L)).
    """
    K, L = data.obs_mask.shape
    ref = data.ref_idx
    e_z = jnp.zeros_like(data.bearings).at[..., 2].set(1.0)
    bearings = jnp.where(data.obs_mask[..., None], data.bearings, e_z)
    q_ref = state.q[ref]
    q_bc_ref = data.q_bc[ref]
    p_bc_ref = data.p_bc[ref]
    z_ref = bearings[ref, jnp.arange(L)]

    b12 = lie.s2_tangential_basis(bearings)
    local_tangent = jnp.concatenate([b12, bearings[..., None]], axis=-1)

    def core(q_tgt, qr, zr, lt, qbr, pbr, qbt, pbt, w2):
        z_ref_center = lie.quat_rotate(qbr, zr) + pbr
        z_tgt_center = lie.quat_rotate_inv(q_tgt, lie.quat_rotate(qr, z_ref_center))
        z_tgt = lie.quat_rotate_inv(qbt, z_tgt_center - pbt)
        u = lt.T @ z_tgt
        return w2 @ (u[:2] / u[2])

    def per_obs(dtheta, q_tgt, qr, zr, lt, qbr, pbr, qbt, pbt, w2):
        return core(lie.quat_mul(q_tgt, lie.expmap(dtheta)), qr, zr, lt, qbr, pbr, qbt, pbt, w2)

    zero3 = jnp.zeros(3, dtype=state.p.dtype)

    def obs_rj(q_tgt, qr, zr, lt, qbr, pbr, qbt, pbt, w2):
        r = per_obs(zero3, q_tgt, qr, zr, lt, qbr, pbr, qbt, pbt, w2)
        J = jax.jacfwd(per_obs)(zero3, q_tgt, qr, zr, lt, qbr, pbr, qbt, pbt, w2)
        return r, J

    def per_frame(q_tgt, qbt, pbt, w2, lts):
        return jax.vmap(lambda qr, zr, lt, qbr, pbr: obs_rj(q_tgt, qr, zr, lt, qbr, pbr, qbt, pbt, w2))(
            q_ref, z_ref, lts, q_bc_ref, p_bc_ref
        )

    r, J = jax.vmap(per_frame)(state.q, data.q_bc, data.p_bc, data.sqrt_inv_cov2, local_tangent)
    m = data.obs_mask & data.landmark_mask[None, :] & (jnp.arange(K)[:, None] != ref[None, :])
    mf = m.astype(r.dtype)
    return r * mf[..., None], J * mf[..., None, None], m


# --------------------------------------------------------------------------
# Marginalization prior factor
# --------------------------------------------------------------------------

def marg_residual_jac(state: WindowState, data: WindowData):
    """Residual (K*15,) and Jacobian (K*15, K*15) of the dense prior
    (reference marginalization_factor.h:28-73): r = U·e + iv with the
    q-block local Jacobian Jr(e_q)⁻¹."""
    K = state.q.shape[0]
    e = state_error(state, data.marg.lin)  # (K,15)
    U = data.marg.sqrt_inv_cov
    r = U @ e.reshape(-1) + data.marg.infovec

    # D = blockdiag over frames of diag(Jr(e_q)^-1, I_12)
    Jr_inv = lie.right_jacobian_inv(e[:, 0:3])  # (K,3,3)
    eye12 = jnp.eye(ES_SIZE - 3, dtype=U.dtype)
    Dk = jnp.zeros((K, ES_SIZE, ES_SIZE), dtype=U.dtype)
    Dk = Dk.at[:, 0:3, 0:3].set(Jr_inv)
    Dk = Dk.at[:, 3:, 3:].set(eye12)
    D = jnp.einsum("kab,km->kamb", Dk, jnp.eye(K, dtype=U.dtype))
    J = U @ D.reshape(K * ES_SIZE, K * ES_SIZE)
    active = data.use_marg
    mf = active.astype(r.dtype)
    return r * mf, J * mf, active
