"""Sliding-window marginalization: fold the victim frame (and the
landmarks it anchors into) into a dense prior over the remaining frames.

Reproduces the reference's algorithm exactly (reference:
xrslam/src/xrslam/estimation/ceres/marginalization_factor.h:74-469):

  information is accumulated from
    (a) the existing prior factor evaluated at current states (:105-160),
    (b) the preintegration factors adjacent to the victim (:163-231),
    (c) the *unweighted* reprojection factors of every track observed by
        the victim whose anchor is a keyframe (:233-379) — note: no
        Cauchy loss here, matching the reference's raw Evaluate calls;
  then landmark inverse-depths are Schur-eliminated scalar-wise
  (:382-397), the victim's 15×15 block is Schur-eliminated (:400-434),
  and the result is eigendecomposed with eigenvalues clamped at 1e-8 to
  produce the new (sqrt_inv_cov, infovec) pair (:437-452); linearization
  points are the current states of the remaining frames (:455-466).

Array form: everything is computed on the fixed-shape (K, L)
window arrays with masks; the frame shift (victim slot removed, arrays
rolled left) happens here so the pipeline's array layout stays
"slot 0 = oldest frame".
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import factors
from .window import ES_SIZE, MargPrior, WindowData, WindowState


def _roll_state(state: WindowState, victim: int) -> WindowState:
    """Remove frame slot `victim`, shift later frames left, keep last
    slot as a (inert) copy of the previous last."""
    K = state.q.shape[0]
    perm = list(range(victim)) + list(range(victim + 1, K)) + [K - 1]
    idx = jnp.asarray(perm)
    return WindowState(
        q=state.q[idx], p=state.p[idx], v=state.v[idx],
        bg=state.bg[idx], ba=state.ba[idx], inv_depth=state.inv_depth,
    )


@partial(jax.jit, static_argnames=("victim", "eig_clamp"))
def marginalize_frame(
    state: WindowState, data: WindowData, victim: int = 0, eig_clamp: float = 1.0e-8
) -> MargPrior:
    """Compute the new marginalization prior after removing `victim`.

    The returned prior's arrays are already shifted to the post-slide
    slot layout (old slot i>victim → new slot i-1); its last slot is
    inactive (zero rows/cols).
    """
    K = state.q.shape[0]
    KM = K * ES_SIZE
    dt = state.p.dtype

    H = jnp.zeros((KM, KM), dtype=dt)
    b = jnp.zeros((KM,), dtype=dt)

    # (a) existing prior at current states
    rm, Jm, _ = factors.marg_residual_jac(state, data)
    H = H + Jm.T @ Jm
    b = b + Jm.T @ rm

    # (b) preintegration factors adjacent to the victim: j = victim and
    # victim+1 (j indexes the factor connecting j-1 → j; j=0 invalid)
    rp, Ji, Jj, mp = factors.preint_residual_jac(state, data)
    adj = jnp.zeros((K,), dtype=bool)
    if victim >= 1:
        adj = adj.at[victim].set(True)
    if victim + 1 < K:
        adj = adj.at[victim + 1].set(True)
    sel = (adj & mp).astype(dt)
    rp = rp * sel[:, None]
    Ji = Ji * sel[:, None, None]
    Jj = Jj * sel[:, None, None]
    idx_j = jnp.arange(K)
    oh_j = jnp.eye(K, dtype=dt)
    oh_i = jax.nn.one_hot(jnp.maximum(idx_j - 1, 0), K, dtype=dt)
    Hb = jnp.zeros((K, ES_SIZE, K, ES_SIZE), dtype=dt)
    bb = jnp.zeros((K, ES_SIZE), dtype=dt)
    for Ja, oha in ((Ji, oh_i), (Jj, oh_j)):
        bb = bb + jnp.einsum("nra,nr,nk->ka", Ja, rp, oha)
        for Jb, ohb in ((Ji, oh_i), (Jj, oh_j)):
            Hb = Hb + jnp.einsum("nra,nrb,nk,nm->kamb", Ja, Jb, oha, ohb)
    H = H + Hb.reshape(KM, KM)
    b = b + bb.reshape(-1)

    # (c) unweighted reprojection factors of tracks observed by the
    # victim, with scalar landmark Schur elimination
    r, Jt, Jr6, Jd, m = factors.reproj_residual_jac(state, data)
    lm_sel = (data.obs_mask[victim] & data.landmark_mask).astype(dt)  # (L,)
    msel = m.astype(dt) * lm_sel[None, :]
    r = r * msel[..., None]
    Jt = Jt * msel[..., None, None]
    Jr6 = Jr6 * msel[..., None, None]
    Jd = Jd * msel[..., None]

    R1 = jax.nn.one_hot(data.ref_idx, K, dtype=dt) * data.landmark_mask[:, None].astype(dt)
    eyeK = jnp.eye(K, dtype=dt)
    P = jnp.einsum("klri,klrj,km->kimj", Jt, Jt, eyeK)
    Htr = jnp.einsum("klri,klrj,lm->kimj", Jt, Jr6, R1)
    P = P + Htr + jnp.transpose(Htr, (2, 3, 0, 1))
    P = P + jnp.einsum("klri,klrj,lm,ln->minj", Jr6, Jr6, R1, R1)
    bp = jnp.einsum("klri,klr->ki", Jt, r) + jnp.einsum("klri,klr,lm->mi", Jr6, r, R1)
    Hfl = jnp.einsum("klri,klr->kil", Jt, Jd) + jnp.einsum("klri,klr,lm->mil", Jr6, Jd, R1)
    Hll = jnp.einsum("klr,klr->l", Jd, Jd)
    bl = jnp.einsum("klr,klr->l", Jd, r)

    # scalar landmark Schur (reference LandmarkInfo, :382-397); guard the
    # 1/mat like the reference's isfinite check
    inv_Hll = jnp.where(Hll > 1e-12, 1.0 / jnp.where(Hll > 0, Hll, 1.0), 0.0)
    P = P - jnp.einsum("kil,l,mjl->kimj", Hfl, inv_Hll, Hfl)
    bp = bp - jnp.einsum("kil,l,l->ki", Hfl, inv_Hll, bl)

    Hp = jnp.zeros((K, ES_SIZE, K, ES_SIZE), dtype=dt).at[:, 0:6, :, 0:6].set(P)
    bpf = jnp.zeros((K, ES_SIZE), dtype=dt).at[:, 0:6].set(bp)
    H = H + Hp.reshape(KM, KM)
    b = b + bpf.reshape(-1)

    # ---- Schur-eliminate the victim frame's 15×15 block (:400-434) ----
    v0 = victim * ES_SIZE
    Hvv = jax.lax.dynamic_slice(H, (v0, v0), (ES_SIZE, ES_SIZE))
    Hv_row = jax.lax.dynamic_slice(H, (v0, 0), (ES_SIZE, KM))
    Hv_col = jax.lax.dynamic_slice(H, (0, v0), (KM, ES_SIZE))
    bv = jax.lax.dynamic_slice(b, (v0,), (ES_SIZE,))
    Hvv_inv = jnp.linalg.inv(Hvv)
    H = H - Hv_col @ Hvv_inv @ Hv_row
    b = b - Hv_col @ (Hvv_inv @ bv)

    # zero the victim rows/cols and shift remaining blocks left
    keep = jnp.ones((K,), dtype=bool).at[victim].set(False)
    keepv = jnp.repeat(keep, ES_SIZE).astype(dt)
    H = H * keepv[:, None] * keepv[None, :]
    b = b * keepv

    perm = list(range(victim)) + list(range(victim + 1, K)) + [victim]
    pidx = jnp.repeat(jnp.asarray(perm) * ES_SIZE, ES_SIZE) + jnp.tile(
        jnp.arange(ES_SIZE), K
    )
    H = H[pidx][:, pidx]
    b = b[pidx]
    # inactivate the (now-last) vacated slot
    lastv = jnp.ones((KM,), dtype=dt).at[(K - 1) * ES_SIZE:].set(0.0)
    H = H * lastv[:, None] * lastv[None, :]
    b = b * lastv

    # also drop rows/cols of frames that were never valid
    fm = _roll_mask(data.frame_mask, victim)
    fmv = jnp.repeat(fm, ES_SIZE).astype(dt)
    H = H * fmv[:, None] * fmv[None, :]
    b = b * fmv

    # ---- eigendecompose, clamp, form sqrt info + infovec (:437-452) ----
    H = 0.5 * (H + H.T)
    lam, V = jnp.linalg.eigh(H)
    pos = lam > eig_clamp
    lam_c = jnp.where(pos, lam, 0.0)
    lam_inv = jnp.where(pos, 1.0 / jnp.where(pos, lam, 1.0), 0.0)
    U = jnp.sqrt(lam_c)[:, None] * V.T
    iv = jnp.sqrt(lam_inv)[:, None] * V.T @ b

    return MargPrior(sqrt_inv_cov=U, infovec=iv, lin=_roll_state(state, victim))


def _roll_mask(mask: jnp.ndarray, victim: int) -> jnp.ndarray:
    K = mask.shape[0]
    perm = list(range(victim)) + list(range(victim + 1, K)) + [K - 1]
    return mask[jnp.asarray(perm)].at[K - 1].set(False)


def landmark_world_points(state: WindowState, data: WindowData) -> jnp.ndarray:
    """World positions of all landmarks from their anchored inverse
    depths (reference map/track.cpp:90-101 get_landmark_point)."""
    from ..geometry import lie

    L = state.inv_depth.shape[0]
    ref = data.ref_idx
    z_ref = data.bearings[ref, jnp.arange(L)]
    invd = jnp.where(jnp.abs(state.inv_depth) < 1e-12, 1e-12, state.inv_depth)
    y_c = z_ref / invd[:, None]
    y_b = lie.quat_rotate(data.q_bc[ref], y_c) + data.p_bc[ref]
    return lie.quat_rotate(state.q[ref], y_b) + state.p[ref]


@partial(jax.jit, static_argnames=("victim",))
def slide_window(
    state: WindowState, data: WindowData, new_prior: MargPrior, victim: int = 0
):
    """Shift window arrays after marginalizing `victim`:
      - frames roll left (slot i>victim → i-1); last slot inert,
      - the victim's observation row is dropped,
      - landmarks anchored at the victim re-anchor to their next
        observing frame with inverse depth recomputed from the current
        estimate (reference Map::marginalize_frame →
        Track::remove_keypoint re-anchoring, map/track.cpp:16-44),
      - landmarks left with <2 observations are invalidated,
      - preintegration entries shift (the victim's outgoing preint
        disappears; slot-0 factor masked off),
      - the new prior is installed.

    Returns (state, data) in post-slide layout. The vacated last frame
    slot is inert (frame_mask False) — the pipeline writes the next
    frame into it.
    """
    from ..geometry import lie

    K = state.q.shape[0]
    L = state.inv_depth.shape[0]
    perm = jnp.asarray(list(range(victim)) + list(range(victim + 1, K)) + [K - 1])

    # world points before any reshuffle (uses old anchors)
    x_w = landmark_world_points(state, data)

    # --- shift frame-indexed arrays ---
    state2 = _roll_state(state, victim)
    obs_mask = data.obs_mask[perm].at[K - 1].set(False)
    bearings = data.bearings[perm]
    frame_mask = _roll_mask(data.frame_mask, victim)

    # --- landmark anchoring in the new layout ---
    old_ref = data.ref_idx
    # first observing frame in the new layout
    first_obs = jnp.argmax(obs_mask, axis=0).astype(jnp.int32)  # (L,)
    n_obs = jnp.sum(obs_mask, axis=0)
    was_victim_anchor = old_ref == victim
    shifted_ref = jnp.where(old_ref > victim, old_ref - 1, old_ref).astype(jnp.int32)
    ref_idx = jnp.where(was_victim_anchor, first_obs, shifted_ref)
    landmark_mask = data.landmark_mask & (n_obs >= 2)

    # recompute inverse depth for re-anchored landmarks from the current
    # estimate's world point
    q_ref = state2.q[ref_idx]
    p_ref = state2.p[ref_idx]
    q_bc = data.q_bc[perm][ref_idx]
    p_bc = data.p_bc[perm][ref_idx]
    x_b = lie.quat_rotate_inv(q_ref, x_w - p_ref)
    x_c = lie.quat_rotate_inv(q_bc, x_b - p_bc)
    rng = jnp.linalg.norm(x_c, axis=-1)
    invd_new = 1.0 / jnp.maximum(rng, 1e-12)
    inv_depth = jnp.where(was_victim_anchor & landmark_mask, invd_new, state2.inv_depth)
    state2 = state2._replace(inv_depth=inv_depth)

    # --- preintegration shift: factor j connects j-1→j; after removing
    # the victim, factors j<=victim die, later ones shift left ---
    pre_perm = jnp.asarray(
        list(range(victim + 1)) + list(range(victim + 2, K)) + [K - 1]
    )
    # new slot j holds old factor j+1 for j >= victim (old victim+1 → victim's
    # slot is dropped entirely: the factor victim-1→victim+1 does not exist)
    preint = jax.tree.map(lambda x: x[pre_perm], data.preint)
    preint_mask = data.preint_mask[pre_perm]
    if victim < K:
        preint_mask = preint_mask.at[victim].set(False)
    preint_mask = preint_mask.at[K - 1].set(False)
    bg_lin = data.bg_lin[pre_perm]
    ba_lin = data.ba_lin[pre_perm]

    data2 = data._replace(
        q_bc=data.q_bc[perm], p_bc=data.p_bc[perm],
        q_bi=data.q_bi[perm], p_bi=data.p_bi[perm],
        bearings=bearings, obs_mask=obs_mask, ref_idx=ref_idx,
        sqrt_inv_cov2=data.sqrt_inv_cov2[perm],
        preint=preint, preint_mask=preint_mask, bg_lin=bg_lin, ba_lin=ba_lin,
        frame_mask=frame_mask,
        fix_pose=data.fix_pose[perm].at[K - 1].set(False),
        fix_motion=data.fix_motion[perm].at[K - 1].set(False),
        landmark_mask=landmark_mask,
        marg=new_prior, use_marg=jnp.asarray(True),
    )
    return state2, data2
