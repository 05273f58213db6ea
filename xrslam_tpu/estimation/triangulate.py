"""Batched in-program landmark triangulation.

The reference triangulates each new keyframe's untriangulated tracks
with a per-track host-side multi-view DLT + cheirality check
(reference xrslam/src/xrslam/map/track.cpp:46-76, called from
SlidingWindowTracker::track_landmark, sliding_window_tracker.cpp:
225-245) — which forces the backend to FETCH the localized pose before
it can triangulate, a blocking device round trip.

This module is the on-device replacement: one fused kernel
triangulates EVERY candidate landmark of the window directly from the
device-resident window state, so the keyframe step chains
localize → triangulate → refine → gates → marginalize as a single
device program with no host sync.

Formulation: the DLT is solved in a frame centered on the landmark's
anchor camera (coordinates ~ depth instead of ~ world position — much
better conditioned in f32), via the smallest eigenvector of the 4x4
normal matrix AᵀA (batched `eigh` over L landmarks; A has 2 masked
rows per observing frame). Cheirality must hold at every observing
frame, matching the reference's per-view check (track.cpp:66-71).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..geometry import lie
from .window import WindowData, WindowState


def triangulate_landmarks(state: WindowState, data: WindowData,
                          cand: jnp.ndarray):
    """Triangulate candidate landmark slots from the current window
    poses.

    Args:
      state: window state (uses q, p).
      data:  window data (uses q_bc, p_bc, bearings (K,L,3),
             obs_mask (K,L), ref_idx (L,), frame_mask (K,)).
      cand:  (L,) bool — slots to triangulate.

    Returns (inv_depth (L,), ok (L,)): the seeded inverse depth w.r.t.
    the anchor camera (valid where ok) and the acceptance mask
    (candidate ∧ ≥2 observing frames ∧ cheirality at every view ∧
    finite positive depth).
    """
    dt = state.p.dtype
    # camera poses per frame slot
    q_wc = lie.quat_mul(state.q, data.q_bc)
    p_wc = state.p + lie.quat_rotate(state.q, data.p_bc)     # (K,3)
    R_wc = lie.quat_to_matrix(q_wc)                          # (K,3,3)

    # anchor camera center per landmark
    p_a = p_wc[data.ref_idx]                                 # (L,3)

    # projective rows in anchor-centered world coordinates:
    # P_i = [R_wc_iᵀ | -R_wc_iᵀ (p_wc_i - p_a)]  (3,4) per (frame, lm)
    Rt = jnp.swapaxes(R_wc, -1, -2)                          # (K,3,3)
    # t_il = -R_iᵀ (p_i - p_a_l): (K,L,3)
    dp = p_wc[:, None, :] - p_a[None, :, :]
    t = -jnp.einsum("kij,klj->kli", Rt, dp)
    # P rows: P[r] = (Rt[k,r,:], t[k,l,r]) — assemble DLT rows
    b = data.bearings.astype(dt)                             # (K,L,3)
    # row0 = b0*P2 - b2*P0 ; row1 = b1*P2 - b2*P1 (each (K,L,4))
    P0 = jnp.concatenate([jnp.broadcast_to(Rt[:, None, 0, :], b.shape),
                          t[..., 0:1]], axis=-1)
    P1 = jnp.concatenate([jnp.broadcast_to(Rt[:, None, 1, :], b.shape),
                          t[..., 1:2]], axis=-1)
    P2 = jnp.concatenate([jnp.broadcast_to(Rt[:, None, 2, :], b.shape),
                          t[..., 2:3]], axis=-1)
    r0 = b[..., 0:1] * P2 - b[..., 2:3] * P0
    r1 = b[..., 1:2] * P2 - b[..., 2:3] * P1

    m = (data.obs_mask & data.frame_mask[:, None]).astype(dt)  # (K,L)
    mw = m[..., None]
    # normal matrix M = Σ masked rows rᵀr: (L,4,4)
    M = (jnp.einsum("kli,klj->lij", r0 * mw, r0)
         + jnp.einsum("kli,klj->lij", r1 * mw, r1))
    # smallest eigenvector of the symmetric PSD 4x4 (batched)
    M = M + 1e-12 * jnp.eye(4, dtype=dt)
    _, vecs = jnp.linalg.eigh(M)
    h = vecs[..., 0]                                         # (L,4)

    # anchor-centered point X' = h[:3]/h[3]
    w = h[..., 3]
    X = h[..., :3] / jnp.where(jnp.abs(w) > 1e-12, w, 1e-12)[..., None]

    # cheirality at every observing view: z_i = P2_row · h > 0 (with
    # h normalized to w>0). Normalize sign first.
    sgn = jnp.where(w >= 0, 1.0, -1.0).astype(dt)
    hn = h * sgn[..., None]
    z = jnp.einsum("kli,li->kl", P2, hn)                     # (K,L)
    # masked all(): unobserved views must not veto
    ok_che = jnp.all((z > 0) | (m == 0), axis=0)

    n_obs = jnp.sum(m, axis=0)
    rng = jnp.linalg.norm(X, axis=-1)                        # anchor range
    invd = 1.0 / jnp.maximum(rng, 1e-9)
    ok = (jnp.asarray(cand)
          & (n_obs >= 2)
          & ok_che
          & jnp.isfinite(invd)
          & (rng > 1e-3) & (rng < 1.0e4)
          & (jnp.abs(w) > 1e-12))
    return invd.astype(dt), ok
