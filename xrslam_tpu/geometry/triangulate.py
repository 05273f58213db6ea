"""Multi-view DLT triangulation, batched & masked.

reference: xrslam/src/xrslam/geometry/stereo.h:74-100 (SVD nullspace of
the stacked DLT system) and xrslam/src/xrslam/map/track.cpp:46-76
(per-track triangulation with cheirality check over all observations).

Batching note: instead of an SVD per landmark we take the nullspace as the
eigenvector of the smallest eigenvalue of AᵀA (4×4 symmetric), which
batches cleanly with `jnp.linalg.eigh` and handles masked (unused)
observation rows by zero-weighting them — same solution as the
reference's `jacobiSvd(ComputeFullV).matrixV().col(3)` up to sign.
"""

from __future__ import annotations

import jax.numpy as jnp


def dlt_rows(P: jnp.ndarray, point: jnp.ndarray) -> jnp.ndarray:
    """Two DLT rows for one observation: P (...,3,4), bearing point (...,3) -> (...,2,4)."""
    r0 = point[..., 0:1] * P[..., 2, :] - point[..., 2:3] * P[..., 0, :]
    r1 = point[..., 1:2] * P[..., 2, :] - point[..., 2:3] * P[..., 1, :]
    return jnp.stack([r0, r1], axis=-2)


def triangulate_point(Ps: jnp.ndarray, points: jnp.ndarray, mask: jnp.ndarray | None = None) -> jnp.ndarray:
    """Triangulate a homogeneous point from N (masked) views.

    Args:
      Ps: (..., N, 3, 4) world-to-camera projections.
      points: (..., N, 3) bearing vectors (z may be != 1).
      mask: (..., N) optional observation validity; masked rows are zeroed.

    Returns:
      (..., 4) homogeneous point (eigenvector of min eigenvalue of AᵀA).
    """
    A = dlt_rows(Ps, points)  # (...,N,2,4)
    if mask is not None:
        A = A * mask[..., None, None].astype(A.dtype)
    A = A.reshape(A.shape[:-3] + (-1, 4))  # (...,2N,4)
    ata = jnp.einsum("...ij,...ik->...jk", A, A)
    w, v = jnp.linalg.eigh(ata)
    x = v[..., :, 0]  # smallest eigenvalue's eigenvector
    return x


def triangulate_two_view(P1: jnp.ndarray, P2: jnp.ndarray, p1: jnp.ndarray, p2: jnp.ndarray) -> jnp.ndarray:
    """Two-view convenience wrapper (reference stereo.h:74-86)."""
    Ps = jnp.stack([P1, P2], axis=-3)
    pts = jnp.stack([p1, p2], axis=-2)
    return triangulate_point(Ps, pts)


def triangulation_angle(x_w: jnp.ndarray, c1: jnp.ndarray, c2: jnp.ndarray) -> jnp.ndarray:
    """Parallax angle at the triangulated point between camera centers
    c1, c2 (reference map/track.cpp triangulation_angle)."""
    d1 = c1 - x_w
    d2 = c2 - x_w
    cosang = jnp.sum(d1 * d2, axis=-1) / (
        jnp.linalg.norm(d1, axis=-1) * jnp.linalg.norm(d2, axis=-1) + 1e-18
    )
    return jnp.arccos(jnp.clip(cosang, -1.0, 1.0))


def cheirality_depths(Ps: jnp.ndarray, x_h: jnp.ndarray) -> jnp.ndarray:
    """Per-view depth z_i = (P_i x)_z / x_w of homogeneous point x_h; positive
    depths with positive w pass the reference's cheirality gate
    (track.cpp:57-71)."""
    px = jnp.einsum("...nij,...j->...ni", Ps, x_h)
    return px[..., 2] * jnp.sign(x_h[..., 3:4])
