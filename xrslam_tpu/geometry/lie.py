"""Quaternion / SO(3) math substrate, batched and branchless.

Reproduces the numerical behavior of the reference's Lie-algebra kernels
(reference: xrslam/src/xrslam/geometry/lie_algebra.{h,cpp}) in a form
suited to accelerators: every function broadcasts over arbitrary leading batch
dimensions, contains no data-dependent Python control flow, and guards
small-angle singularities with `jnp.where`-selected Taylor expansions so
it is jit/vmap/grad-safe.

Quaternion convention: arrays of shape (..., 4) ordered **[w, x, y, z]**
(Hamilton, active rotation; q ⊗ v ⊗ q* rotates v from body to world when
q is a body-to-world orientation — same semantics as Eigen's
`quaternion * vector`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Taylor-switch thresholds mirroring the guarded right-Jacobian of the
# reference (lie_algebra.cpp:5-45). We use a single angle threshold per
# term; below it the quartic-accurate Taylor polynomial is exact to
# machine precision for both f32 and f64.
_SMALL_ANGLE = 1e-3


def _safe_norm(v: jnp.ndarray, axis: int = -1, eps: float = 0.0):
    """Norm with a gradient-safe zero guard.

    Returns (norm, unit) where `unit` is zeros when the norm underflows
    (matching Eigen's `stableNormalized` used by the reference expmap).
    """
    sq = jnp.sum(v * v, axis=axis, keepdims=True)
    norm = jnp.sqrt(jnp.where(sq > 0, sq, 1.0)) * (sq > 0)
    unit = jnp.where(sq > 0, v / jnp.where(sq > 0, norm, 1.0), 0.0)
    return jnp.squeeze(norm, axis=axis), unit


def hat(w: jnp.ndarray) -> jnp.ndarray:
    """Skew-symmetric matrix of (..., 3) -> (..., 3, 3).

    reference: lie_algebra.h:8-11.
    """
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([z, -wz, wy], axis=-1),
            jnp.stack([wz, z, -wx], axis=-1),
            jnp.stack([-wy, wx, z], axis=-1),
        ],
        axis=-2,
    )


def quat_identity(batch_shape=(), dtype=jnp.float64) -> jnp.ndarray:
    q = jnp.zeros(tuple(batch_shape) + (4,), dtype=dtype)
    return q.at[..., 0].set(1.0)


def quat_normalize(q: jnp.ndarray) -> jnp.ndarray:
    n, _ = _safe_norm(q)
    return q / jnp.where(n > 0, n, 1.0)[..., None]


def quat_conj(q: jnp.ndarray) -> jnp.ndarray:
    return q * jnp.asarray([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_mul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Hamilton product, (...,4) x (...,4) -> (...,4)."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def quat_rotate(q: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Rotate vectors v (...,3) by quaternions q (...,4).

    Uses the expanded 15-mul form (no matrix materialization) — cheaper
    elementwise work than building R.
    """
    qw = q[..., 0:1]
    qv = q[..., 1:4]
    t = 2.0 * jnp.cross(qv, v)
    return v + qw * t + jnp.cross(qv, t)


def quat_rotate_inv(q: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    return quat_rotate(quat_conj(q), v)


def quat_to_matrix(q: jnp.ndarray) -> jnp.ndarray:
    """(...,4) -> (...,3,3) rotation matrix."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
            jnp.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
            jnp.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
        ],
        axis=-2,
    )


def matrix_to_quat(m: jnp.ndarray) -> jnp.ndarray:
    """(...,3,3) -> (...,4) [w,x,y,z]; branchless Shepperd's method.

    Computes all four candidate quaternions and selects the one with the
    largest pivot, which is numerically stable for every rotation.
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def _stack(w, x, y, z):
        return jnp.stack([w, x, y, z], axis=-1)

    # candidates scaled by 4*pivot; normalized at the end
    qw = _stack(1 + tr, m21 - m12, m02 - m20, m10 - m01)
    qx = _stack(m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20)
    qy = _stack(m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21)
    qz = _stack(m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22)

    pivots = jnp.stack([1 + tr, 1 + m00 - m11 - m22, 1 - m00 + m11 - m22, 1 - m00 - m11 + m22], axis=-1)
    best = jnp.argmax(pivots, axis=-1)
    cands = jnp.stack([qw, qx, qy, qz], axis=-2)  # (...,4cand,4)
    idx = jnp.broadcast_to(best[..., None, None], best.shape + (1, 4))
    q = jnp.take_along_axis(cands, idx, axis=-2)[..., 0, :]
    q = quat_normalize(q)
    # canonical sign: w >= 0
    return q * jnp.where(q[..., 0:1] < 0, -1.0, 1.0)


def expmap(w: jnp.ndarray) -> jnp.ndarray:
    """so(3) vector (...,3) -> unit quaternion (...,4).

    q = [cos(|w|/2), sin(|w|/2) * w/|w|], Taylor-guarded at |w|→0
    (reference: lie_algebra.h:13-18 via Eigen AngleAxis).
    """
    angle, _ = _safe_norm(w)
    half = 0.5 * angle
    # sin(x)/x with Taylor guard: 1 - x^2/6 + x^4/120
    h2 = half * half
    sinc = jnp.where(angle > _SMALL_ANGLE, jnp.sin(half) / jnp.where(angle > 0, half, 1.0), 1.0 - h2 / 6.0 + h2 * h2 / 120.0)
    qw = jnp.cos(half)
    qv = 0.5 * sinc[..., None] * w
    return jnp.concatenate([qw[..., None], qv], axis=-1)


def logmap(q: jnp.ndarray) -> jnp.ndarray:
    """Unit quaternion (...,4) -> so(3) vector (...,3); Taylor-guarded.

    reference: lie_algebra.h:20-23 via Eigen AngleAxis. Sign-normalizes
    so the returned angle is in [0, pi].
    """
    q = q * jnp.where(q[..., 0:1] < 0, -1.0, 1.0)
    vnorm, _ = _safe_norm(q[..., 1:4])
    w = jnp.clip(q[..., 0], -1.0, 1.0)
    half = jnp.arctan2(vnorm, w)  # in [0, pi/2]
    # factor = 2*half / sin(half) = 2*half/vnorm, guarded via Taylor of
    # 2*atan2(s, w)/s around s=0: 2/w * (1 - s^2/(3 w^2) + ...)
    small = vnorm <= _SMALL_ANGLE
    safe_vnorm = jnp.where(small, 1.0, vnorm)
    factor = jnp.where(
        small,
        2.0 / jnp.where(w > 0, w, 1.0) * (1.0 - vnorm * vnorm / (3.0 * jnp.where(w > 0, w * w, 1.0))),
        2.0 * half / safe_vnorm,
    )
    return factor[..., None] * q[..., 1:4]


def right_jacobian(w: jnp.ndarray) -> jnp.ndarray:
    """SO(3) right Jacobian Jr(w), (...,3) -> (...,3,3).

    Jr = I - (1-cos a)/a^2 [w]x + (a - sin a)/a^3 [w]x^2, with the same
    Taylor fallbacks as the reference (lie_algebra.cpp:5-45), made
    branchless.
    """
    angle, _ = _safe_norm(w)
    a2 = angle * angle
    small = angle <= _SMALL_ANGLE
    safe_a2 = jnp.where(small, 1.0, a2)
    cos_term = jnp.where(small, 0.5 - a2 / 24.0, (1.0 - jnp.cos(angle)) / safe_a2)
    sin_term = jnp.where(
        small,
        1.0 / 6.0 - a2 / 120.0,
        (angle - jnp.sin(angle)) / jnp.where(small, 1.0, a2 * angle),
    )
    hw = hat(w)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), hw.shape)
    return eye - cos_term[..., None, None] * hw + sin_term[..., None, None] * (hw @ hw)


def right_jacobian_inv(w: jnp.ndarray) -> jnp.ndarray:
    """Inverse of the SO(3) right Jacobian, in closed form.

    Jr^-1 = I + 1/2 [w]x + (1/a^2 - (1+cos a)/(2 a sin a)) [w]x^2.
    """
    angle, _ = _safe_norm(w)
    a2 = angle * angle
    small = angle <= _SMALL_ANGLE
    safe_a = jnp.where(small, 1.0, angle)
    coef = jnp.where(
        small,
        1.0 / 12.0 + a2 / 720.0,
        1.0 / jnp.where(small, 1.0, a2) - (1.0 + jnp.cos(angle)) / (2.0 * safe_a * jnp.where(small, 1.0, jnp.sin(safe_a))),
    )
    hw = hat(w)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), hw.shape)
    return eye + 0.5 * hw + coef[..., None, None] * (hw @ hw)


def s2_tangential_basis(x: jnp.ndarray) -> jnp.ndarray:
    """Orthonormal tangent basis of S^2 at x, (...,3) -> (...,3,2).

    Branchless version of the reference's pivot choice
    (lie_algebra.cpp:47-57): d = argmax_i |x_i|; b1 = normalize(x ×
    e_{(d+1)%3}); b2 = normalize(x × b1).
    """
    d = jnp.argmax(jnp.abs(x), axis=-1)
    e = jax.nn.one_hot((d + 1) % 3, 3, dtype=x.dtype)
    b1 = jnp.cross(x, e)
    _, b1 = _safe_norm(b1)
    b2 = jnp.cross(x, b1)
    _, b2 = _safe_norm(b2)
    return jnp.stack([b1, b2], axis=-1)


def slerp(q0: jnp.ndarray, q1: jnp.ndarray, t) -> jnp.ndarray:
    """Spherical linear interpolation (used by the IMU sample
    synchronizer — reference core/detail.cpp:52-59 uses lerp on raw
    samples; slerp provided for pose interpolation utilities)."""
    d = jnp.sum(q0 * q1, axis=-1, keepdims=True)
    q1 = jnp.where(d < 0, -q1, q1)
    d = jnp.abs(d)
    theta = jnp.arccos(jnp.clip(d, -1.0, 1.0))
    small = theta[..., 0] <= _SMALL_ANGLE
    sin_theta = jnp.where(small[..., None], 1.0, jnp.sin(theta))
    w0 = jnp.where(small[..., None], 1.0 - t, jnp.sin((1 - t) * theta) / sin_theta)
    w1 = jnp.where(small[..., None], t, jnp.sin(t * theta) / sin_theta)
    return quat_normalize(w0 * q0 + w1 * q1)
