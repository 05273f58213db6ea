"""Batched PnP: 6-point DLT minimal solver + RANSAC / PARSAC /
IMU-PARSAC wrappers.

The reference calls OpenCV's EPnP on 6 points
(reference: xrslam/src/xrslam/geometry/pnp.h:12-49) and wraps it in
RANSAC/PARSAC/IMU-PARSAC with χ² thresholds 2·5.99·σ²
(pnp.h:96-208). A 6-point DLT (SVD of the 12×12 projection-matrix
system, R re-orthonormalized by SVD) is algebraically equivalent for
minimal noise-free samples and maps onto batched linear algebra;
the RANSAC consensus step dominates accuracy either way.

Error model (pnp.h:91-95): squared *normalized-plane* reprojection
error ‖x − hnorm(R·X + t)‖².
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import core, parsac


def solve_pnp_dlt(X: jnp.ndarray, x: jnp.ndarray):
    """P from n≥6 correspondences X (n,3) world → x (n,2) normalized
    image, via DLT + orthonormalization. Returns T (4,4) with
    [R|t] on top."""
    n = X.shape[0]
    dt = X.dtype
    Xh = jnp.concatenate([X, jnp.ones((n, 1), dtype=dt)], axis=-1)  # (n,4)
    z = jnp.zeros((n, 4), dtype=dt)
    r1 = jnp.concatenate([Xh, z, -x[:, 0:1] * Xh], axis=-1)  # (n,12)
    r2 = jnp.concatenate([z, Xh, -x[:, 1:2] * Xh], axis=-1)
    A = jnp.concatenate([r1, r2], axis=0)  # (2n,12)
    _, _, vt = jnp.linalg.svd(A, full_matrices=True)
    p = vt[-1]
    P = p.reshape(3, 4)
    M = P[:, :3]
    # scale & sign: det(R)>0, ‖R‖ = orthonormal
    s = jnp.sign(jnp.linalg.det(M)) / jnp.cbrt(jnp.abs(jnp.linalg.det(M)) + 1e-30)
    P = P * s
    U, sv, Vt = jnp.linalg.svd(P[:, :3])
    R = U @ Vt
    R = R * jnp.sign(jnp.linalg.det(R))
    t = P[:, 3] * 3.0 / jnp.clip(jnp.sum(sv), 1e-12, None)
    T = jnp.eye(4, dtype=dt).at[:3, :3].set(R).at[:3, 3].set(t)
    return T


def pnp_reproject_error(T: jnp.ndarray, X: jnp.ndarray, x: jnp.ndarray):
    """Squared normalized-plane reprojection errors (N,) (reference
    pnp.h:91-95); points behind the camera get +inf."""
    Xc = X @ T[:3, :3].T + T[:3, 3]
    z = Xc[..., 2]
    proj = Xc[..., :2] / jnp.where(jnp.abs(z) < 1e-12, 1e-12, z)[..., None]
    err = jnp.sum((x - proj) ** 2, axis=-1)
    return jnp.where(z > 0, err, jnp.inf)


CHI2_2DOF = 5.99  # t2 (pnp.h:117)


@partial(jax.jit, static_argnames=("n_hyp",))
def find_pnp_matrix(key, X, x, valid=None, threshold: float = 1.0,
                    n_hyp: int = 256):
    """RANSAC PnP (reference pnp.h:96-131). Returns (T, inlier_mask,
    count). Threshold: 2·t2·threshold² on squared normalized error."""
    N = X.shape[0]

    def solver(idx, X, x):
        return solve_pnp_dlt(X[idx], x[idx])

    def evaluator(T, X, x):
        return pnp_reproject_error(T, X, x)

    thr = 2.0 * CHI2_2DOF * threshold * threshold
    return core.ransac(key, solver, evaluator, (X, x), N, 6, thr,
                       n_hyp=n_hyp, valid=valid)


@partial(jax.jit, static_argnames=("n_hyp",))
def find_pnp_matrix_parsac(key, X, x, bin_conf, valid=None,
                           threshold: float = 1.0, norm_scale: float = 1.0,
                           n_hyp: int = 256):
    """PARSAC PnP (reference pnp.h:133-166): spatial-bin-confidence
    weighted sampling + coverage scoring. Returns
    (T, inlier_mask, count, new_bin_conf)."""
    N = X.shape[0]
    thr = 2.0 * CHI2_2DOF * threshold * threshold

    def solver(idx, X, x):
        return solve_pnp_dlt(X[idx], x[idx])

    def evaluator(T, X, x):
        return pnp_reproject_error(T, X, x)

    return parsac.parsac(key, solver, evaluator, (X, x), x, bin_conf,
                         N, 6, thr, valid=valid, norm_scale=norm_scale,
                         n_hyp=n_hyp)


@partial(jax.jit, static_argnames=("n_hyp",))
def find_pnp_matrix_parsac_imu(key, X, x, lens, prior_T, bin_conf,
                               dynamic_prob, valid=None,
                               threshold: float = 1.0,
                               norm_scale: float = 1.0, n_hyp: int = 256):
    """IMU-PARSAC PnP (reference pnp.h:168-208, utility/imu_parsac.h):
    the RD-VIO dynamic-outlier rejector. The IMU-propagated prior pose
    gates hypotheses by inlier overlap; track lengths and the dynamic
    probability weight the bin confidences.

    Returns (T, inlier_mask, count, new_bin_conf, prior_ok). When the
    prior inlier set is too small (imu_parsac.h:192-197: ratio < 0.15
    or < 20), T is the prior pose, every valid point is an inlier, and
    prior_ok is False — the caller treats the frame as untrackable for
    dynamic classification (sliding_window_tracker.cpp:612-634).
    """
    N = X.shape[0]
    thr = 2.0 * CHI2_2DOF * threshold * threshold

    def solver(idx, X, x):
        return solve_pnp_dlt(X[idx], x[idx])

    def evaluator(T, X, x):
        return pnp_reproject_error(T, X, x)

    return parsac.imu_parsac(key, solver, evaluator, (X, x), x, lens,
                             prior_T, bin_conf, dynamic_prob, N, 6, thr,
                             valid=valid, norm_scale=norm_scale, n_hyp=n_hyp)


@partial(jax.jit, static_argnames=("iters",))
def refine_pose_pnp(q_wc, p_wc, X, bearings, valid, sqrt_inv_cov2,
                    iters: int = 10, damping: float = 1e-6):
    """Pose-only robust Gauss-Newton against known 3D landmarks: the
    camera-rate "visual PnP" solve of the reference's high-rate pose
    path (reference xrslam/src/xrslam/core/feature_tracker.cpp:282-298
    FeatureTracker::solve_pnp — which assembles reprojection *prior*
    factors, Cauchy(1.0) loss, over the latest frame's pose states; note
    the reference builds the Ceres problem but omits the solve() call,
    so its published pose degrades to the IMU prediction — we implement
    the evidently intended solve).

    Residual model matches CeresReprojectionPriorFactor
    (estimation/ceres/reprojection_factor.h:102-131): for each observed
    unit bearing b with landmark X, r = W · Tb(b)ᵀ · normalize(R_wcᵀ(X −
    p_wc)), with Tb the S² tangential basis of b and W the K-scaled
    pixel-noise whitening. IRLS with Cauchy(1.0) weights
    (solver.cpp:36). Pose increment q ⊞ δθ = q·exp(δθ) (the quaternion
    parameterization of ceres/quaternion_parameterization.h:11-31).

    Args: q_wc (4,) camera-to-world [w,x,y,z]; p_wc (3,); X (N,3) world
    points; bearings (N,3) observed unit bearings (camera frame); valid
    (N,) bool; sqrt_inv_cov2 (2,2). Returns (q_wc, p_wc) refined.
    """
    from ..geometry import lie

    dt = X.dtype
    tb = lie.s2_tangential_basis(bearings)          # (N,3,2)

    def residuals(q, p):
        y = quat_rotate_inv_rows(q, X - p)          # (N,3) camera coords
        yn = y / jnp.clip(jnp.linalg.norm(y, axis=-1, keepdims=True), 1e-12)
        u = jnp.einsum("nij,nj->ni", jnp.swapaxes(tb, 1, 2), yn)  # (N,2)
        r = u @ sqrt_inv_cov2.T
        return jnp.where(valid[:, None], r, 0.0)

    def step(_, qp):
        q, p = qp

        def r_of(delta):
            dq = lie.expmap(delta[:3])
            return residuals(lie.quat_normalize(lie.quat_mul(q, dq)),
                             p + delta[3:]).reshape(-1)

        r = r_of(jnp.zeros((6,), dtype=dt))
        J = jax.jacfwd(r_of)(jnp.zeros((6,), dtype=dt))  # (2N,6)
        # Cauchy(1.0) IRLS weight per observation (2 residual rows each)
        r2 = jnp.sum(r.reshape(-1, 2) ** 2, axis=-1)
        w = 1.0 / (1.0 + r2)
        w2 = jnp.sqrt(jnp.repeat(w, 2))
        Jw = J * w2[:, None]
        rw = r * w2
        H = Jw.T @ Jw + damping * jnp.eye(6, dtype=dt)
        g = Jw.T @ rw
        delta = -jnp.linalg.solve(H, g)
        q = lie.quat_normalize(lie.quat_mul(q, lie.expmap(delta[:3])))
        p = p + delta[3:]
        return (q, p)

    q, p = jax.lax.fori_loop(0, iters, step, (jnp.asarray(q_wc, dt),
                                              jnp.asarray(p_wc, dt)))
    return q, p


def quat_rotate_inv_rows(q, v):
    """Rotate rows v (N,3) by q⁻¹ (q (4,) [w,x,y,z])."""
    from ..geometry import lie

    R = lie.quat_to_matrix(q)
    return v @ R
