"""IMU preintegration as a `lax.scan`, with 15×15 covariance propagation
and bias Jacobians.

Reproduces the math of the reference's midpoint-free Euler integrator
(reference: xrslam/src/xrslam/estimation/preintegrator.{h,cpp}):

  error-state order (q, p, v, bg, ba) at offsets (0, 3, 6, 9, 12)
  (estimation/state.h:12-19);
  per-sample discrete transition A (9×9) / noise input B (9×6)
  (preintegrator.cpp:30-57); bias Jacobians dq/dbg, dp/dbg, dp/dba,
  dv/dbg, dv/dba (preintegrator.cpp:59-70); sqrt information
  U = chol(cov⁻¹)ᵀ (upper-triangular; preintegrator.cpp:97-100);
  gravity-forward state prediction (preintegrator.cpp:102-112).

Array-form differences: fixed-capacity sample buffers with dt==0
padding (a dt==0 increment is an exact no-op, so masking is free inside
the scan), and the whole integration is one jittable, vmappable scan —
batching over windows of frames or over many sequences.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import lie

GRAVITY_NOMINAL = 9.80665
# numpy (not jnp): a module-level device array would initialize the
# XLA backend at import time, breaking jax.distributed.initialize
GRAVITY = np.array([0.0, 0.0, -GRAVITY_NOMINAL])

# Error-state offsets (reference estimation/state.h:12-19).
ES_Q, ES_P, ES_V, ES_BG, ES_BA, ES_SIZE = 0, 3, 6, 9, 12, 15


class PreintDelta(NamedTuple):
    """Preintegrated IMU delta between two frames (a pytree; every leaf
    broadcasts over leading batch dims)."""

    t: jnp.ndarray        # () total integration time
    q: jnp.ndarray        # (4,) Δq [w,x,y,z]
    p: jnp.ndarray        # (3,) Δp
    v: jnp.ndarray        # (3,) Δv
    cov: jnp.ndarray      # (15,15) error-state covariance (q,p,v,bg,ba)
    sqrt_inv_cov: jnp.ndarray  # (15,15) U with UᵀU = cov⁻¹
    dq_dbg: jnp.ndarray   # (3,3)
    dp_dbg: jnp.ndarray
    dp_dba: jnp.ndarray
    dv_dbg: jnp.ndarray
    dv_dba: jnp.ndarray

    @staticmethod
    def identity(dtype=jnp.float64) -> "PreintDelta":
        z3 = jnp.zeros((3, 3), dtype=dtype)
        return PreintDelta(
            t=jnp.zeros((), dtype=dtype),
            q=lie.quat_identity(dtype=dtype),
            p=jnp.zeros(3, dtype=dtype),
            v=jnp.zeros(3, dtype=dtype),
            cov=jnp.zeros((15, 15), dtype=dtype),
            sqrt_inv_cov=jnp.zeros((15, 15), dtype=dtype),
            dq_dbg=z3, dp_dbg=z3, dp_dba=z3, dv_dbg=z3, dv_dba=z3,
        )


class ImuNoise(NamedTuple):
    """Continuous-time noise covariances (3×3 each), matching the
    reference Config getters imu_{gyroscope,accelerometer}_{noise,bias}_cov."""

    cov_w: jnp.ndarray
    cov_a: jnp.ndarray
    cov_bg: jnp.ndarray
    cov_ba: jnp.ndarray

    @staticmethod
    def isotropic(sigma_w2, sigma_a2, sigma_bg2, sigma_ba2, dtype=jnp.float64) -> "ImuNoise":
        eye = jnp.eye(3, dtype=dtype)
        return ImuNoise(sigma_w2 * eye, sigma_a2 * eye, sigma_bg2 * eye, sigma_ba2 * eye)


def _increment(delta: PreintDelta, dt, w_raw, a_raw, bg, ba, noise: ImuNoise) -> PreintDelta:
    """One Euler step (reference preintegrator.cpp:22-79). dt==0 is an
    exact no-op, enabling fixed-capacity masked buffers."""
    w = w_raw - bg
    a = a_raw - ba

    dq_step = lie.expmap(w * dt)
    R_delta = lie.quat_to_matrix(delta.q)
    R_step_T = lie.quat_to_matrix(dq_step).T  # = expmap(w dt).conjugate().matrix()
    hat_a = lie.hat(a)
    Rhat = R_delta @ hat_a
    eye3 = jnp.eye(3, dtype=delta.cov.dtype)

    # --- covariance: cov9' = A cov9 Aᵀ + B W Bᵀ (q,p,v block) ---
    A = jnp.zeros((9, 9), dtype=delta.cov.dtype)
    A = A.at[ES_Q:ES_Q + 3, ES_Q:ES_Q + 3].set(R_step_T)
    A = A.at[ES_P:ES_P + 3, ES_Q:ES_Q + 3].set(-0.5 * dt * dt * Rhat)
    A = A.at[ES_P:ES_P + 3, ES_P:ES_P + 3].set(eye3)
    A = A.at[ES_P:ES_P + 3, ES_V:ES_V + 3].set(dt * eye3)
    A = A.at[ES_V:ES_V + 3, ES_Q:ES_Q + 3].set(-dt * Rhat)
    A = A.at[ES_V:ES_V + 3, ES_V:ES_V + 3].set(eye3)

    B = jnp.zeros((9, 6), dtype=delta.cov.dtype)
    B = B.at[ES_Q:ES_Q + 3, 0:3].set(dt * lie.right_jacobian(w * dt))
    B = B.at[ES_P:ES_P + 3, 3:6].set(0.5 * dt * dt * R_delta)
    B = B.at[ES_V:ES_V + 3, 3:6].set(dt * R_delta)

    inv_dt = 1.0 / jnp.maximum(dt, 1.0e-7)
    W = jnp.zeros((6, 6), dtype=delta.cov.dtype)
    W = W.at[0:3, 0:3].set(noise.cov_w * inv_dt)
    W = W.at[3:6, 3:6].set(noise.cov_a * inv_dt)

    cov9 = A @ delta.cov[:9, :9] @ A.T + B @ W @ B.T
    cov = delta.cov.at[:9, :9].set(cov9)
    cov = cov.at[ES_BG:ES_BG + 3, ES_BG:ES_BG + 3].add(noise.cov_bg * dt)
    cov = cov.at[ES_BA:ES_BA + 3, ES_BA:ES_BA + 3].add(noise.cov_ba * dt)

    # --- bias Jacobians (order matters: p,v use the *old* dq_dbg) ---
    dp_dbg = delta.dp_dbg + dt * delta.dv_dbg - 0.5 * dt * dt * Rhat @ delta.dq_dbg
    dp_dba = delta.dp_dba + dt * delta.dv_dba - 0.5 * dt * dt * R_delta
    dv_dbg = delta.dv_dbg - dt * Rhat @ delta.dq_dbg
    dv_dba = delta.dv_dba - dt * R_delta
    dq_dbg = R_step_T @ delta.dq_dbg - dt * lie.right_jacobian(w * dt)

    # --- delta state ---
    a_world = lie.quat_rotate(delta.q, a)
    p = delta.p + dt * delta.v + 0.5 * dt * dt * a_world
    v = delta.v + dt * a_world
    q = lie.quat_normalize(lie.quat_mul(delta.q, dq_step))

    return delta._replace(
        t=delta.t + dt, q=q, p=p, v=v, cov=cov,
        dq_dbg=dq_dbg, dp_dbg=dp_dbg, dp_dba=dp_dba, dv_dbg=dv_dbg, dv_dba=dv_dba,
    )


def sample_dts(ts: jnp.ndarray, t_end, count) -> jnp.ndarray:
    """Per-sample integration spans for a fixed-capacity buffer.

    Sample i covers [t_i, t_{i+1}) and the last valid sample covers up
    to `t_end` (reference preintegrator.cpp:81-95). Samples ≥ count get
    dt = 0 (no-ops).
    """
    n = ts.shape[0]
    idx = jnp.arange(n)
    t_next = jnp.concatenate([ts[1:], ts[-1:]])
    is_last = idx == (count - 1)
    dts = jnp.where(is_last, t_end - ts, t_next - ts)
    return jnp.where(idx < count, jnp.maximum(dts, 0.0), 0.0)


@partial(jax.jit, static_argnames=("compute_sqrt_inv", "cov_eps"))
def integrate(
    ts: jnp.ndarray,
    ws: jnp.ndarray,
    accs: jnp.ndarray,
    t_end,
    bg: jnp.ndarray,
    ba: jnp.ndarray,
    noise: ImuNoise,
    count=None,
    compute_sqrt_inv: bool = True,
    cov_eps: float = 0.0,
) -> PreintDelta:
    """Integrate a (fixed-capacity) IMU sample buffer into a PreintDelta.

    Args:
      ts: (N,) sample timestamps (ascending; entries ≥ count ignored).
      ws, accs: (N,3) gyro / accel samples.
      t_end: frame timestamp closing the interval.
      bg, ba: (3,) biases at the linearization point.
      noise: continuous-time noise model.
      count: number of valid samples (default: all N).
      cov_eps: optional diagonal jitter before inversion (0 matches the
        reference exactly; reference preintegrator.cpp:97-100).
    """
    n = ts.shape[0]
    count = n if count is None else count
    dts = sample_dts(ts, t_end, count)
    init = PreintDelta.identity(dtype=ws.dtype)

    def step(delta, inp):
        dt, w, a = inp
        return _increment(delta, dt, w, a, bg, ba, noise), None

    delta, _ = jax.lax.scan(step, init, (dts, ws, accs))
    if compute_sqrt_inv:
        delta = delta._replace(sqrt_inv_cov=sqrt_inv_from_cov(delta.cov, cov_eps))
    return delta


def sqrt_inv_from_cov(cov: jnp.ndarray, eps: float = 0.0) -> jnp.ndarray:
    """U = chol(cov⁻¹)ᵀ, upper triangular with UᵀU = cov⁻¹
    (reference preintegrator.cpp:97-100)."""
    eye = jnp.eye(cov.shape[-1], dtype=cov.dtype)
    inv = jnp.linalg.inv(cov + eps * eye)
    inv = 0.5 * (inv + jnp.swapaxes(inv, -1, -2))
    L = jnp.linalg.cholesky(inv)
    return jnp.swapaxes(L, -1, -2)


@partial(jax.jit, static_argnames=("compute_sqrt_inv",))
def integrate_batch(ts, ws, accs, t_end, bg, ba, noise: ImuNoise, count,
                    compute_sqrt_inv: bool = True) -> PreintDelta:
    """Vmapped `integrate` over a leading interval axis: ts (K,S),
    ws/accs (K,S,3), t_end (K,), bg/ba (K,3), count (K,). One compile
    serves every window extraction — the batched form."""
    d = jax.vmap(
        lambda t, w, a, te, g, b, c: integrate(
            t, w, a, te, g, b, noise, count=c,
            compute_sqrt_inv=compute_sqrt_inv,
        )
    )(ts, ws, accs, t_end, bg, ba, count)
    if compute_sqrt_inv:
        # empty intervals have singular covariance -> NaN sqrt info;
        # replace with the identity delta's zero information
        ok = (count > 0)[:, None, None]
        d = d._replace(sqrt_inv_cov=jnp.where(ok, d.sqrt_inv_cov, 0.0))
    return d


@jax.jit
def predict(pose_q, pose_p, v, bg, ba, delta: PreintDelta):
    """Gravity-forward prediction of the next frame's pose/motion from
    the previous optimized state (reference preintegrator.cpp:102-112).

    Returns (q_new, p_new, v_new, bg, ba).
    """
    g = jnp.asarray(GRAVITY, dtype=pose_p.dtype)
    v_new = v + g * delta.t + lie.quat_rotate(pose_q, delta.v)
    p_new = pose_p + 0.5 * g * delta.t * delta.t + v * delta.t + lie.quat_rotate(pose_q, delta.p)
    q_new = lie.quat_mul(pose_q, delta.q)
    return q_new, p_new, v_new, bg, ba
