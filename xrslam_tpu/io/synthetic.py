"""Synthetic VIO scene generator: smooth analytic trajectory + landmark
cloud + ideal IMU + bearing observations.

Used by the test pyramid (solver-level synthetic BA problems with known
optima — SURVEY.md §4) and by `bench.py` as a dataset-independent load
generator. No reference counterpart (the reference validates manually
against EuRoC with evo — docs/en/tutorials/euroc_evaluation.md).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import lie
from ..imu.preintegration import GRAVITY_NOMINAL


class Scene(NamedTuple):
    """Ground-truth scene sampled at camera rate."""

    t: jnp.ndarray          # (F,) frame timestamps
    q: jnp.ndarray          # (F,4) body-to-world
    p: jnp.ndarray          # (F,3)
    v: jnp.ndarray          # (F,3)
    landmarks: jnp.ndarray  # (L,3) world points
    imu_t: jnp.ndarray      # (F, S) per-frame-interval IMU stamps
    imu_w: jnp.ndarray      # (F, S, 3) gyro (body)
    imu_a: jnp.ndarray      # (F, S, 3) accel (body, includes -gravity)


def circle_scene(
    n_frames: int = 32,
    n_landmarks: int = 64,
    cam_hz: float = 20.0,
    imu_hz: float = 200.0,
    radius: float = 3.0,
    omega: float = 0.6,
    height: float = 1.5,
    seed: int = 0,
    dtype=jnp.float64,
) -> Scene:
    """Body flies a circle at constant angular rate, x-axis tangent,
    z-axis up; landmarks scattered in a shell around the circle."""
    g = jnp.array([0.0, 0.0, -GRAVITY_NOMINAL], dtype=dtype)

    def pose(t):
        th = omega * t
        p = jnp.array([radius * jnp.cos(th), radius * jnp.sin(th), height], dtype=dtype)
        q = lie.expmap(jnp.array([0.0, 0.0, 1.0], dtype=dtype) * (th + jnp.pi / 2))
        v = jnp.array([-radius * omega * jnp.sin(th), radius * omega * jnp.cos(th), 0.0], dtype=dtype)
        return q, p, v

    def imu(t):
        th = omega * t
        a_w = jnp.array(
            [-radius * omega**2 * jnp.cos(th), -radius * omega**2 * jnp.sin(th), 0.0], dtype=dtype
        )
        q, _, _ = pose(t)
        a_b = lie.quat_rotate_inv(q, a_w - g)
        w_b = jnp.array([0.0, 0.0, omega], dtype=dtype)
        return w_b, a_b

    ts = jnp.arange(n_frames, dtype=dtype) / cam_hz
    qs, ps, vs = jax.vmap(pose)(ts)

    spf = int(imu_hz / cam_hz)
    imu_t = ts[:, None] + jnp.arange(spf, dtype=dtype)[None, :] / imu_hz
    imu_w, imu_a = jax.vmap(jax.vmap(imu))(imu_t)

    key = jax.random.PRNGKey(seed)
    kr, kz, kth = jax.random.split(key, 3)
    r_lm = jax.random.uniform(kr, (n_landmarks,), minval=0.3 * radius, maxval=0.8 * radius, dtype=dtype)
    th_lm = jax.random.uniform(kth, (n_landmarks,), minval=0.0, maxval=2 * jnp.pi, dtype=dtype)
    z_lm = jax.random.uniform(kz, (n_landmarks,), minval=0.0, maxval=2.5, dtype=dtype)
    landmarks = jnp.stack([r_lm * jnp.cos(th_lm), r_lm * jnp.sin(th_lm), z_lm], axis=-1)

    return Scene(t=ts, q=qs, p=ps, v=vs, landmarks=landmarks, imu_t=imu_t, imu_w=imu_w, imu_a=imu_a)


def wave_scene(
    n_frames: int = 60,
    n_landmarks: int = 256,
    cam_hz: float = 20.0,
    imu_hz: float = 200.0,
    radius: float = 3.0,
    omega: float = 0.25,
    height: float = 1.5,
    seed: int = 0,
    pause=None,
    dtype=jnp.float64,
) -> Scene:
    """Excitation-rich trajectory: a circle with modulated angular rate,
    breathing radius, and vertical bobbing — non-constant body-frame
    specific force, so monocular VI initialization (gravity/scale/
    velocity) is fully observable. The constant-rate `circle_scene` is a
    constant-twist trajectory whose accelerometer reading is constant in
    the body frame, which makes scale/gravity *unobservable* for the
    initializer (the degenerate case the reference would also fail on);
    use this scene for end-to-end initialization tests.

    `pause=(t_center, width)` inserts a smooth **pure-rotation segment**:
    the position runs on an erf time-warp γ(t) whose rate vanishes at
    t_center (γ̇ = 1 − exp(−((t−tc)/w)²)) while the orientation keeps
    turning with real time — the scene that exercises the reference's
    FT_NO_TRANSLATION subframe machine (frame.cpp:115-134,
    sliding_window_tracker.cpp:145-223,370-465).

    IMU is derived by autodiff: a(t) = p̈, ω_b = 2·vec(q⁻¹ ⊗ q̇).
    """
    g = jnp.array([0.0, 0.0, -GRAVITY_NOMINAL], dtype=dtype)

    if pause is not None:
        t_c, w_p = pause
        c_p = w_p * jnp.sqrt(jnp.pi) / 2.0

        def gamma(t):
            return t - c_p * (jax.scipy.special.erf((t - t_c) / w_p)
                              + jax.scipy.special.erf(t_c / w_p))
    else:
        def gamma(t):
            return t

    def theta(t):
        return omega * t + 0.35 * jnp.sin(1.9 * t)

    def p_of(t):
        tt = gamma(t)
        th = theta(tt)
        r = radius + 0.25 * jnp.sin(1.3 * tt)
        return jnp.stack([r * jnp.cos(th), r * jnp.sin(th),
                          height + 0.2 * jnp.sin(1.7 * tt)])

    def q_of(t):
        th = theta(t)
        yaw = lie.expmap(jnp.array([0.0, 0.0, 1.0], dtype=dtype) * (th + jnp.pi / 2))
        wob = lie.expmap(jnp.stack([0.08 * jnp.sin(1.1 * t),
                                    0.06 * jnp.sin(0.9 * t + 1.0),
                                    jnp.zeros((), dtype=dtype)]))
        return lie.quat_mul(yaw, wob)

    v_of = jax.jacfwd(p_of)
    a_of = jax.jacfwd(v_of)
    dq_of = jax.jacfwd(q_of)

    def pose(t):
        return q_of(t), p_of(t), v_of(t)

    def imu(t):
        q = q_of(t)
        a_b = lie.quat_rotate_inv(q, a_of(t) - g)
        # quaternion kinematics: q̇ = ½ q ⊗ [0, ω_b]
        wq = 2.0 * lie.quat_mul(lie.quat_conj(q), dq_of(t))
        return wq[1:4], a_b

    ts = jnp.arange(n_frames, dtype=dtype) / cam_hz
    qs, ps, vs = jax.vmap(pose)(ts)

    spf = int(imu_hz / cam_hz)
    imu_t = ts[:, None] + jnp.arange(spf, dtype=dtype)[None, :] / imu_hz
    imu_w, imu_a = jax.vmap(jax.vmap(imu))(imu_t)

    key = jax.random.PRNGKey(seed)
    kr, kz, kth = jax.random.split(key, 3)
    r_lm = jax.random.uniform(kr, (n_landmarks,), minval=0.2 * radius,
                              maxval=0.8 * radius, dtype=dtype)
    th_lm = jax.random.uniform(kth, (n_landmarks,), minval=0.0,
                               maxval=2 * jnp.pi, dtype=dtype)
    z_lm = jax.random.uniform(kz, (n_landmarks,), minval=-0.5, maxval=3.0,
                              dtype=dtype)
    landmarks = jnp.stack([r_lm * jnp.cos(th_lm), r_lm * jnp.sin(th_lm), z_lm],
                          axis=-1)

    return Scene(t=ts, q=qs, p=ps, v=vs, landmarks=landmarks,
                 imu_t=imu_t, imu_w=imu_w, imu_a=imu_a)


DEFAULT_IMU_NOISE = None  # set below once ImuNoise is importable


def euler_consistent(scene: Scene, noise=None) -> Scene:
    """Replace the scene's analytic frame states by dead-reckoned ones
    (same Euler scheme as the preintegrator), so that preintegration
    residuals are *exactly* zero at the returned states — giving solver
    tests/benches a known exact optimum."""
    from ..imu import preintegration as pre

    noise = noise or DEFAULT_IMU_NOISE
    zero = jnp.zeros(3, dtype=scene.p.dtype)
    F = scene.t.shape[0]
    q, p, v = scene.q[0], scene.p[0], scene.v[0]
    qs, ps, vs = [q], [p], [v]
    for k in range(F - 1):
        d = pre.integrate(
            scene.imu_t[k], scene.imu_w[k], scene.imu_a[k], scene.t[k + 1],
            zero, zero, noise, compute_sqrt_inv=False,
        )
        q, p, v, _, _ = pre.predict(q, p, v, zero, zero, d)
        qs.append(q), ps.append(p), vs.append(v)
    return scene._replace(q=jnp.stack(qs), p=jnp.stack(ps), v=jnp.stack(vs))


def window_problem(
    scene: Scene,
    frame_idx,
    L: int = 64,
    q_bc=None,
    p_bc=None,
    reproj_weight: float = 400.0,
    noise=None,
    dtype=jnp.float64,
):
    """Ground-truth (WindowState, WindowData) for the given scene frames
    — the solver-level fixture used by tests, bench.py, and the graft
    entry (dtype=float32 for the accelerator compute path)."""
    import numpy as np

    from ..estimation.window import MargPrior, WindowData, WindowState
    from ..imu import preintegration as pre

    noise = noise or DEFAULT_IMU_NOISE
    K = len(frame_idx)
    frame_idx = jnp.asarray(frame_idx)
    q_bc = lie.quat_identity(dtype=dtype) if q_bc is None else q_bc.astype(dtype)
    p_bc = jnp.zeros(3, dtype=dtype) if p_bc is None else p_bc.astype(dtype)

    bearings, mask = bearings_of(scene, q_bc, p_bc, frame_idx)
    n_lm = scene.landmarks.shape[0]
    assert n_lm <= L

    # anchor = first observing frame; valid landmarks seen in >= 2 frames
    seen = np.asarray(mask)
    ref_idx = np.zeros(L, dtype=np.int32)
    lm_mask = np.zeros(L, dtype=bool)
    for l in range(n_lm):
        obs = np.nonzero(seen[:, l])[0]
        if len(obs) >= 2:
            ref_idx[l] = obs[0]
            lm_mask[l] = True

    # inverse depth along the anchor's unit bearing = 1 / range
    q_w = scene.q[frame_idx]
    p_w = scene.p[frame_idx]
    x_b = jax.vmap(lambda qk, pk: lie.quat_rotate_inv(qk, scene.landmarks - pk))(q_w, p_w)
    x_c = jax.vmap(lambda xb: lie.quat_rotate_inv(q_bc, xb - p_bc))(x_b)
    rng = jnp.linalg.norm(x_c, axis=-1)  # (K, n_lm)
    invd = np.zeros(L)
    for l in range(n_lm):
        if lm_mask[l]:
            invd[l] = 1.0 / float(rng[ref_idx[l], l])

    bearings_p = jnp.zeros((K, L, 3), dtype=dtype).at[:, :n_lm].set(bearings.astype(dtype))
    mask_p = jnp.zeros((K, L), dtype=bool).at[:, :n_lm].set(mask)

    # preintegration between consecutive window frames
    zero = jnp.zeros(3, dtype=dtype)
    deltas = []
    for j in range(K):
        if j == 0:
            deltas.append(pre.PreintDelta.identity(dtype=dtype))
            continue
        i0, i1 = int(frame_idx[j - 1]), int(frame_idx[j])
        ts = scene.imu_t[i0:i1].reshape(-1).astype(dtype)
        ws = scene.imu_w[i0:i1].reshape(-1, 3).astype(dtype)
        accs = scene.imu_a[i0:i1].reshape(-1, 3).astype(dtype)
        deltas.append(pre.integrate(ts, ws, accs, scene.t[i1].astype(dtype), zero, zero, noise))
    preint = jax.tree.map(lambda *xs: jnp.stack(xs), *deltas)

    state = WindowState(
        q=scene.q[frame_idx].astype(dtype),
        p=scene.p[frame_idx].astype(dtype),
        v=scene.v[frame_idx].astype(dtype),
        bg=jnp.zeros((K, 3), dtype=dtype),
        ba=jnp.zeros((K, 3), dtype=dtype),
        inv_depth=jnp.asarray(invd, dtype=dtype),
    )
    qbcK = jnp.broadcast_to(q_bc, (K, 4))
    pbcK = jnp.broadcast_to(p_bc, (K, 3))
    data = WindowData(
        q_bc=qbcK, p_bc=pbcK,
        q_bi=jnp.broadcast_to(lie.quat_identity(dtype=dtype), (K, 4)),
        p_bi=jnp.zeros((K, 3), dtype=dtype),
        bearings=bearings_p,
        obs_mask=mask_p,
        ref_idx=jnp.asarray(ref_idx),
        sqrt_inv_cov2=jnp.broadcast_to(reproj_weight * jnp.eye(2, dtype=dtype), (K, 2, 2)),
        preint=preint,
        preint_mask=jnp.ones((K,), dtype=bool).at[0].set(False),
        bg_lin=jnp.zeros((K, 3), dtype=dtype),
        ba_lin=jnp.zeros((K, 3), dtype=dtype),
        frame_mask=jnp.ones((K,), dtype=bool),
        fix_pose=jnp.zeros((K,), dtype=bool),
        fix_motion=jnp.zeros((K,), dtype=bool),
        landmark_mask=jnp.asarray(lm_mask),
        fix_landmark=jnp.zeros((L,), dtype=bool),
        marg=MargPrior.zeros(K, L, dtype=dtype),
        use_marg=jnp.asarray(False),
    )
    return state, data


def _init_default_noise():
    global DEFAULT_IMU_NOISE
    from ..imu.preintegration import ImuNoise

    DEFAULT_IMU_NOISE = ImuNoise.isotropic(1e-4, 1e-2, 1e-8, 1e-6)


_init_default_noise()


def moving_object(
    scene: Scene,
    n_points: int = 48,
    center=(0.8, 0.8, 1.2),
    vel=(-0.25, 0.15, 0.05),
    omega_obj=(0.0, 0.0, 0.4),
    extent: float = 0.45,
    seed: int = 7,
    dtype=jnp.float64,
):
    """Per-frame positions (F, n_points, 3) of a rigidly-moving object:
    a compact point cluster translating at `vel` and spinning at
    `omega_obj` — the dynamic-outlier scene of RD-VIO (the reference has
    no synthetic generator; its dynamic scenes are the ADVIO sequences,
    docs/en/benchmark.md:26-51). Feature tracks on these points are
    consistent frame-to-frame (a real tracker would follow them) but
    violate the static-world model, which judge_track_status /
    update_track_status must detect."""
    key = jax.random.PRNGKey(seed)
    c0 = jnp.asarray(center, dtype=dtype)
    v = jnp.asarray(vel, dtype=dtype)
    w = jnp.asarray(omega_obj, dtype=dtype)
    local = jax.random.uniform(key, (n_points, 3), minval=-extent,
                               maxval=extent, dtype=dtype)

    def at(t):
        R = lie.quat_to_matrix(lie.expmap(w * t))
        return c0 + v * t + local @ R.T

    return jax.vmap(at)(scene.t)


def bearings_of_points(q, p, pts, q_bc, p_bc, fov_cos: float = 0.2):
    """Project per-frame world points into each frame's camera.

    q (F,4), p (F,3): body poses; pts (F,L,3) per-frame point positions
    (time-varying — use `jnp.broadcast_to` for static sets). Returns
    (bearings (F,L,3), mask (F,L)) like `bearings_of`."""
    x_b = jax.vmap(lambda qk, pk, xk: lie.quat_rotate_inv(qk, xk - pk))(q, p, pts)
    x_c = jax.vmap(lambda xb: lie.quat_rotate_inv(q_bc, xb - p_bc))(x_b)
    depth = x_c[..., 2]
    norm = jnp.linalg.norm(x_c, axis=-1)
    bearings = x_c / jnp.maximum(norm, 1e-12)[..., None]
    mask = (depth > 0.2) & (bearings[..., 2] > fov_cos)
    return bearings, mask


def bearings_of(scene: Scene, q_bc, p_bc, frame_idx=None, fov_cos: float = 0.2):
    """Project landmarks into every (selected) frame's camera.

    Returns (bearings (F,L,3) unit camera-frame vectors, mask (F,L) —
    in-front-of-camera with viewing angle inside the FOV cone).
    """
    q = scene.q if frame_idx is None else scene.q[frame_idx]
    p = scene.p if frame_idx is None else scene.p[frame_idx]
    # world → body → camera
    x_b = jax.vmap(lambda qk, pk: lie.quat_rotate_inv(qk, scene.landmarks - pk))(q, p)
    x_c = jax.vmap(lambda xb: lie.quat_rotate_inv(q_bc, xb - p_bc))(x_b)
    depth = x_c[..., 2]
    norm = jnp.linalg.norm(x_c, axis=-1)
    bearings = x_c / jnp.maximum(norm, 1e-12)[..., None]
    mask = (depth > 0.2) & (bearings[..., 2] > fov_cos)
    return bearings, mask


def demo_window_problem(K, L, dtype, stride=2, n_lm=None):
    """Canonical benchmark/scaling fixture: a circle-scene window with
    the standard camera extrinsics — shared by __graft_entry__,
    bench.py, and tools/run_scaling.py (importable from the package, so
    the tools work from any working directory)."""
    from ..geometry import lie

    n_lm = n_lm or (L - 8)
    scene = euler_consistent(
        circle_scene(n_frames=K * stride + 1, n_landmarks=n_lm, dtype=dtype)
    )
    q_bc = lie.expmap(jnp.array([-jnp.pi / 2, 0.0, 0.0], dtype=dtype))
    p_bc = jnp.array([0.02, -0.01, 0.03], dtype=dtype)
    return window_problem(
        scene, list(range(0, K * stride, stride)), L=L, q_bc=q_bc, p_bc=p_bc,
        dtype=dtype,
    )
