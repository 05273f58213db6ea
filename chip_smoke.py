"""Smoke test of the VIO main path on one GPU (or the sharded solves on four).

    python chip_smoke.py               # one card: device, parity, drives
    python chip_smoke.py --four-cards  # only the sharded solves, on 4 cards

Phases (one card):
  1. Device: JAX devices and versions, x64, compile cache, native host
     library, and the card's name and power limit from nvidia-smi. A
     platform other than "gpu" exits non-zero; nothing falls back to the
     CPU.
  2. Kernel parity at EuRoC width (752x480, 256 keypoints, K=10/L=384):
     every jitted main-path stage runs on the card in f32 and on the CPU
     backend of the same process (the plain reference), each fed the
     same inputs. One line per comparison, each number beside its
     tolerance; the card's median time of each stage follows.
  3. Drive: a rendered EuRoC-geometry sequence through
     tools.run_dataset.run_sequence, default schedule (cold, then warm),
     with PARSAC, and with the overlapped write-back schedule. Gates:
     first tracked frame <= 32, zero resets, ATE < 0.06 m.

The last line of stdout is one JSON object naming the device; any failed
phase raises and the script exits non-zero before printing it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time


def _fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(2)


# --------------------------------------------------------------------------
# comparisons
# --------------------------------------------------------------------------

class Checks:
    """Collects comparison lines; `done()` raises if any failed."""

    def __init__(self):
        self.failed = []

    def line(self, name: str, ok: bool, gated: bool = True, **fields):
        parts = []
        for k, (v, tol) in fields.items():
            vs = f"{v:.3e}" if isinstance(v, float) else str(v)
            ts = f"{tol:.1e}" if isinstance(tol, float) else str(tol)
            parts.append(f"{k}={vs} (tol {ts})")
        status = ("OK" if ok else "FAIL") if gated else "not gated"
        print(f"PARITY {name}: " + " ".join(parts) + f"  {status}", flush=True)
        if gated and not ok:
            self.failed.append(name)

    def close(self, name, got, ref, abs_tol=None, rel_tol=None):
        import numpy as np

        got = np.asarray(got, np.float64)
        ref = np.asarray(ref, np.float64)
        if got.shape != ref.shape:
            self.line(name, False, shape=(str(got.shape), str(ref.shape)))
            return
        err = float(np.max(np.abs(got - ref))) if got.size else 0.0
        scale = float(np.max(np.abs(ref))) if ref.size else 0.0
        rel = err / max(scale, 1e-30)
        ok = bool(np.all(np.isfinite(got)))
        if abs_tol is not None:
            ok &= err <= abs_tol
        if rel_tol is not None:
            ok &= rel <= rel_tol
        self.line(name + " [f32]", ok,
                  max_abs=(err, "-" if abs_tol is None else abs_tol),
                  rel=(rel, "-" if rel_tol is None else rel_tol))

    def agree(self, name, got, ref, max_disagree: int):
        import numpy as np

        got, ref = np.asarray(got, bool), np.asarray(ref, bool)
        n = int(np.sum(got != ref))
        self.line(name + " [f32]", n <= max_disagree and got.shape == ref.shape,
                  disagree=(n, max_disagree), n_ref=(int(ref.sum()), "-"))

    def done(self, phase: str):
        if self.failed:
            raise AssertionError(f"{phase}: failed {self.failed}")


def _median_ms(fn, *args, reps: int = 10) -> float:
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2] * 1e3


class CompileClock:
    """Sums XLA backend-compile seconds (also per jitted function) and
    persistent-cache hits."""

    def __init__(self):
        import collections

        import jax

        self.seconds = 0.0
        self.hits = 0
        self.by_fun = collections.defaultdict(lambda: [0, 0.0])

        def on_duration(event, duration, fun_name="?", **_):
            if event == "/jax/core/compile/backend_compile_duration":
                self.seconds += duration
                self.by_fun[fun_name][0] += 1
                self.by_fun[fun_name][1] += duration

        def on_event(event, **_):
            if event == "/jax/compilation_cache/cache_hits":
                self.hits += 1

        jax.monitoring.register_event_duration_secs_listener(on_duration)
        jax.monitoring.register_event_listener(on_event)

    def mark(self):
        return self.seconds, self.hits

    def top(self, n=10):
        rows = sorted(self.by_fun.items(), key=lambda kv: -kv[1][1])[:n]
        return "; ".join(f"{k} x{c} {s:.1f}s" for k, (c, s) in rows)


# --------------------------------------------------------------------------
# phase 1: device
# --------------------------------------------------------------------------

def phase_device(expected_count: int):
    import jax
    import jaxlib

    devs = jax.devices()
    print(f"devices: {devs}")
    print(f"jax {jax.__version__} jaxlib {jaxlib.__version__} "
          f"python {sys.version.split()[0]}")
    if devs[0].platform != "gpu":
        _fail(f"no GPU: JAX platform is {devs[0].platform!r}")
    if len(devs) < expected_count:
        _fail(f"need {expected_count} GPUs, JAX sees {len(devs)}")

    from xrslam_tpu import native, runtime

    cache = runtime.configure()
    print(f"x64: {jax.config.jax_enable_x64}  matmul precision: "
          f"{jax.config.jax_default_matmul_precision}")
    print(f"compile cache: {cache}")
    print("host library: " + ("native (native/libxr_host.so)"
                              if native.available() else "pure-Python fallback"))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    return devs


# --------------------------------------------------------------------------
# phase 2: kernel parity
# --------------------------------------------------------------------------

def _perturbed_window(K, L, seed, dtype):
    """Ground-truth window of the circle scene and a perturbed start
    (frame 0 held fixed by the gauge prior)."""
    import jax.numpy as jnp
    import numpy as np

    from xrslam_tpu.estimation.window import MargPrior
    from xrslam_tpu.geometry import lie
    from xrslam_tpu.io.synthetic import demo_window_problem

    gt, data = demo_window_problem(K, L, dtype)
    data = data._replace(marg=MargPrior.gauge_fix(K, L, gt, dtype=dtype),
                         use_marg=jnp.asarray(True))
    rng = np.random.default_rng(seed)
    m = np.ones((K, 1))
    m[0] = 0.0

    def n(shape, s):
        return jnp.asarray(s * rng.standard_normal(shape) * m, dtype)

    st0 = gt._replace(
        q=lie.quat_normalize(lie.quat_mul(gt.q, lie.expmap(n((K, 3), 0.005)))),
        p=gt.p + n((K, 3), 0.01), v=gt.v + n((K, 3), 0.01),
        inv_depth=gt.inv_depth * jnp.asarray(
            1.0 + 0.01 * rng.standard_normal(L), dtype))
    return gt, st0, data


def _state_diff(a, b):
    """(max rotation angle rad, max position m, max rel inverse depth)."""
    import numpy as np

    qa, qb = np.asarray(a.q, np.float64), np.asarray(b.q, np.float64)
    # vector part of conj(qa)·qb ([w,x,y,z]); its norm is sin(angle/2)
    vec = (qa[..., :1] * qb[..., 1:] - qb[..., :1] * qa[..., 1:]
           - np.cross(qa[..., 1:], qb[..., 1:]))
    rot = float(np.max(2.0 * np.arcsin(np.linalg.norm(vec, axis=-1).clip(0, 1))))
    pos = float(np.max(np.abs(np.asarray(a.p) - np.asarray(b.p))))
    da, db = np.asarray(a.inv_depth, np.float64), np.asarray(b.inv_depth, np.float64)
    invd = float(np.max(np.abs(da - db) / np.maximum(np.abs(db), 1e-6)))
    return rot, pos, invd


def phase_parity(gpu, cpu, frames):
    """`frames`: two consecutive rendered (H,W) float32 [0,1] images."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from xrslam_tpu.estimation.marginalization import marginalize_frame
    from xrslam_tpu.estimation.solver import (SolveOptions, solve_window,
                                              solve_window_core)
    from xrslam_tpu.frontend import image as img_ops
    from xrslam_tpu.frontend import klt
    from xrslam_tpu.geometry import lie
    from xrslam_tpu.imu import preintegration as pre
    from xrslam_tpu.io.synthetic import euler_consistent, wave_scene
    from xrslam_tpu.ransac import pnp as pnp_mod
    from xrslam_tpu.ransac import stereo as stereo_mod

    chk = Checks()
    times = {}

    def both(fn, *args, timed=None):
        """fn on the card and on the CPU, from the same host inputs."""
        host = jax.device_get(args)
        out_g = fn(*jax.device_put(host, gpu))
        with jax.default_device(cpu):
            out_c = fn(*jax.device_put(host, cpu))
        if timed:
            times[timed] = _median_ms(fn, *jax.device_put(host, gpu))
        return jax.device_get(out_g), jax.device_get(out_c)

    clahe = jax.jit(lambda im: img_ops.clahe(im * 255.0, 6.0, 8, 8))
    g0, c0 = both(clahe, frames[0], timed="clahe")
    _, c1 = both(clahe, frames[1])
    # one LUT level: each tile's CDF is an f32 cumsum whose rounding at
    # a .5 boundary may differ between backends
    chk.close("clahe 752x480", g0, c0, abs_tol=1.0 + 1e-3)
    mean = float(np.mean(np.abs(g0 - c0)))
    chk.line("clahe 752x480 mean [f32]", mean <= 1e-2, mean_abs=(mean, 1e-2))

    def pyr_scharr(im):
        pyr = img_ops.build_pyramid(im, 3)
        return pyr, [img_ops.scharr(p) for p in pyr]

    pyr_scharr = jax.jit(pyr_scharr)
    (pg, sg), (pc, sc) = both(pyr_scharr, c0, timed="pyramid+scharr")
    # exact-tap f32 shift-and-add filters: only FMA contraction differs
    for lev in range(4):
        chk.close(f"pyramid L{lev}", pg[lev], pc[lev], rel_tol=1e-5)
        chk.close(f"scharr L{lev}", np.stack(sg[lev]), np.stack(sc[lev]),
                  rel_tol=1e-5)

    harris = jax.jit(img_ops.harris_response)
    hg, hc = both(harris, c0, timed="harris")
    # products of gradient sums over a 3x3 box: f32 rounding of ~1e9
    # values in another summation order
    chk.close("harris response", hg, hc, rel_tol=1e-4)

    cand = jax.jit(lambda im: img_ops.gftt_candidates(im, 1024))
    (cg, _, vg), (cc, _, vc) = both(cand, c0, timed="gftt score+top_k")
    sg_ = {tuple(p) for p in np.asarray(cg)[np.asarray(vg)]}
    sc_ = {tuple(p) for p in np.asarray(cc)[np.asarray(vc)]}
    # responses within rounding of each other may swap across the
    # 1024th place; the sets must otherwise coincide
    chk.line("gftt candidates (set) [f32]", len(sg_ ^ sc_) <= 4,
             sym_diff=(len(sg_ ^ sc_), 4), n_ref=(len(sc_), "-"))

    no_pre = np.zeros((1, 2), np.float32), np.zeros((1,), bool)
    mdf = jax.jit(lambda c, v, p, pv: img_ops.min_distance_filter(
        c, v, p, pv, 20.0, max_out=256))
    ag, ac = both(mdf, cc, vc, *no_pre, timed="min_distance_filter scan")
    chk.agree("min_distance_filter accept", ag, ac, max_disagree=0)

    order = np.argsort(~np.asarray(ac), kind="stable")[:256]
    pts = np.asarray(cc)[order].astype(np.float32)
    ok = np.asarray(ac)[order]
    track = jax.jit(lambda p0, p1, x, v: klt.track_keypoints(p0, p1, x, x, v))
    pyr1 = jax.jit(lambda im: img_ops.build_pyramid(im, 3))(
        jax.device_put(c1, cpu))
    (ng, stg), (nc, stc) = both(track, pc, jax.device_get(pyr1), pts, ok,
                                timed="track_keypoints fwd+bwd (xla)")
    chk.agree("track_keypoints status", stg, stc, max_disagree=3)
    both_ok = np.asarray(stg) & np.asarray(stc)
    # LK stops once a step is below eps = 0.01 px; the two backends may
    # stop one step apart
    chk.close("track_keypoints px", np.asarray(ng)[both_ok],
              np.asarray(nc)[both_ok], abs_tol=0.05)

    # the hat-selector (while_loop) level tracker, timed for the record;
    # the backend is read while tracing, so the trace caches are
    # cleared on the way in and out
    host = jax.device_get((pc, pyr1, pts, ok))
    os.environ["XR_LK_BACKEND"] = "mxu"
    try:
        jax.clear_caches()
        times["track_keypoints fwd+bwd (mxu, while_loop)"] = _median_ms(
            track, *jax.device_put(host, gpu))
    finally:
        del os.environ["XR_LK_BACKEND"]
        jax.clear_caches()

    # ---- window solve, with and without the precision pin ----
    gt, st0, data = _perturbed_window(10, 384, seed=0, dtype=jnp.float32)
    opts = SolveOptions(iterations=10)
    (sg1, ig), (sc1, ic) = both(lambda s, d: solve_window(s, d, opts),
                                st0, data, timed="solve_window K10 L384")
    # the same solve traced without the pin: f32 matmuls at the
    # platform's default precision (TF32 on this card)
    with jax.default_matmul_precision("default"):
        solve_unpinned = jax.jit(lambda s, d: solve_window_core(s, d, opts))
        su, iu = jax.device_get(solve_unpinned(*jax.device_put(
            jax.device_get((st0, data)), gpu)))
    for tag, s_, i_ in (("pinned highest", sg1, ig), ("unpinned default", su, iu)):
        rot, pos, invd = _state_diff(s_, sc1)
        # f32 LM from the same start: the converged states agree to the
        # f32 resolution of a ~10 m scene, far below the drive gates
        chk.line(f"solve_window K10 L384 vs CPU [f32, {tag}]",
                 rot <= 1e-3 and pos <= 1e-3 and invd <= 1e-3
                 and float(i_["cost"]) < float(i_["cost0"]),
                 gated=tag.startswith("pinned"),
                 rot_rad=(rot, 1e-3), pos_m=(pos, 1e-3), invd_rel=(invd, 1e-3),
                 cost=(float(i_["cost"]), f"< cost0 {float(i_['cost0']):.3e}"))

    marg = jax.jit(lambda s, d: marginalize_frame(s, d, victim=0))
    mg, mc = both(marg, gt, data, timed="marginalize_frame K10 L384")

    def info(m):
        S = np.asarray(m.sqrt_inv_cov, np.float64)
        return S.T @ S, S.T @ np.asarray(m.infovec, np.float64)

    # the prior's square root comes from an eigendecomposition whose
    # vector signs and order are solver-defined: compare the information
    # S'S (and S'r) it encodes; f32 sums over hundreds of landmarks
    Hg, bg_ = info(mg)
    Hc, bc_ = info(mc)
    chk.close("marginalization information S'S", Hg, Hc, rel_tol=1e-3)
    chk.close("marginalization gradient S'r", bg_, bc_,
              abs_tol=1e-3 * max(1.0, float(np.max(np.abs(Hc)))) ** 0.5)

    # ---- IMU preintegration: 10 camera intervals at 200 Hz ----
    scene = euler_consistent(wave_scene(n_frames=12, n_landmarks=8, seed=1))
    ts = np.asarray(scene.imu_t[:10]).reshape(-1)
    ws = np.asarray(scene.imu_w[:10]).reshape(-1, 3).astype(np.float32)
    acc = np.asarray(scene.imu_a[:10]).reshape(-1, 3).astype(np.float32)
    t_end = float(scene.t[10]) - float(ts[0])
    ts = (ts - ts[0]).astype(np.float32)
    noise = jax.device_get(pre.ImuNoise.isotropic(1e-4, 1e-2, 1e-8, 1e-6,
                                                  dtype=jnp.float32))
    z3 = np.zeros(3, np.float32)
    integ = jax.jit(lambda t, w, a, te, b, nz: pre.integrate(t, w, a, te, b, b, nz))
    dg, dc = both(integ, ts, ws, acc, np.float32(t_end), z3, noise,
                  timed="imu integrate 100 samples")
    chk.close("preintegration dq", dg.q, dc.q, abs_tol=1e-5)
    chk.close("preintegration dp dv", np.concatenate([dg.p, dg.v]),
              np.concatenate([dc.p, dc.v]), rel_tol=1e-4)
    chk.close("preintegration cov", dg.cov, dc.cov, rel_tol=1e-3)

    # ---- RANSAC on noise-free correspondences with planted outliers:
    # batched small eigh/svd may return other signs or order, so compare
    # inlier sets and the model's residuals, not raw vectors ----
    rng = np.random.default_rng(7)
    N, n_out = 200, 40
    X = np.c_[rng.uniform(-2, 2, (N, 2)), rng.uniform(4, 8, N)]
    R = np.asarray(lie.quat_to_matrix(lie.expmap(jnp.asarray([0.08, -0.05, 0.03]))),
                   np.float64)
    t = np.array([0.4, 0.1, -0.2])
    X2 = X @ R.T + t
    p1 = X[:, :2] / X[:, 2:3]
    p2 = X2[:, :2] / X2[:, 2:3]
    kick = rng.uniform(0.05, 0.3, (N, 2)) * rng.choice([-1, 1], (N, 2))
    is_out = np.arange(N) < n_out
    p2o = np.where(is_out[:, None], p2 + kick, p2).astype(np.float32)
    h1 = np.c_[p1, np.ones(N)].astype(np.float32)
    h2 = np.c_[p2o, np.ones(N)].astype(np.float32)
    key = np.asarray(jax.random.PRNGKey(3))

    def ess(k, a, b):
        return stereo_mod.find_essential_matrix(k, a, b, threshold=1.0 / 458.0)

    (_, mg_, _), (_, mc_, _) = both(ess, key, h1, h2, timed="essential RANSAC 5pt x64")
    chk.agree("essential RANSAC inliers", mg_, mc_, max_disagree=2)
    chk.agree("essential RANSAC vs truth", mg_, ~is_out, max_disagree=4)

    plane = np.c_[rng.uniform(-2, 2, (N, 2)), np.full(N, 5.0)]
    P2 = plane @ R.T + t
    q1 = (plane[:, :2] / plane[:, 2:3]).astype(np.float32)
    q2 = np.where(is_out[:, None], P2[:, :2] / P2[:, 2:3] + kick,
                  P2[:, :2] / P2[:, 2:3]).astype(np.float32)

    def hom(k, a, b):
        return stereo_mod.find_homography_matrix(k, a, b, threshold=1.0 / 458.0)

    (_, hg_, _), (_, hc_, _) = both(hom, key, q1, q2, timed="homography RANSAC 4pt x128")
    chk.agree("homography RANSAC inliers", hg_, hc_, max_disagree=2)
    chk.agree("homography RANSAC vs truth", hg_, ~is_out, max_disagree=4)

    def pnp(k, a, b):
        return pnp_mod.find_pnp_matrix(k, a, b, threshold=2.0 / 458.0)

    (Tg, pg_, _), (_, pc_, _) = both(pnp, key, X.astype(np.float32), p2o,
                                      timed="PnP RANSAC DLT x256")
    chk.agree("PnP RANSAC inliers", pg_, pc_, max_disagree=2)
    chk.agree("PnP RANSAC vs truth", pg_, ~is_out, max_disagree=4)
    chk.close("PnP pose (R|t) vs truth", np.asarray(Tg)[:3],
              np.c_[R, t], abs_tol=1e-2)

    for name, ms in times.items():
        print(f"TIME {name}: {ms:.3f} ms (card, median of 10)", flush=True)
    chk.done("kernel parity")


# --------------------------------------------------------------------------
# phase 3: drives
# --------------------------------------------------------------------------

def render_proxy(out_dir, n_frames=60, width=752, height=480, focal=458.0,
                 n_landmarks=700, seed=5):
    """The EuRoC-geometry proxy scene of tests/test_euroc_proxy.py."""
    from xrslam_tpu.tools.make_dataset import render_dataset

    return render_dataset(out_dir, n_frames=n_frames, n_landmarks=n_landmarks,
                          width=width, height=height, focal=focal, seed=seed)


def drive(name, paths, clock, first_max=32, ate_max=0.06, **overrides):
    """One run of the sequence through run_sequence, gated."""
    import dataclasses

    import numpy as np

    from xrslam_tpu.config import load_config
    from xrslam_tpu.io.dataset import _read_camera_csv
    from xrslam_tpu.tools.run_dataset import evaluate_ate, run_sequence

    cfg = dataclasses.replace(
        load_config(paths["slam_yaml"], paths["device_yaml"]), **overrides)
    root = paths["root"]
    stamps = np.asarray([t for t, _ in _read_camera_csv(
        os.path.join(root, "cam0", "data.csv"))])
    c0, h0 = clock.mark()
    t0 = time.perf_counter()
    ts, _, ps = run_sequence("euroc://" + root, cfg, async_reader=False)
    wall = time.perf_counter() - t0
    c1, h1 = clock.mark()
    ts = np.asarray(ts)
    first = int(np.argmin(np.abs(stamps - ts[0]))) if len(ts) else -1
    tail = stamps[first:] if len(ts) else stamps
    resets = 0 if (len(ts) == len(tail) and np.allclose(ts, tail, atol=1e-6)) \
        else max(1, len(tail) - len(ts))
    ate = evaluate_ate(root, ts, ps) if len(ts) else float("nan")
    ok = (len(ts) > 0 and first <= first_max and resets == 0
          and bool(np.isfinite(ate)) and ate < ate_max)
    print(f"DRIVE {name}: frames_tracked={len(ts)}/{len(stamps)} "
          f"first_tracked_frame={first} (gate <= {first_max}) "
          f"resets={resets} (gate 0) ate_m={ate:.4f} (gate < {ate_max}) "
          f"wall_fps={len(stamps) / wall:.2f} wall_s={wall:.2f} "
          f"compile_s={c1 - c0:.2f} cache_hits={h1 - h0}"
          + ("  OK" if ok else "  FAIL"), flush=True)
    return ok


def phase_drive(paths, clock):
    runs = [("default f32 (cold)", {}), ("default f32 (warm)", {}),
            ("parsac", {"parsac_flag": True}),
            ("worker_overlap+pipelined_writeback",
             {"worker_overlap": True, "pipelined_writeback": True})]
    failed = []
    for name, kw in runs:
        if not drive(name, paths, clock, **kw):
            failed.append(name)
        if name.endswith("(cold)"):
            print(f"COMPILE top after cold drive: {clock.top()}", flush=True)
    if failed:
        raise AssertionError(f"drive gates failed: {failed}")


# --------------------------------------------------------------------------
# four cards: the sharded solves against one card
# --------------------------------------------------------------------------

def phase_four_cards(devs):
    import jax
    import jax.numpy as jnp

    from xrslam_tpu.estimation.solver import SolveOptions, solve_window, solve_window_core
    from xrslam_tpu.parallel import sharded
    from xrslam_tpu.parallel.mesh import make_mesh

    chk = Checks()
    opts = SolveOptions(iterations=10)
    one = devs[0]
    # f32 psum over 4 landmark shards sums in another order than one
    # card; the converged states agree to f32 resolution
    tol = dict(rot=1e-3, pos=1e-3, invd=1e-3)

    def cmp(name, a, b, ia, ib):
        rot, pos, invd = _state_diff(a, b)
        chk.line(name + " [f32]",
                 rot <= tol["rot"] and pos <= tol["pos"] and invd <= tol["invd"],
                 rot_rad=(rot, tol["rot"]), pos_m=(pos, tol["pos"]),
                 invd_rel=(invd, tol["invd"]),
                 cost=(f"{float(ia['cost']):.4e}", f"ref {float(ib['cost']):.4e}"))

    mesh_model = make_mesh(4, shape=(1, 4), devices=devs[:4])
    for K, L in ((10, 384), (32, 1024)):
        _, st0, data = _perturbed_window(K, L, seed=K, dtype=jnp.float32)
        s0, d0 = jax.device_put((st0, data), one)
        s1, i1 = jax.device_get(solve_window(s0, d0, opts))
        s4, d4 = sharded.shard_window(mesh_model, st0, data)
        s_sh, i_sh = jax.device_get(sharded.solve_window_sharded(mesh_model, s4, d4, opts))
        cmp(f"solve_window_sharded (1,4) K{K} L{L} vs one card", s_sh, s1, i_sh, i1)
        t1 = _median_ms(lambda: solve_window(s0, d0, opts))
        t4 = _median_ms(lambda: sharded.solve_window_sharded(mesh_model, s4, d4, opts))
        print(f"TIME solve K{K} L{L}: one card {t1:.3f} ms, (1,4) mesh {t4:.3f} ms",
              flush=True)

    mesh_data = make_mesh(4, shape=(4, 1), devices=devs[:4])
    probs = [_perturbed_window(10, 384, seed=100 + i, dtype=jnp.float32)
             for i in range(4)]
    sts = jax.tree.map(lambda *x: jnp.stack(x), *[p[1] for p in probs])
    dts = jax.tree.map(lambda *x: jnp.stack(x), *[p[2] for p in probs])
    vm = jax.jit(jax.vmap(lambda s, d: solve_window_core(s, d, opts)))
    sts1, dts1 = jax.device_put((sts, dts), one)
    sv, iv = jax.device_get(vm(sts1, dts1))
    sb, ib = jax.device_get(sharded.solve_batch_sharded(mesh_data, sts, dts, opts))
    for i in range(4):
        pick = (lambda x, i=i: x[i])
        cmp(f"solve_batch_sharded (4,1) sequence {i} vs vmap on one card",
            jax.tree.map(pick, sb), jax.tree.map(pick, sv),
            jax.tree.map(pick, ib), jax.tree.map(pick, iv))
    tv = _median_ms(lambda: vm(sts1, dts1))
    tb = _median_ms(lambda: sharded.solve_batch_sharded(mesh_data, sts, dts, opts))
    print(f"TIME 4 windows K10 L384: vmap one card {tv:.3f} ms, (4,1) mesh {tb:.3f} ms",
          flush=True)
    chk.done("four cards")


# --------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded solves on a 4-card mesh")
    args = ap.parse_args(argv)
    count = 4 if args.four_cards else 1

    import jax

    devs = phase_device(count)
    gpu = devs[0]
    clock = CompileClock()
    if args.four_cards:
        phase_four_cards(devs)
    else:
        import numpy as np

        from xrslam_tpu.io.png import load_gray

        cpu = jax.devices("cpu")[0]
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            t0 = time.perf_counter()
            paths = render_proxy(tmp)
            print(f"render: 60 frames 752x480 in {time.perf_counter() - t0:.1f} s",
                  flush=True)
            names = sorted(os.listdir(os.path.join(paths["root"], "cam0", "data")))
            frames = [np.asarray(load_gray(os.path.join(
                paths["root"], "cam0", "data", n)), np.float32) for n in names[10:12]]
            c0, _ = clock.mark()
            phase_parity(gpu, cpu, frames)
            print(f"parity compile_s={clock.mark()[0] - c0:.2f} (card and CPU)",
                  flush=True)
            phase_drive(paths, clock)
    print(json.dumps({"ok": True, "device": {
        "platform": gpu.platform, "kind": gpu.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
