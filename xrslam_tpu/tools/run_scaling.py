"""Scaling-efficiency harness for the distributed Schur BA.

Measures batched sliding-window solve throughput (windows/s) on
1/2/4/8-device meshes and reports parallel efficiency vs the 1-device
rate. The reference has no distributed path at all (its Ceres solve is
single-threaded, xrslam/src/xrslam/estimation/solver.cpp:176-190);
this harness quantifies the scale-out design of
`xrslam_tpu.parallel.sharded` (BASELINE.json north-star: frames/s
scaling efficiency at 1 chip / N devices).

Because the host-platform device count is fixed at process start
(XLA_FLAGS=--xla_force_host_platform_device_count=N), each mesh size
runs in its own subprocess; the parent collects one JSON line per size
and prints an efficiency table.

Two modes per device count:
  - data:  B windows shard over the data axis (throughput scaling —
           the 11-sequence EuRoC sweep deployment),
  - model: ONE window's landmark columns shard over the model axis
           (latency scaling — the large-window dense-map deployment).

Usage:
  python -m xrslam_tpu.tools.run_scaling [--devices 1 2 4 8]
      [--batch 8] [--frames 8] [--landmarks 256] [--iters 10]
      [--reps 5] [--json out.json]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def _child(args) -> None:
    """Measure solve throughput on this process's devices; print JSON."""
    import jax

    # a site-wide customization may re-register an accelerator backend
    # and rewrite jax_platforms in-process; the env var alone is not
    # enough — pin CPU both ways or the child silently runs (and
    # contends) on a single real accelerator
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from xrslam_tpu.estimation.solver import SolveOptions, solve_window
    from xrslam_tpu.parallel import sharded
    from xrslam_tpu.parallel.mesh import make_mesh

    n = jax.device_count()
    opts = SolveOptions(iterations=args.iters)

    from xrslam_tpu.io.synthetic import demo_window_problem as _problem

    if args.mode == "data":
        mesh = make_mesh(n, shape=(n, 1))
        B, K, L = args.batch, args.frames, args.landmarks
        state, data = _problem(K=K, L=L, dtype=jnp.float32, n_lm=L - 8)
        bs = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), state)
        bd = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), data)
        run = lambda: sharded.solve_batch_sharded(mesh, bs, bd, opts)
        work = B  # windows per run
    elif args.mode == "model":
        mesh = make_mesh(n, shape=(1, n))
        K, L = args.frames, args.landmarks
        state, data = _problem(K=K, L=L, dtype=jnp.float32, n_lm=L - 8)
        state, data = sharded.shard_window(mesh, state, data)
        run = lambda: sharded.solve_window_sharded(mesh, state, data, opts)
        work = 1
    else:  # single-device reference (no shard_map at all)
        state, data = _problem(K=args.frames, L=args.landmarks,
                               dtype=jnp.float32, n_lm=args.landmarks - 8)
        run = lambda: solve_window(state, data, opts)
        work = 1

    out, info = run()
    jax.block_until_ready(info["cost"])  # compile + warm
    t0 = time.perf_counter()
    for _ in range(args.reps):
        out, info = run()
    jax.block_until_ready(info["cost"])
    dt = (time.perf_counter() - t0) / args.reps
    print(json.dumps({
        "devices": n, "mode": args.mode, "windows_per_s": work / dt,
        "solve_ms": dt * 1e3, "cost_finite": bool(
            jnp.isfinite(info["cost"]).all()),
    }))


def _spawn(n: int, argv, mode: str):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + f" --xla_force_host_platform_device_count={n}")
    cmd = [sys.executable, "-m", "xrslam_tpu.tools.run_scaling",
           "--child", "--mode", mode] + argv
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=1200)
    if out.returncode != 0:
        raise RuntimeError(f"scaling child n={n} failed:\n{out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--landmarks", type=int, default=256)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--mode", choices=["data", "model", "single"],
                    default="data")
    ap.add_argument("--modes", nargs="+", default=None,
                    help="parent: run these modes (default: data model)")
    ap.add_argument("--match-batch", action="store_true",
                    help="data mode: batch = device count (weak scaling, "
                         "one sequence-window per device — the EuRoC "
                         "multi-sequence deployment shape)")
    ap.add_argument("--child", action="store_true")
    ap.add_argument("--json", help="write full results to this path")
    args = ap.parse_args(argv)

    if args.child:
        _child(args)
        return

    results = {}
    for mode in (args.modes or ["data", "model"]):
        rows = []
        for n in args.devices:
            fwd = []
            for k in ("batch", "frames", "landmarks", "iters", "reps"):
                v = getattr(args, k)
                if k == "batch" and args.match_batch and mode == "data":
                    v = n
                fwd += [f"--{k}", str(v)]
            r = _spawn(n, fwd, mode)
            base = rows[0]["windows_per_s"] if rows else r["windows_per_s"]
            dev0 = rows[0]["devices"] if rows else r["devices"]
            r["speedup"] = r["windows_per_s"] / base
            r["efficiency"] = r["speedup"] / (r["devices"] / dev0)
            rows.append(r)
            print(f"[{mode}] {n} devices: {r['windows_per_s']:.1f} windows/s"
                  f"  speedup {r['speedup']:.2f}x"
                  f"  efficiency {r['efficiency']:.0%}", file=sys.stderr)
        results[mode] = rows

    print(json.dumps(results))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2)


if __name__ == "__main__":
    main()
