"""Benchmark: full per-frame VIO compute on one chip.

One "frame" is the per-keyframe hot path of the pipeline on a
EuRoC-size (752x480) image (reference call stack SURVEY.md §3.1):
  - CLAHE preprocess + 3-level LK pyramid (opencv_image.cpp:156-161)
  - GFTT corner candidates (opencv_image.cpp:184-188)
  - forward+backward pyramidal KLT, 256 keypoints, 21x21 window,
    30 iterations (opencv_image.cpp:75-154)
  - one full 10-iteration LM sliding-window VI-BA solve at the
    reference configuration (K=10 keyframes — config.cpp:16 — L=256
    landmark slots; refine_window, sliding_window_tracker.cpp:247-358)

Baseline: the reference runs EuRoC real time on CPU at the 20 Hz camera
rate (docs/en/benchmark.md), so vs_baseline = frames_per_s / 20.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"device"}.
"""

import json
import time


def main():
    import numpy as np
    import jax
    import jax.numpy as jnp

    from xrslam_tpu import runtime
    from xrslam_tpu.estimation.solver import SolveOptions, solve_window
    from xrslam_tpu.frontend import image as img_ops
    from xrslam_tpu.frontend import klt
    from __graft_entry__ import _problem

    runtime.configure()
    H, W, C = 480, 752, 256
    rng = np.random.default_rng(0)
    base = np.kron(rng.uniform(0, 1, (H // 4, W // 4)), np.ones((4, 4)))
    img1 = jnp.asarray(base.astype(np.float32))
    img2 = jnp.asarray(np.roll(base, (2, 3), axis=(0, 1)).astype(np.float32))
    pts = jnp.asarray(rng.uniform(40, 400, (C, 2)).astype(np.float32))
    pvalid = jnp.ones((C,), bool)

    preprocess = jax.jit(lambda im: img_ops.build_pyramid(
        img_ops.clahe(im * 255.0), levels=3))
    detect = lambda im: img_ops.gftt_candidates(im)[0]

    K, L = 10, 256
    state, data = _problem(K=K, L=L, dtype=jnp.float32, n_lm=120)
    opts = SolveOptions(iterations=10)
    solve = jax.jit(lambda s, d: solve_window(s, d, opts)[1]["cost"])

    pyr_prev = preprocess(img1)  # previous frame's pyramid is cached
    jax.block_until_ready(pyr_prev)

    def frame(im2, s, d):
        pyr2 = preprocess(im2)
        cand = detect(pyr2[0])
        nxt, st = klt.track_keypoints(pyr_prev, pyr2, pts, pts, pvalid)
        cost = solve(s, d)
        return nxt, st, cand, cost

    # compile + warmup
    out = frame(img2, state, data)
    jax.block_until_ready(out)

    n_reps = 30
    t0 = time.perf_counter()
    for _ in range(n_reps):
        out = frame(img2, state, data)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0

    frames_per_s = n_reps / dt
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "vio_frames_per_s",
        "value": round(frames_per_s, 2),
        "unit": "frames/s (752x480, 256 kp KLT fwd+bwd, GFTT, K=10/L=256 10-iter BA)",
        "vs_baseline": round(frames_per_s / 20.0, 2),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
