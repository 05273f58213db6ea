"""Pipeline benchmark: the REAL sequence drive, end to end.

Unlike bench.py (per-frame kernel composite), this renders a synthetic
EuRoC-layout dataset once and drives the full stack — PNG decode →
reader → api.XRSLAM → CLAHE/GFTT/KLT → initializer → sliding window →
marginalization → TUM/ATE — on the default backend, reporting
sequence fps and the per-stage timing
breakdown (reference inspection items feature_tracker_time /
bundle_adjustor_solve_time / bundle_adjustor_marginalization_time,
include/xrslam/inspection.h:53-55).

Pass 1 warms every jit cache; the later passes are timed and their
median is reported, with every pass listed. Baseline: the reference
plays EuRoC in real time on CPU at the 20 Hz camera rate.

Prints ONE JSON line.
"""

import argparse
import json
import os
import tempfile
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--landmarks", type=int, default=500)
    ap.add_argument("--dir", default=os.path.join(tempfile.gettempdir(),
                                                  "xrslam_bench_seq"))
    ap.add_argument("--passes", type=int, default=4)
    # EuRoC geometry: --width 752 --height 480 --focal 458
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--focal", type=float, default=None)
    # RD-VIO's dynamic-outlier rejection (reference parsac_flag row,
    # docs/en/benchmark.md:13); forces synchronous write-backs
    ap.add_argument("--parsac", action="store_true")
    args = ap.parse_args(argv)

    import jax

    from xrslam_tpu import runtime
    from xrslam_tpu.config import load_config
    from xrslam_tpu.tools.make_dataset import render_dataset
    from xrslam_tpu.tools.run_dataset import evaluate_ate, run_sequence
    from xrslam_tpu.utils import timing

    runtime.configure()

    # one directory per (frames, landmarks, geometry) so cached renders
    # can never alias a different shape
    focal = args.focal if args.focal is not None \
        else 260.0 * args.width / 320.0
    ds_dir = os.path.join(
        args.dir, f"f{args.frames}_l{args.landmarks}"
        + ("" if (args.width, args.height) == (320, 240)
           else f"_{args.width}x{args.height}"))
    root = os.path.join(ds_dir, "mav0")
    if not os.path.exists(os.path.join(ds_dir, "slam.yaml")):
        render_dataset(ds_dir, n_frames=args.frames,
                       n_landmarks=args.landmarks, width=args.width,
                       height=args.height, focal=focal)
    config = load_config(os.path.join(ds_dir, "slam.yaml"),
                         os.path.join(ds_dir, "device.yaml"))
    # overlapped backend stage: frame t's backend host work runs inside
    # frame t+1's tracker round trip (see Config.worker_overlap)
    import dataclasses

    config = dataclasses.replace(
        config, worker_overlap=os.environ.get("XR_OVERLAP", "1") != "0",
        # depth-2 write-back pipeline: the per-frame pack pull never
        # waits on the current frame's solve programs (see
        # Config.pipelined_writeback)
        pipelined_writeback=os.environ.get("XR_PIPE_WB", "1") != "0",
        # device-chained KLT (Config.chained_frontend): opt-in via
        # XR_CHAINED=1
        chained_frontend=os.environ.get("XR_CHAINED", "0") != "0",
        parsac_flag=args.parsac or config.parsac_flag)

    uri = "euroc://" + root
    passes = []
    for p in range(args.passes):
        timing.reset_timings()
        t0 = time.perf_counter()
        # sync reader: the async prefetch thread competes with the main
        # loop for the GIL
        ts, qs, ps = run_sequence(uri, config, async_reader=False)
        dt = time.perf_counter() - t0
        if p == 0:
            continue  # compile-polluted warmup pass
        passes.append((dt, ts, ps))
    dt, ts, ps = sorted(passes, key=lambda r: r[0])[len(passes) // 2]

    fps = args.frames / dt
    ate = evaluate_ate(root, ts, ps) if len(ts) else float("nan")
    dev = jax.devices()[0]

    print(json.dumps({
        "metric": "pipeline_frames_per_s",
        "value": fps,
        "unit": f"frames/s (full sequence drive, {args.frames} frames, "
                f"{args.width}x{args.height}, image KLT frontend + init "
                "+ SWT + marg; median of timed passes)",
        "vs_baseline": fps / 20.0,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "frames_tracked": len(ts),
        "ate_rmse_m": float(ate),
        "pass_fps": [args.frames / r[0] for r in passes],
        "timings_ms": {k: v * 1e3
                       for k, v in sorted(timing.timings().items())},
    }))


if __name__ == "__main__":
    main()
