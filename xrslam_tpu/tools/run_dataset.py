"""Dataset player CLI — the reference PC player, headless.

Drives the full VIO pipeline over a EuRoC/TUM sequence through the
public API (reference: xrslam-pc/player/src/main.cpp:56-178 — the
`--play` event loop dispatching GYROSCOPE/ACCELEROMETER/CAMERA events
into the C ABI and collecting output poses), writes a TUM-format
trajectory (trajectory_writer.h:30-75), and optionally evaluates ATE
against ground truth in-process (replacing the external evo tool,
docs/en/tutorials/euroc_evaluation.md).

Usage:
  python -m xrslam_tpu.tools.run_dataset euroc:///data/MH_01_easy/mav0 \
      --slam-config configs/euroc_slam.yaml \
      --device-config configs/euroc_sensor.yaml \
      --tum out.tum --gt  # --gt reads mav0/state_groundtruth_estimate0
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .. import api, runtime
from ..config import Config, load_config
from ..eval import trajectory as traj
from ..io.dataset import DataType, create_reader, load_euroc_groundtruth
from ..utils import inspection
from ..utils.timing import stage_timer, timings


def run_sequence(uri: str, config: Config, tum_out=None, max_frames=None,
                 async_reader: bool = True, progress: bool = False,
                 viewer=None):
    """Returns (ts, qs (N,4)[w,x,y,z], ps (N,3)) — one output pose per
    camera frame (the reference records the predicted pose after each
    RunOneFrame, main.cpp:147-160). `viewer`: an optional
    live_viewer.LiveViewer to publish poses/landmarks/stats to."""
    slam = api.XRSLAM(config=config)
    reader = create_reader(uri, config, async_=async_reader)
    ts, qs, ps = [], [], []
    n_img = 0
    t_start = time.perf_counter()
    while (kind := reader.next()) != DataType.END:
        if kind == DataType.GYROSCOPE:
            t, w = reader.read_gyroscope()
            slam.push_sensor_data(api.SensorType.GYROSCOPE, t, w)
        elif kind == DataType.ACCELEROMETER:
            t, a = reader.read_accelerometer()
            slam.push_sensor_data(api.SensorType.ACCELERATION, t, a)
        elif kind == DataType.DEPTH:
            t, d = reader.read_depth()
            slam.push_sensor_data(api.SensorType.DEPTH_CAMERA, t, d)
        else:
            t, img = reader.read_image()
            slam.push_sensor_data(api.SensorType.CAMERA, t, img)
            with stage_timer("run_one_frame_time"):
                slam.run_one_frame()
            n_img += 1
            state = slam.get_result(api.ResultType.STATE)
            if state == api.State.TRACKING_SUCCESS:
                pose = slam.get_result(api.ResultType.BODY_POSE)
                x, y, z, w_ = pose.quaternion
                ts.append(pose.timestamp)
                qs.append([w_, x, y, z])
                ps.append(pose.translation)
            if viewer is not None and state == api.State.TRACKING_SUCCESS:
                lms = slam.get_result(api.ResultType.LANDMARKS)
                viewer.publish(
                    pose_q=qs[-1], pose_p=ps[-1], landmarks=lms,
                    stats={"frame": n_img,
                           "fps": n_img / max(
                               time.perf_counter() - t_start, 1e-9),
                           "landmarks": len(lms)})
            if progress and n_img % 50 == 0:
                el = time.perf_counter() - t_start
                print(f"[{n_img}] {slam.pipeline.state} "
                      f"{n_img/el:.1f} img/s", file=sys.stderr)
            if max_frames and n_img >= max_frames:
                break
    slam.flush()  # land the deferred backend frame (worker_overlap)
    fps = n_img / max(time.perf_counter() - t_start, 1e-9)
    inspection.inspect(inspection.FEATURE_TRACKER_FPS, fps)
    ts, qs, ps = np.asarray(ts), np.asarray(qs), np.asarray(ps)
    if tum_out and len(ts):
        traj.write_tum(tum_out, ts, qs, ps)
    return ts, qs, ps


def evaluate_ate(seq_path: str, ts, ps) -> float:
    gt_t, gt_p, _ = load_euroc_groundtruth(seq_path)
    ia, ib = traj.associate(ts, gt_t)
    if len(ia) < 10:
        return float("nan")
    return traj.ate_rmse(ps[ia], gt_p[ib])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dataset", help="euroc://PATH or tum://PATH")
    ap.add_argument("--slam-config")
    ap.add_argument("--device-config")
    ap.add_argument("--tum", help="TUM trajectory output path")
    ap.add_argument("--gt", action="store_true",
                    help="evaluate ATE vs EuRoC ground truth")
    ap.add_argument("--max-frames", type=int)
    ap.add_argument("--sync", action="store_true",
                    help="disable the async reader thread")
    ap.add_argument("--viz", metavar="DIR",
                    help="write per-frame keypoint overlays + a "
                         "trajectory plot into DIR")
    ap.add_argument("--live", metavar="PORT", type=int,
                    help="serve the interactive live viewer (trajectory/"
                         "landmarks/frustum/feature overlay) on PORT")
    args = ap.parse_args(argv)
    runtime.configure()

    if args.slam_config and args.device_config:
        config = load_config(args.slam_config, args.device_config)
    else:
        config = Config()

    writer = None
    if args.viz:
        from .viz import OverlayWriter

        writer = OverlayWriter(args.viz)

    viewer = None
    if args.live is not None:
        from .live_viewer import LiveViewer

        viewer = LiveViewer(port=args.live)
        print(f"live viewer: {viewer.url}", file=sys.stderr)

    ts, qs, ps = run_sequence(args.dataset, config, tum_out=args.tum,
                              max_frames=args.max_frames,
                              async_reader=not args.sync, progress=True,
                              viewer=viewer)
    out = {"frames_tracked": len(ts),
           "fps": inspection.inspect_get(inspection.FEATURE_TRACKER_FPS),
           "timings": timings()}
    gt_p = None
    if args.gt and len(ts):
        seq = args.dataset.split("://", 1)[-1]
        out["ate_rmse_m"] = evaluate_ate(seq, ts, ps)
        gt_t, gt_p, _ = load_euroc_groundtruth(seq)
    if writer is not None:
        writer.close()
        if len(ts):
            from .viz import plot_trajectory

            plot_trajectory(f"{args.viz}/trajectory.png", ps, gt_p)
    print(json.dumps(out, default=float))


if __name__ == "__main__":
    main()
