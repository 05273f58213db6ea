"""Synthetic EuRoC-layout dataset renderer.

Renders a `wave_scene` (io/synthetic.py) to an on-disk mav0 tree —
blob-textured PNG frames, camera/IMU CSVs (ns timestamps), EuRoC-style
ground truth, and the slam/device YAML config pair — so the full
image-based pipeline (PNG decode → reader → CLAHE/GFTT/KLT → init →
sliding window → TUM/ATE) can be driven end-to-end without EuRoC data.
No reference counterpart (the reference's only end-to-end validation
path is manual EuRoC runs, docs/en/tutorials/euroc_evaluation.md).

Usage:
  python -m xrslam_tpu.tools.make_dataset /tmp/seq --frames 60
then:
  python -m xrslam_tpu.tools.run_dataset euroc:///tmp/seq/mav0 \
      --slam-config /tmp/seq/slam.yaml --device-config /tmp/seq/device.yaml \
      --tum out.tum --gt
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..core import nputil


def render_dataset(out_dir: str, n_frames: int = 60, n_landmarks: int = 500,
                   width: int = 320, height: int = 240, focal: float = 260.0,
                   seed: int = 3, with_depth: bool = False) -> dict:
    """Returns paths dict {root, slam_yaml, device_yaml}.

    `with_depth` additionally renders aligned sparse depth images
    (mav0/depth0, uint16 millimeters, 0 = no measurement): each visible
    landmark blob writes its camera z-depth in a small disc — the
    XRSLAMDepthImage input stream (XRSLAM.h:56-60)."""
    import jax.numpy as jnp

    from ..geometry import lie
    from ..io import png
    from ..io.synthetic import euler_consistent, wave_scene

    W, H, F = width, height, focal
    K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1.0]])
    q_bc = np.asarray(lie.expmap(jnp.array([-np.pi / 2, 0.0, 0.0],
                                           dtype=jnp.float64)))
    p_bc = np.array([0.02, -0.01, 0.03])

    scene = euler_consistent(wave_scene(
        n_frames=n_frames, n_landmarks=n_landmarks, seed=seed))
    qs, ps = np.asarray(scene.q), np.asarray(scene.p)
    lms = np.asarray(scene.landmarks)
    ts = np.asarray(scene.t)

    rng = np.random.default_rng(seed)
    amps = rng.uniform(0.35, 0.75, n_landmarks) * rng.choice([-1.0, 1.0],
                                                             n_landmarks)
    sig = 2.2
    bg = rng.uniform(0, 1, (H // 8 + 1, W // 8 + 1))
    bg = np.kron(bg, np.ones((8, 8)))[:H, :W]
    # separable box blur (avoid a scipy dependency)
    k = np.ones(13) / 13.0
    for _ in range(3):
        bg = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, bg)
        bg = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, bg)
    bg = bg * 0.06 + 0.45

    root = os.path.join(out_dir, "mav0")
    os.makedirs(os.path.join(root, "cam0", "data"), exist_ok=True)
    os.makedirs(os.path.join(root, "imu0"), exist_ok=True)
    os.makedirs(os.path.join(root, "state_groundtruth_estimate0"),
                exist_ok=True)

    def render(i):
        q_wc = nputil.quat_mul(qs[i], q_bc)
        p_wc = ps[i] + nputil.quat_rotate(qs[i], p_bc)
        R_cw = nputil.quat_to_matrix(nputil.quat_conj(q_wc))
        Xc = (R_cw @ (lms - p_wc).T).T
        vis = Xc[:, 2] > 0.3
        uv = (K @ (Xc[vis] / Xc[vis, 2:3]).T).T[:, :2]
        img = bg.copy()
        dep = np.zeros((H, W), dtype=np.float32)
        r = 7
        for (u, v), amp, z in zip(uv, amps[vis], Xc[vis, 2]):
            if u < -r or u >= W + r or v < -r or v >= H + r:
                continue
            x0, x1 = max(0, int(u) - r), min(W, int(u) + r + 1)
            y0, y1 = max(0, int(v) - r), min(H, int(v) + r + 1)
            xs, ys = np.meshgrid(np.arange(x0, x1), np.arange(y0, y1))
            img[y0:y1, x0:x1] += amp * np.exp(
                -((xs - u) ** 2 + (ys - v) ** 2) / (2 * sig * sig))
            if with_depth:
                disc = ((xs - u) ** 2 + (ys - v) ** 2) <= (r - 2) ** 2
                blk = dep[y0:y1, x0:x1]
                # nearest surface wins where blobs overlap
                blk[disc & ((blk == 0) | (blk > z))] = z
                dep[y0:y1, x0:x1] = blk
        return np.clip(img, 0, 1), dep

    T0 = 1_500_000_000_000_000_000
    if with_depth:
        os.makedirs(os.path.join(root, "depth0", "data"), exist_ok=True)
    cam_rows = ["#timestamp [ns],filename"]
    dep_rows = ["#timestamp [ns],filename"]
    for i in range(n_frames):
        tns = T0 + int(round(ts[i] * 1e9))
        fn = f"{tns}.png"
        img, dep = render(i)
        png.write_gray(os.path.join(root, "cam0", "data", fn),
                       (img * 255).astype(np.uint8))
        cam_rows.append(f"{tns},{fn}")
        if with_depth:
            png.write_gray(os.path.join(root, "depth0", "data", fn),
                           np.clip(dep * 1000.0, 0, 65535).astype(np.uint16))
            dep_rows.append(f"{tns},{fn}")
    with open(os.path.join(root, "cam0", "data.csv"), "w") as f:
        f.write("\n".join(cam_rows) + "\n")
    if with_depth:
        with open(os.path.join(root, "depth0", "data.csv"), "w") as f:
            f.write("\n".join(dep_rows) + "\n")

    it = np.asarray(scene.imu_t)
    iw = np.asarray(scene.imu_w)
    ia = np.asarray(scene.imu_a)
    imu_rows = ["#timestamp [ns],wx,wy,wz,ax,ay,az"]
    for i in range(n_frames):
        for s in range(it.shape[1]):
            tns = T0 + int(round(it[i, s] * 1e9))
            w, a = iw[i, s], ia[i, s]
            imu_rows.append(
                f"{tns},{w[0]},{w[1]},{w[2]},{a[0]},{a[1]},{a[2]}")
    with open(os.path.join(root, "imu0", "data.csv"), "w") as f:
        f.write("\n".join(imu_rows) + "\n")

    gt_rows = ["#timestamp,px,py,pz,qw,qx,qy,qz"]
    for i in range(n_frames):
        tns = T0 + int(round(ts[i] * 1e9))
        gt_rows.append(f"{tns},{ps[i,0]},{ps[i,1]},{ps[i,2]},"
                       f"{qs[i,0]},{qs[i,1]},{qs[i,2]},{qs[i,3]}")
    with open(os.path.join(root, "state_groundtruth_estimate0", "data.csv"),
              "w") as f:
        f.write("\n".join(gt_rows) + "\n")

    device_yaml = os.path.join(out_dir, "device.yaml")
    with open(device_yaml, "w") as f:
        f.write(f"""%YAML:1.0
cam0:
  resolution: [{W}, {H}]
  intrinsics: [{F}, {F}, {W/2}, {H/2}]
  camera_distortion_flag: 0
  time_offset: 0.0
  extrinsic:
    q_bc: [{q_bc[1]}, {q_bc[2]}, {q_bc[3]}, {q_bc[0]}]
    p_bc: [{p_bc[0]}, {p_bc[1]}, {p_bc[2]}]
  noise: [0.25, 0.0, 0.0, 0.25]
imu:
  extrinsic:
    q_bi: [0.0, 0.0, 0.0, 1.0]
    p_bi: [0.0, 0.0, 0.0]
  noise:
    cov_g: [1.0e-6, 0.0, 0.0, 0.0, 1.0e-6, 0.0, 0.0, 0.0, 1.0e-6]
    cov_a: [1.0e-4, 0.0, 0.0, 0.0, 1.0e-4, 0.0, 0.0, 0.0, 1.0e-4]
    cov_bg: [1.0e-10, 0.0, 0.0, 0.0, 1.0e-10, 0.0, 0.0, 0.0, 1.0e-10]
    cov_ba: [1.0e-8, 0.0, 0.0, 0.0, 1.0e-8, 0.0, 0.0, 0.0, 1.0e-8]
""")
    slam_yaml = os.path.join(out_dir, "slam.yaml")
    with open(slam_yaml, "w") as f:
        f.write("""%YAML:1.0
sliding_window:
  size: 10
  subframe_size: 3
  force_keyframe_landmarks: 20
feature_tracker:
  min_keypoint_distance: 15.0
  max_keypoint_detection: 120
initializer:
  keyframe_num: 8
  keyframe_gap: 3
  min_matches: 30
  min_parallax: 5.0
  min_triangulation: 25
  min_landmarks: 18
solver:
  iteration_limit: 10
""")
    return {"root": root, "slam_yaml": slam_yaml, "device_yaml": device_yaml}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--landmarks", type=int, default=500)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--depth", action="store_true",
                    help="also render aligned sparse depth images")
    args = ap.parse_args(argv)
    paths = render_dataset(args.out_dir, n_frames=args.frames,
                           n_landmarks=args.landmarks, seed=args.seed,
                           with_depth=args.depth)
    print(paths)


if __name__ == "__main__":
    main()
