"""A/B the KLT matmul precision modes (XR_KLT_MM: f32 / mixed / bf16)
of the hat-selector level tracker (XR_LK_BACKEND=mxu) on rendered
frames.

Because the precision mode is read at import time, each mode runs in a
fresh subprocess, one after another (only one process holds the
accelerator at a time). Metrics per mode: kernel time,
forward+backward survivors (the 0.5 px reverse-consistency gate is
what full-bf16 measurably loses), and px agreement vs the f32
reference. Frames come from the rendered benchmark sequence (textured
blobs + motion), not a synthetic constant shift.

Usage: python -m xrslam_tpu.tools.ab_klt_precision
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

_CHILD = r"""
import json, os, sys, time
import numpy as np
mode = sys.argv[1]
frame_dir = sys.argv[2]
os.environ["XR_KLT_MM"] = mode
os.environ["XR_LK_BACKEND"] = "mxu"
import jax, jax.numpy as jnp
from xrslam_tpu.frontend import image as img_ops
from xrslam_tpu.frontend import klt
from xrslam_tpu.io.dataset import load_gray

names = sorted(os.listdir(frame_dir))[:2]
imgs = [load_gray(os.path.join(frame_dir, n)) * 255.0 for n in names]
pyr1 = img_ops.build_pyramid(jnp.asarray(imgs[0]), levels=3)
pyr2 = img_ops.build_pyramid(jnp.asarray(imgs[1]), levels=3)
cand, resp, cvalid = img_ops.gftt_candidates(pyr1[0], max_candidates=1024,
                                             quality_level=1e-3, border=20)
cand = np.asarray(cand)[np.asarray(cvalid)]
C = 256
pts = np.zeros((C, 2), np.float32)
n = min(len(cand), C)
pts[:n] = cand[:n]
valid = np.zeros((C,), bool); valid[:n] = True
pts_j = jnp.asarray(pts); val_j = jnp.asarray(valid)
nxt, st = klt.track_keypoints(pyr1, pyr2, pts_j, pts_j, val_j)
jax.block_until_ready((nxt, st))
t0 = time.perf_counter()
for _ in range(20):
    nxt, st = klt.track_keypoints(pyr1, pyr2, pts_j, pts_j, val_j)
jax.block_until_ready((nxt, st))
dt = (time.perf_counter() - t0) / 20
print(json.dumps({"mode": mode, "ms_per_call": round(dt * 1e3, 2),
                  "candidates": int(n),
                  "survivors": int(np.asarray(st).sum()),
                  "pts": np.asarray(nxt).tolist(),
                  "st": np.asarray(st).tolist()}))
"""


def run(frame_dir=None):
    import numpy as np

    if frame_dir is None:
        frame_dir = "/tmp/xrslam_bench_seq/f120_l500/mav0/cam0/data"
    out = {"frames": frame_dir}
    ref = None
    for mode in ("f32", "mixed", "bf16"):
        env = dict(os.environ)
        env["XR_KLT_MM"] = mode
        p = subprocess.run([sys.executable, "-c", _CHILD, mode, frame_dir],
                           capture_output=True, text=True, env=env,
                           cwd=os.path.dirname(os.path.dirname(
                               os.path.dirname(os.path.abspath(__file__)))))
        try:
            rec = json.loads(p.stdout.strip().splitlines()[-1])
        except Exception:
            out[mode] = {"error": (p.stderr or p.stdout)[-300:]}
            continue
        pts = np.asarray(rec.pop("pts"))
        st = np.asarray(rec.pop("st"), dtype=bool)
        if ref is None:
            ref = (pts, st)
        else:
            both = st & ref[1]
            if both.any():
                d = np.linalg.norm(pts[both] - ref[0][both], axis=1)
                rec["max_px_vs_f32"] = round(float(d.max()), 3)
                rec["survivor_ratio_vs_f32"] = round(
                    float(st.sum()) / max(float(ref[1].sum()), 1.0), 3)
        out[mode] = rec
    return out


def main(argv=None):
    if argv is None:
        argv = sys.argv[1:]
    print(json.dumps(run(None if not argv else argv[0])))


if __name__ == "__main__":
    main()
