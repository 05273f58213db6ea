"""f32 end-to-end accuracy gate.

The accelerator path runs float32 (x64 off); every other test pins
CPU + float64, so this is the one gate covering the numerics
configuration the card executes. Runs the full image pipeline at CPU-f32 in
a subprocess (the suite's conftest enables x64 process-wide) and holds
it to the CPU-f64 accuracy bound of tests/test_image_e2e.py.

Round-3 regression anchor: before the per-interval IMU timestamp
rebase (window_builder.interval_samples), f32 preintegration returned
dt=0 for EuRoC-era absolute stamps and the VI-init scale collapsed to
the 0.001 gate edge (ATE 1.24 at 120 frames); with the rebase, f32
matches f64 (0.084 vs 0.083).
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

_CHILD = textwrap.dedent("""
    import json, os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ.pop("JAX_ENABLE_X64", None)
    import jax
    jax.config.update("jax_platforms", "cpu")
    assert not jax.config.jax_enable_x64

    from xrslam_tpu.tools.make_dataset import render_dataset
    from xrslam_tpu.config import load_config
    from xrslam_tpu.tools.run_dataset import run_sequence, evaluate_ate

    out = sys.argv[1]
    paths = render_dataset(out, n_frames=60, n_landmarks=500)
    config = load_config(paths["slam_yaml"], paths["device_yaml"])
    ts, qs, ps = run_sequence("euroc://" + paths["root"], config,
                              async_reader=False)
    ate = evaluate_ate(paths["root"], ts, ps) if len(ts) else float("nan")
    print(json.dumps({"tracked": len(ts), "ate": float(ate)}))
""")


@pytest.mark.slow
def test_f32_pipeline_matches_f64_bound(tmp_path):
    script = tmp_path / "child.py"
    script.write_text(_CHILD)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_ENABLE_X64", None)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, str(script), str(tmp_path / "seq")],
                       env=env, capture_output=True, text=True, timeout=540)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    # f64 reference on this 60-frame scene: ~29 tracked, ATE ~0.10
    # (tests/test_image_e2e.py bound is 0.25)
    assert out["tracked"] >= 24, out
    assert out["ate"] < 0.25, out
