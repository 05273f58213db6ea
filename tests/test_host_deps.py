"""Host-side dependencies of the main path: the standard-library PNG
codec, the import set of the main path, the compile-cache helper, and
the chip smoke script's refusal to run without a GPU."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from xrslam_tpu import native
from xrslam_tpu.io import png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, env=None, timeout=600):
    e = dict(os.environ)
    e.pop("JAX_COMPILATION_CACHE_DIR", None)
    e.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    e.update(env or {})
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, env=e, cwd=REPO,
                          timeout=timeout)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_png_writer_roundtrip_both_decoders(tmp_path, dtype):
    rng = np.random.default_rng(0)
    hi = np.iinfo(dtype).max
    img = rng.integers(0, hi + 1, (37, 53)).astype(dtype)
    img[0, 0], img[-1, -1] = 0, hi
    p = str(tmp_path / "t.png")
    png.write_gray(p, img)

    raw = png.read(p)
    assert raw.dtype == dtype and raw.shape == (37, 53, 1)
    np.testing.assert_array_equal(raw[..., 0], img)
    ref = img.astype(np.float32) / hi
    np.testing.assert_allclose(png.load_gray(p), ref, atol=1e-6)
    assert native.available(), "native host library failed to build"
    np.testing.assert_allclose(native.png_load_gray(p), ref, atol=1e-6)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "I;16"])
def test_png_stdlib_decoder_reads_filtered_files(tmp_path, mode):
    """PIL writes adaptively filtered scanlines (Sub/Up/Average/Paeth);
    the stdlib decoder must agree with the native one on them."""
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(1)
    base = np.cumsum(rng.integers(0, 9, (40, 61)), axis=1) % 256
    if mode == "L":
        arr = base.astype(np.uint8)
    elif mode == "I;16":
        arr = (base * 257 + rng.integers(0, 200, base.shape)).astype(np.uint16)
    else:
        arr = np.stack([base, base[::-1], 255 - base, base][:len(mode)],
                       -1).astype(np.uint8)
    p = str(tmp_path / "f.png")
    Image.fromarray(arr, mode=mode).save(p, optimize=True)
    ours = png.load_gray(p)
    assert ours.shape == (40, 61)
    if mode in ("L", "I;16"):
        np.testing.assert_allclose(
            ours, arr.astype(np.float32) / np.iinfo(arr.dtype).max, atol=1e-6)
    np.testing.assert_allclose(ours, native.png_load_gray(p), atol=1e-6)


def test_main_path_without_yaml_pil_cv2(tmp_path):
    """With PyYAML, PIL and OpenCV unimportable and the native library
    switched off, the config loader, the renderer, the reader and one
    frames through api.XRSLAM still work, and the process loads no
    third-party module beyond numpy, scipy and JAX (with what JAX itself
    loads)."""
    r = _run(f"""
        import sys
        for m in ("yaml", "PIL", "cv2"):
            sys.modules[m] = None          # import now raises ImportError
        import numpy as np
        import jax, jax.numpy as jnp, scipy.linalg

        def third_party():
            return {{m.split(".")[0] for m, v in sys.modules.items()
                    if v is not None}} - set(sys.stdlib_module_names)

        # what numpy, scipy and JAX load themselves (JAX's own
        # dependencies included) once a program has compiled
        jax.jit(lambda x: x + 1)(jnp.ones(3)).block_until_ready()
        baseline = third_party()

        import xrslam_tpu.native as nat
        nat._tried, nat._lib = True, None  # stdlib PNG path
        from xrslam_tpu import api
        from xrslam_tpu.config import load_config
        from xrslam_tpu.io.dataset import DataType, create_reader
        from xrslam_tpu.io.png import read
        from xrslam_tpu.tools.make_dataset import render_dataset

        paths = render_dataset({str(tmp_path)!r}, n_frames=3,
                               n_landmarks=150, width=320, height=240,
                               focal=260.0)
        cfg = load_config(paths["slam_yaml"], paths["device_yaml"])
        assert cfg.camera_resolution == (320, 240), cfg.camera_resolution
        euroc = load_config("configs/euroc_slam.yaml",
                            "configs/euroc_sensor.yaml")
        assert euroc.solver_time_limit == 1.0e6
        reader = create_reader("euroc://" + paths["root"], cfg)
        slam = api.XRSLAM(config=cfg)
        n_img = 0
        while (kind := reader.next()) != DataType.END:
            if kind == DataType.CAMERA:
                t, img = reader.read_image()
                assert img.shape == (240, 320) and img.dtype == np.float32
                slam.push_sensor_data(api.SensorType.CAMERA, t, img)
                slam.run_one_frame()
                n_img += 1
            elif kind == DataType.GYROSCOPE:
                slam.push_sensor_data(api.SensorType.GYROSCOPE,
                                      *reader.read_gyroscope())
            else:
                slam.push_sensor_data(api.SensorType.ACCELERATION,
                                      *reader.read_accelerometer())
        assert n_img == 3
        extra = third_party() - baseline - {{"xrslam_tpu"}}
        print("THIRD_PARTY", sorted(extra))
        assert not extra, sorted(extra)
    """, env={"JAX_ENABLE_COMPILATION_CACHE": "false"})
    assert r.returncode == 0, r.stderr[-3000:]
    assert "THIRD_PARTY []" in r.stdout


@pytest.mark.parametrize("preset", [None, "custom_cache"])
def test_compile_cache_helper(tmp_path, preset):
    """runtime.configure(): an explicit JAX_COMPILATION_CACHE_DIR is
    left alone; otherwise the cache goes to <repo>/.jax_cache."""
    env = {}
    want = os.path.join(REPO, ".jax_cache")
    if preset:
        want = str(tmp_path / preset)
        env["JAX_COMPILATION_CACHE_DIR"] = want
    r = _run("""
        import jax
        from xrslam_tpu import runtime
        print("DIR", runtime.configure())
        print("CFG", jax.config.jax_compilation_cache_dir)
        print("PREC", jax.config.jax_default_matmul_precision)
    """, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert f"DIR {want}\n" in r.stdout and f"CFG {want}\n" in r.stdout
    assert "PREC highest" in r.stdout


def test_chip_smoke_refuses_cpu():
    """No GPU: chip_smoke.py exits non-zero and prints no result line."""
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, timeout=300, cwd=REPO,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
