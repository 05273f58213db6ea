"""Feature-pipeline tests: CLAHE/pyramid kernels vs OpenCV on a seeded
textured image, synthetic LK flows, and the detection+tracking regime
on a rendered EuRoC-geometry frame pair (the reference's
test_feature_track.cpp asserts 164 detected / 161 tracked on two EuRoC
frames; our Harris/LK are reimplementations, so we assert the regime)."""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest

from xrslam_tpu.frontend import image as img_ops
from xrslam_tpu.frontend import klt


def _textured(seed=0, h=480, w=752):
    """Seeded uint8 texture with EuRoC-like contrast: blurred noise at
    two scales plus a brightness gradient."""
    rng = np.random.RandomState(seed)
    fine = cv2.GaussianBlur(rng.rand(h, w).astype(np.float32), (0, 0), 2.0)
    coarse = cv2.GaussianBlur(rng.rand(h, w).astype(np.float32), (0, 0), 12.0)
    ramp = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    img = 0.5 * fine / fine.max() + 2.0 * coarse / coarse.max() + 0.3 * ramp
    img = (img - img.min()) / (img.max() - img.min())
    return (40 + 150 * img).astype(np.uint8)


@pytest.fixture(scope="module")
def euroc_pair(tmp_path_factory):
    """Two consecutive frames of the rendered EuRoC-geometry proxy
    scene (752x480, f=458), undistorted by construction."""
    from xrslam_tpu.io.png import read
    from xrslam_tpu.tools.make_dataset import render_dataset

    d = str(tmp_path_factory.mktemp("euroc_pair"))
    paths = render_dataset(d, n_frames=22, n_landmarks=700, width=752,
                           height=480, focal=458.0, seed=5)
    import os

    data = os.path.join(paths["root"], "cam0", "data")
    names = sorted(os.listdir(data))
    return [read(os.path.join(data, n))[..., 0] for n in names[20:22]]


def test_clahe_close_to_opencv():
    raw = _textured(0)
    ours = np.asarray(img_ops.clahe(jnp.asarray(raw, dtype=jnp.float32), 6.0, 8, 8))
    ref = cv2.createCLAHE(6.0, (8, 8)).apply(raw).astype(np.float32)
    err = np.abs(ours - ref)
    assert np.median(err) <= 1.0, np.median(err)
    assert np.mean(err) < 3.0, np.mean(err)


def test_pyrdown_close_to_opencv():
    raw = _textured(1).astype(np.float32)
    ours = np.asarray(img_ops.pyr_down(jnp.asarray(raw)))
    ref = cv2.pyrDown(raw)
    assert ours.shape == ref.shape
    err = np.abs(ours - ref)[2:-2, 2:-2]
    assert np.mean(err) < 1.0, np.mean(err)


def test_detect_track_golden_euroc(euroc_pair):
    """Detection + tracking with the EuRoC config (CLAHE, max 200
    keypoints, 20 px spacing — configs/euroc_slam.yaml) on a rendered
    EuRoC-geometry frame pair: the reference's regime of ~160 detected
    with nearly all tracked (test_feature_track.cpp:24-66)."""
    raw0, raw1 = euroc_pair
    im0 = img_ops.clahe(jnp.asarray(raw0, dtype=jnp.float32), 6.0, 8, 8)
    im1 = img_ops.clahe(jnp.asarray(raw1, dtype=jnp.float32), 6.0, 8, 8)

    no_preset = jnp.zeros((1, 2), dtype=jnp.float32)
    no_preset_valid = jnp.zeros((1,), dtype=bool)
    pts, ok = img_ops.detect_keypoints(
        im0, no_preset, no_preset_valid, max_points=200, min_distance=20.0,
        max_candidates=2048,
    )
    n_det = int(ok.sum())
    assert 100 <= n_det <= 200, n_det

    pyr0 = img_ops.build_pyramid(im0, 3)
    pyr1 = img_ops.build_pyramid(im1, 3)
    nxt, st = klt.track_keypoints(pyr0, pyr1, pts, pts, ok)
    n_trk = int(st.sum())
    assert n_trk >= int(0.85 * n_det), (n_det, n_trk)
    # flow should be small between consecutive 20 Hz frames
    med_flow = float(jnp.median(jnp.linalg.norm((nxt - pts)[np.asarray(st)], axis=-1)))
    assert med_flow < 15.0, med_flow


def test_lk_recovers_synthetic_shift():
    """Pure-translation synthetic check with subpixel shift."""
    rng = np.random.RandomState(0)
    base = cv2.GaussianBlur(rng.rand(480, 752).astype(np.float32) * 255, (0, 0), 3.0)
    dx, dy = 3.6, -2.3
    M = np.float32([[1, 0, dx], [0, 1, dy]])
    shifted = cv2.warpAffine(base, M, (752, 480))

    pyr0 = img_ops.build_pyramid(jnp.asarray(base), 3)
    pyr1 = img_ops.build_pyramid(jnp.asarray(shifted), 3)
    pts = jnp.asarray(
        np.stack(np.meshgrid(np.arange(100, 700, 80), np.arange(100, 440, 80)), -1)
        .reshape(-1, 2).astype(np.float32)
    )
    ok = jnp.ones((pts.shape[0],), dtype=bool)
    nxt, st = klt.track_keypoints(pyr0, pyr1, pts, pts, ok)
    assert int(st.sum()) >= pts.shape[0] - 2
    flow = np.asarray(nxt - pts)[np.asarray(st)]
    np.testing.assert_allclose(flow[:, 0], dx, atol=0.25)
    np.testing.assert_allclose(flow[:, 1], dy, atol=0.25)


def test_reverse_gate_rejects_occlusion():
    """Backward check must reject points whose neighborhood changes."""
    rng = np.random.RandomState(1)
    base = cv2.GaussianBlur(rng.rand(240, 320).astype(np.float32) * 255, (0, 0), 2.0)
    corrupted = base.copy()
    corrupted[100:140, 150:190] = rng.rand(40, 40) * 255  # destroy a patch
    pyr0 = img_ops.build_pyramid(jnp.asarray(base), 2)
    pyr1 = img_ops.build_pyramid(jnp.asarray(corrupted), 2)
    pts = jnp.asarray(np.array([[170.0, 120.0], [60.0, 60.0]], dtype=np.float32))
    ok = jnp.ones((2,), dtype=bool)
    _, st = klt.track_keypoints(pyr0, pyr1, pts, pts, ok)
    st = np.asarray(st)
    assert not st[0]   # destroyed patch
    assert st[1]       # untouched patch survives


def test_min_distance_filter_spacing():
    pts = jnp.asarray(
        np.array([[100.0, 100.0], [105.0, 100.0], [150.0, 100.0], [100.0, 150.0]], dtype=np.float32)
    )
    valid = jnp.ones((4,), dtype=bool)
    preset = jnp.asarray(np.array([[100.0, 148.0]], dtype=np.float32))
    pv = jnp.ones((1,), dtype=bool)
    acc = img_ops.min_distance_filter(pts, valid, preset, pv, 20.0, max_out=4)
    acc = np.asarray(acc)
    assert acc[0]          # first by priority
    assert not acc[1]      # too close to first
    assert acc[2]          # far enough
    assert not acc[3]      # too close to preset


@pytest.mark.parametrize("platform", ["cpu", "gpu", "rocm"])
def test_kernel_choice_ignores_platform(monkeypatch, platform):
    """The LK level tracker and the GFTT top-k are the same program on
    every platform: the gather path and exact top_k."""
    import jax

    monkeypatch.delenv("XR_LK_BACKEND", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert klt._lk_backend() == "xla"
    jaxpr = str(jax.make_jaxpr(
        lambda s: img_ops._gftt_select(s, 16, 8))(jnp.arange(64.0)))
    assert "top_k" in jaxpr and "approx" not in jaxpr


def test_lk_backend_mxu_is_opt_in(monkeypatch):
    monkeypatch.setenv("XR_LK_BACKEND", "mxu")
    assert klt._lk_backend() == "mxu"
    monkeypatch.setenv("XR_LK_BACKEND", "pallas")
    assert klt._lk_backend() == "xla"
