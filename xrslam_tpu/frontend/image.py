"""Image preprocessing + keypoint detection kernels (XLA-native).

Replaces the reference's OpenCV adapter (reference:
xrslam-extra/src/xrslam/extra/opencv_image.cpp):
  - CLAHE preprocess (clip limit 6.0, 8×8 tiles — config.cpp:30-34,
    opencv_image.cpp:156-161)
  - optical-flow image pyramid (5-tap Gaussian pyrDown, 3 levels +
    base — opencv_image.h:20)
  - Harris/GFTT corner detection (max_points, quality 1e-3, min
    distance 20, block 3, Harris k=0.04 — opencv_image.cpp:184-188)
  - greedy min-distance suppression in response order, combining
    OpenCV GFTT's internal grid suppression with the reference's
    Poisson-disk filter over preset keypoints
    (utility/poisson_disk_filter.h, opencv_image.cpp:55-66)

All kernels are jit-compatible with static shapes; keypoint sets are
fixed-capacity arrays + validity masks. Images are float32 scaled to
[0,255].
"""

from __future__ import annotations

from functools import partial

import jax
import numpy as np
import jax.numpy as jnp


# --------------------------------------------------------------------------
# CLAHE
# --------------------------------------------------------------------------

def clahe(image: jnp.ndarray, clip_limit: float = 6.0, tiles_x: int = 8, tiles_y: int = 8) -> jnp.ndarray:
    """Contrast-limited adaptive histogram equalization.

    `image` is (H,W) in [0,255]; H,W must be divisible by the tile grid
    (EuRoC's 480×752 divides 8×8). Mirrors cv::CLAHE: per-tile 256-bin
    histogram, clip at clip_limit·(tile_area/256) with even excess
    redistribution, CDF LUT, bilinear interpolation between tile LUTs.
    """
    H, W = image.shape
    th, tw = H // tiles_y, W // tiles_x
    area = th * tw
    img_u8 = jnp.clip(image, 0, 255).astype(jnp.int32)

    # per-tile histogram by chunked equality counting (no scatter-add:
    # comparisons and reductions fuse into elementwise work)
    tiled = img_u8.reshape(tiles_y, th, tiles_x, tw)

    def hist_chunk(c):
        bins = c * 16 + jnp.arange(16)
        eq = (tiled[..., None] == bins[None, None, None, None, :])
        return jnp.sum(eq, axis=(1, 3), dtype=jnp.float32)  # (ty,tx,16)

    hist = jax.lax.map(hist_chunk, jnp.arange(16))           # (16,ty,tx,16)
    hist = jnp.moveaxis(hist, 0, 2).reshape(tiles_y, tiles_x, 256)

    limit = jnp.maximum(1.0, clip_limit * area / 256.0)
    clipped = jnp.minimum(hist, limit)
    excess = jnp.sum(hist - clipped, axis=-1, keepdims=True)
    hist_f = clipped + excess / 256.0

    cdf = jnp.cumsum(hist_f, axis=-1)
    lut = jnp.clip(jnp.round(cdf * (255.0 / area)), 0, 255)  # (ty,tx,256)

    # bilinear interpolation between the 4 neighboring tile LUTs,
    # evaluated without per-pixel gathers: the interpolated LUT is
    # materialized in 16-bin chunks (H,W,16) and blended against
    # equality masks.
    fy = (jnp.arange(H) + 0.5) / th - 0.5
    fx = (jnp.arange(W) + 0.5) / tw - 0.5
    y0 = jnp.clip(jnp.floor(fy).astype(jnp.int32), 0, tiles_y - 1)
    x0 = jnp.clip(jnp.floor(fx).astype(jnp.int32), 0, tiles_x - 1)
    y1 = jnp.clip(y0 + 1, 0, tiles_y - 1)
    x1 = jnp.clip(x0 + 1, 0, tiles_x - 1)
    wy = jnp.clip(fy - y0, 0.0, 1.0)
    wx = jnp.clip(fx - x0, 0.0, 1.0)

    CHUNK = 16

    def apply_chunk(acc, c):
        lut_c = jax.lax.dynamic_slice_in_dim(lut, c * CHUNK, CHUNK, axis=2)
        ly = ((1 - wy)[:, None, None] * lut_c[y0]
              + wy[:, None, None] * lut_c[y1])          # (H, tiles_x, CH)
        lyx = ((1 - wx)[None, :, None] * ly[:, x0]
               + wx[None, :, None] * ly[:, x1])          # (H, W, CH)
        bins = c * CHUNK + jnp.arange(CHUNK)
        sel = (img_u8[:, :, None] == bins[None, None, :]).astype(jnp.float32)
        return acc + jnp.sum(lyx * sel, axis=-1), None

    out, _ = jax.lax.scan(apply_chunk,
                          jnp.zeros((H, W), dtype=jnp.float32),
                          jnp.arange(256 // CHUNK))
    return out


# --------------------------------------------------------------------------
# Pyramid
# --------------------------------------------------------------------------

_GAUSS5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0], dtype=np.float32) / 16.0


def _sep_filter(img: jnp.ndarray, kx: jnp.ndarray, ky: jnp.ndarray) -> jnp.ndarray:
    """Separable 2D correlation with replicate border (H,W).

    Shift-and-add form: static shifted slices + weighted adds compute
    the f32 result with exact multiplies and no reduced-precision
    matmul/conv path — the precision the sub-pixel LK iteration needs
    (see the klt.MM_BF16 note). Zero taps (e.g. the derivative kernel's
    center) are skipped."""
    rx, ry = kx.shape[0] // 2, ky.shape[0] // 2
    H, W = img.shape
    p = jnp.pad(img, ((ry, ry), (rx, rx)), mode="edge")
    acc = None
    for i in range(ky.shape[0]):
        w = float(ky[i])
        if w == 0.0:
            continue
        term = w * jax.lax.slice(p, (i, 0), (i + H, W + 2 * rx))
        acc = term if acc is None else acc + term
    out = None
    for j in range(kx.shape[0]):
        w = float(kx[j])
        if w == 0.0:
            continue
        term = w * jax.lax.slice(acc, (0, j), (H, j + W))
        out = term if out is None else out + term
    return out


def pyr_down(img: jnp.ndarray) -> jnp.ndarray:
    """cv::pyrDown: 5-tap Gaussian blur then 2× decimation."""
    blurred = _sep_filter(img, _GAUSS5, _GAUSS5)
    return blurred[::2, ::2]


def build_pyramid(img: jnp.ndarray, levels: int = 3):
    """List of `levels`+1 images, level 0 = input (reference
    opencv_image.cpp:158-160 buildOpticalFlowPyramid with 3 levels)."""
    pyr = [img.astype(jnp.float32)]
    for _ in range(levels):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


# --------------------------------------------------------------------------
# Derivatives
# --------------------------------------------------------------------------

_SCHARR_D = np.array([-1.0, 0.0, 1.0], dtype=np.float32)
_SCHARR_S = np.array([3.0, 10.0, 3.0], dtype=np.float32) / 32.0
_SOBEL_D = np.array([-1.0, 0.0, 1.0], dtype=np.float32)
_SOBEL_S = np.array([1.0, 2.0, 1.0], dtype=np.float32)


def scharr(img: jnp.ndarray):
    """Scharr x/y derivatives (OpenCV's LK derivative kernel, /32)."""
    ix = _sep_filter(img, _SCHARR_D, _SCHARR_S)
    iy = _sep_filter(img, _SCHARR_S, _SCHARR_D)
    return ix, iy


def sobel(img: jnp.ndarray):
    ix = _sep_filter(img, _SOBEL_D, _SOBEL_S)
    iy = _sep_filter(img, _SOBEL_S, _SOBEL_D)
    return ix, iy


# --------------------------------------------------------------------------
# Harris / GFTT
# --------------------------------------------------------------------------

def harris_response(img: jnp.ndarray, k: float = 0.04, block_size: int = 3) -> jnp.ndarray:
    """cv::cornerHarris response (GFTT useHarris=true, block 3, Sobel 3
    — reference opencv_image.cpp:184-188). Normalization constants
    cancel in GFTT's relative quality threshold.

    Two multi-channel 3×3 convs (gradients; box sums) instead of ten
    separable 1D passes, both at HIGHEST precision."""
    dt = img.dtype
    # channel conv #1: sobel x & y in one call
    kx2d = jnp.outer(_SOBEL_S, _SOBEL_D).astype(dt)   # d/dx: smooth rows, diff cols
    ky2d = jnp.outer(_SOBEL_D, _SOBEL_S).astype(dt)
    kgrad = jnp.stack([kx2d, ky2d])[:, None]           # (2,1,3,3)
    p = jnp.pad(img, 1, mode="edge")[None, None]
    g = jax.lax.conv_general_dilated(p, kgrad, (1, 1), "VALID",
                                     precision=jax.lax.Precision.HIGHEST)[0]  # (2,H,W)
    ix, iy = g[0], g[1]

    # channel conv #2: depthwise box sums of (ix², iy², ix·iy)
    prods = jnp.stack([ix * ix, iy * iy, ix * iy])[None]  # (1,3,H,W)
    r = block_size // 2
    pp = jnp.pad(prods, ((0, 0), (0, 0), (r, r), (r, r)), mode="edge")
    kbox = jnp.ones((3, 1, block_size, block_size), dtype=dt)
    s = jax.lax.conv_general_dilated(pp, kbox, (1, 1), "VALID",
                                     feature_group_count=3,
                                     precision=jax.lax.Precision.HIGHEST)[0]
    sxx, syy, sxy = s[0], s[1], s[2]
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    return det - k * tr * tr


def _maxpool3(x: jnp.ndarray) -> jnp.ndarray:
    p = jnp.pad(x, 1, mode="constant", constant_values=-jnp.inf)
    windows = [p[dy:dy + x.shape[0], dx:dx + x.shape[1]] for dy in range(3) for dx in range(3)]
    return jnp.stack(windows).max(axis=0)


@partial(jax.jit, static_argnames=("quality_level", "border", "k"))
def _gftt_score(img: jnp.ndarray, quality_level: float, border: int, k: float):
    H, W = img.shape
    R = harris_response(img, k=k)
    is_peak = R >= _maxpool3(R)
    ys = jnp.arange(H)[:, None]
    xs = jnp.arange(W)[None, :]
    in_border = (xs >= border) & (xs < W - border) & (ys >= border) & (ys < H - border)
    good = is_peak & in_border & (R > quality_level * jnp.max(R))
    return jnp.where(good, R, -jnp.inf).reshape(-1)


@partial(jax.jit, static_argnames=("max_candidates", "W"))
def _gftt_select(score: jnp.ndarray, max_candidates: int, W: int):
    top, idx = jax.lax.top_k(score, max_candidates)
    pts = jnp.stack([(idx % W).astype(jnp.float32), (idx // W).astype(jnp.float32)], axis=-1)
    valid = jnp.isfinite(top)
    return pts, jnp.where(valid, top, 0.0), valid


def gftt_candidates(
    img: jnp.ndarray,
    max_candidates: int = 1024,
    quality_level: float = 1e-3,
    border: int = 20,
    k: float = 0.04,
):
    """Harris corners above quality·max with 3×3 NMS, sorted by response
    descending; fixed capacity with validity mask.

    Returns (pts (N,2) float32 xy, response (N,), valid (N,)).
    Border rejection (20 px) matches opencv_image.cpp:60-66.
    Two jit stages (score; top-k select).
    """
    score = _gftt_score(img, quality_level, border, k)
    return _gftt_select(score, max_candidates, img.shape[1])


@partial(jax.jit, static_argnames=("max_out",))
def min_distance_filter(
    cand_pts: jnp.ndarray,
    cand_valid: jnp.ndarray,
    preset_pts: jnp.ndarray,
    preset_valid: jnp.ndarray,
    min_distance: float,
    max_out: int = 256,
):
    """Greedy min-distance suppression in candidate order (candidates
    must be pre-sorted by priority). Accepts a candidate iff it is
    ≥ min_distance from every preset point and every previously accepted
    candidate — the semantics of the reference's PoissonDiskFilter with
    preset_points (utility/poisson_disk_filter.h:8-117) combined with
    GFTT's minDistance pass.

    Returns (accept_mask (N,) bool) over the candidates.
    """
    N = cand_pts.shape[0]
    r2 = min_distance * min_distance

    # distance to preset points (static O(N·M))
    d2p = jnp.sum((cand_pts[:, None, :] - preset_pts[None, :, :]) ** 2, axis=-1)
    far_preset = jnp.all(jnp.where(preset_valid[None, :], d2p >= r2, True), axis=1)

    def body(carry, i):
        acc_pts, acc_mask, n_acc = carry
        p = cand_pts[i]
        d2 = jnp.sum((acc_pts - p[None, :]) ** 2, axis=-1)
        far = jnp.all(jnp.where(acc_mask, d2 >= r2, True))
        ok = cand_valid[i] & far_preset[i] & far & (n_acc < max_out)
        slot = jnp.minimum(n_acc, N - 1)
        acc_pts = jnp.where(ok, acc_pts.at[slot].set(p), acc_pts)
        acc_mask = jnp.where(ok, acc_mask.at[slot].set(True), acc_mask)
        return (acc_pts, acc_mask, n_acc + ok.astype(jnp.int32)), ok

    init = (jnp.zeros((N, 2), dtype=cand_pts.dtype), jnp.zeros((N,), dtype=bool), jnp.asarray(0, jnp.int32))
    _, accepted = jax.lax.scan(body, init, jnp.arange(N))
    return accepted


def detect_keypoints(
    img: jnp.ndarray,
    preset_pts: jnp.ndarray,
    preset_valid: jnp.ndarray,
    max_points: int = 150,
    min_distance: float = 20.0,
    quality_level: float = 1e-3,
    border: int = 20,
    max_candidates: int = 1024,
):
    """Full detection pipeline (reference opencv_image.cpp:38-73):
    GFTT-Harris candidates → greedy spacing filter against existing
    keypoints → top `max_points` accepted.

    Returns (pts (max_points,2), valid (max_points,)).
    """
    cand, resp, valid = gftt_candidates(
        img, max_candidates=max_candidates, quality_level=quality_level, border=border
    )
    acc = min_distance_filter(cand, valid, preset_pts, preset_valid, min_distance, max_out=max_points)
    # compact accepted to the front, capped at max_points
    order = jnp.argsort(~acc, stable=True)  # accepted first, by response order
    pts = cand[order][:max_points]
    ok = acc[order][:max_points]
    return pts, ok
