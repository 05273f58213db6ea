"""Pyramidal Lucas-Kanade optical flow, batched over keypoints.

Replaces cv::calcOpticalFlowPyrLK as used by the reference
(reference: xrslam-extra/src/xrslam/extra/opencv_image.cpp:75-154):
21×21 window, 4 pyramid images (3 levels + base), ≤30 iterations,
eps 0.01, OPTFLOW_USE_INITIAL_FLOW (rotation-predicted seeds),
forward + backward pass with a 0.5 px reverse-consistency gate, 20 px
border rejection, and a rows/4 max-displacement gate.

All keypoints advance in lockstep as one batched computation per
pyramid level (vmap over points, `lax.fori_loop` for the iterations);
convergence is handled with per-point masks, not early exits. Sampling
is bilinear (OpenCV's interpolation for LK).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import image as img_ops


def _bilinear(img: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """Sample img (H,W) at xy (...,2) float coords (x right, y down)
    with clamping; returns (...,)."""
    H, W = img.shape
    x = jnp.clip(xy[..., 0], 0.0, W - 1.001)
    y = jnp.clip(xy[..., 1], 0.0, H - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = x - x0
    fy = y - y0
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return (
        v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx
        + v10 * fy * (1 - fx) + v11 * fy * fx
    )


def _sample_window(img: jnp.ndarray, center: jnp.ndarray, win: int) -> jnp.ndarray:
    """Bilinearly sample a (win,win) patch centered at `center` (x,y).

    One contiguous dynamic_slice of (win+1,win+1) plus four shifted
    static slices — the whole window shares a single fractional offset,
    so per-tap gathers (hundreds of scalar gathers per point) collapse
    to one block load and elementwise blends. dynamic_slice
    clamps the block to the image; out-of-window points are rejected by
    the caller's border gates, matching the clamped-tap semantics of
    cv::calcOpticalFlowPyrLK at borders closely enough."""
    H, W = img.shape
    r = win // 2
    x0f = center[0] - r
    y0f = center[1] - r
    # clamp the block corner ourselves and keep the fractional offset
    # consistent with the clamped corner: a ≤1 px overflow at the image
    # edge then still samples exactly (fx ∈ (1, 2) would extrapolate,
    # but such points are frozen/rejected by the tracking gates)
    ix = jnp.clip(jnp.floor(x0f).astype(jnp.int32), 0, max(W - win - 1, 0))
    iy = jnp.clip(jnp.floor(y0f).astype(jnp.int32), 0, max(H - win - 1, 0))
    fx = x0f - ix.astype(x0f.dtype)
    fy = y0f - iy.astype(y0f.dtype)
    blk = jax.lax.dynamic_slice(img, (iy, ix), (win + 1, win + 1))
    return ((1 - fy) * (1 - fx) * blk[:-1, :-1]
            + (1 - fy) * fx * blk[:-1, 1:]
            + fy * (1 - fx) * blk[1:, :-1]
            + fy * fx * blk[1:, 1:])


def _track_level(
    prev_img, prev_ix, prev_iy, next_img, pts_prev, guess, valid,
    win: int, iters: int, eps: float, min_eig_floor: float = 1e-4,
    final: bool = False,
):
    """One pyramid level of iterative LK for all points.

    pts_prev, guess: (N,2) level coords. Returns (new_guess, valid).
    Matching cv::calcOpticalFlowPyrLK, ill-conditioned or out-of-window
    points only lose their status at the FINAL (level-0) pass; at upper
    levels they simply keep their incoming guess.
    """
    H, W = prev_img.shape
    r = win // 2
    win_area = win * win

    def per_point(pt, g0, ok):
        T = _sample_window(prev_img, pt, win)
        Ix = _sample_window(prev_ix, pt, win)
        Iy = _sample_window(prev_iy, pt, win)
        gxx = jnp.sum(Ix * Ix)
        gxy = jnp.sum(Ix * Iy)
        gyy = jnp.sum(Iy * Iy)
        det = gxx * gyy - gxy * gxy
        cond_ok = (gxx + gyy) > 0
        small_eig = 0.5 * (gxx + gyy - jnp.sqrt((gxx - gyy) ** 2 + 4 * gxy * gxy))
        cond_ok = cond_ok & (small_eig / win_area > min_eig_floor) & (det > 1e-12)
        inv_det = jnp.where(det > 1e-12, 1.0 / jnp.where(det > 0, det, 1.0), 0.0)

        in_bounds0 = (
            (pt[0] >= r) & (pt[0] < W - r) & (pt[1] >= r) & (pt[1] < H - r)
        )

        def body(i, carry):
            g, conv, lost = carry
            # when the iterate's window leaves the image, stop updating
            # (a border-clamped window samples a shifted patch and the
            # iteration diverges); cv::calcOpticalFlowPyrLK likewise
            # breaks out, zeroing status only at the final level
            inb = ((g[0] >= r) & (g[0] < W - r) & (g[1] >= r) & (g[1] < H - r))
            lost = lost | ~inb
            J = _sample_window(next_img, g, win)
            diff = J - T
            bx = jnp.sum(diff * Ix)
            by = jnp.sum(diff * Iy)
            dx = -(gyy * bx - gxy * by) * inv_det
            dy = -(-gxy * bx + gxx * by) * inv_det
            d = jnp.stack([dx, dy])
            g_new = jnp.where(conv | lost, g, g + d)
            conv = conv | (jnp.sum(d * d) < eps * eps)
            return g_new, conv, lost

        g_fin, _, lost = jax.lax.fori_loop(
            0, iters, body, (g0, jnp.asarray(False), jnp.asarray(False)))
        good_here = cond_ok & in_bounds0
        g_fin = jnp.where(ok & good_here, g_fin, g0)
        ok_out = (ok & good_here & ~lost) if final else ok
        err = jnp.mean(jnp.abs(_sample_window(next_img, g_fin, win) - T))
        return g_fin, ok_out, err

    g, ok, err = jax.vmap(per_point)(pts_prev, guess, valid)
    return g, ok, (err if final else jnp.zeros_like(err))


SEARCH = 64  # search-block side of the matmul level tracker

# Precision of the selector·block·selectorᵀ window-sampling einsums of
# _track_level_mxu. Default: float32 operands at HIGHEST precision.
# bf16 sampling loses ~10% of the KLT survivors per frame to
# reverse-consistency failures, which collapses track length and delays
# VI initialization by ~60 frames. XR_KLT_MM=bf16 re-enables the fast
# path for A/B (tools/ab_klt_precision.py).
import os as _os

_MM_MODE = _os.environ.get("XR_KLT_MM", "f32")
MM_BF16 = _MM_MODE == "bf16"
# XR_KLT_MM=mixed: bf16 sampling einsums on the UPPER pyramid levels
# (they only seed the next level; the 0.5 px reverse-consistency gate
# never sees them) + f32/HIGHEST at level 0 where sub-pixel accuracy is
# decided.
MM_MIXED = _MM_MODE == "mixed"

# Run the reverse-consistency pass at pyramid level 0 only (see
# track_keypoints). Flip to False to force the full-pyramid reverse
# pass of cv::calcOpticalFlowPyrLK.
BWD_LEVEL0 = True

# LK steps per while_loop trip (identical math; see _track_level_mxu)
UNROLL = int(_os.environ.get("XR_KLT_UNROLL", "1"))


def _track_level_mxu(
    prev_img, prev_ix, prev_iy, next_img, pts_prev, guess, valid,
    win: int, iters: int, eps: float, min_eig_floor: float = 1e-4,
    final: bool = False, search: int = SEARCH, force_bf16: bool = False,
):
    """Gather-free level tracker: per point, ONE (SEARCH,SEARCH) block is
    sliced around the initial guess, then every LK iteration samples its
    (win,win) window as R·S·Cᵀ where R/C are hat-function (linear
    interpolation) selector matrices — bilinear sampling as two batched
    matmuls, zero gathers inside the iteration loop. The
    iterate is confined to its search block; points that would drift
    further are the ones the displacement/round-trip gates reject
    anyway (reference opencv_image.cpp:117-141)."""
    H, W = prev_img.shape
    r = win // 2
    blk = win + 1
    dt = prev_img.dtype

    def gather_block(g0):
        cx = jnp.clip(jnp.floor(g0[0]).astype(jnp.int32) - search // 2, 0,
                      max(W - search, 0))
        cy = jnp.clip(jnp.floor(g0[1]).astype(jnp.int32) - search // 2, 0,
                      max(H - search, 0))
        S = jax.lax.dynamic_slice(next_img, (cy, cx), (min(search, H), min(search, W)))
        if S.shape != (search, search):  # small pyramid level: pad
            S = jnp.pad(S, ((0, search - S.shape[0]), (0, search - S.shape[1])))
        return S, cx.astype(dt), cy.astype(dt)

    S_all, jx0, jy0 = jax.vmap(gather_block)(guess)

    def per_point_setup(pt):
        T = _sample_window(prev_img, pt, win)
        Ix = _sample_window(prev_ix, pt, win)
        Iy = _sample_window(prev_iy, pt, win)
        return T, Ix, Iy

    T, Ix, Iy = jax.vmap(per_point_setup)(pts_prev)
    gxx = jnp.sum(Ix * Ix, axis=(1, 2))
    gxy = jnp.sum(Ix * Iy, axis=(1, 2))
    gyy = jnp.sum(Iy * Iy, axis=(1, 2))
    det = gxx * gyy - gxy * gxy
    small_eig = 0.5 * (gxx + gyy - jnp.sqrt((gxx - gyy) ** 2 + 4 * gxy * gxy))
    cond_ok = ((gxx + gyy) > 0) & (small_eig / (win * win) > min_eig_floor) \
        & (det > 1e-12)
    inv_det = jnp.where(det > 1e-12, 1.0 / jnp.where(det > 0, det, 1.0), 0.0)
    in_bounds0 = ((pts_prev[:, 0] >= r) & (pts_prev[:, 0] < W - r)
                  & (pts_prev[:, 1] >= r) & (pts_prev[:, 1] < H - r))

    lmax = float(search - win - 1)
    taps = jnp.arange(win, dtype=dt)          # (win,)
    grid = jnp.arange(search, dtype=dt)       # (search,)

    def hat_sel(start):
        """(N,win,SEARCH) linear-interp selector: row r has weights
        hat(grid - (start + r))."""
        pos = start[:, None] + taps[None, :]            # (N,win)
        d = jnp.abs(grid[None, None, :] - pos[..., None])
        return jnp.maximum(0.0, 1.0 - d).astype(dt)

    lx0 = guess[:, 0] - jx0
    ly0 = guess[:, 1] - jy0

    mm_dt = jnp.bfloat16 if ((MM_BF16 or force_bf16)
                             and dt == jnp.float32) else dt
    # HIGHEST: true-f32 matmul passes when operands are f32 — the
    # default f32 matmul precision may multiply in TF32/bf16, which is
    # exactly the precision loss the f32 default above exists to avoid
    mm_prec = (jax.lax.Precision.DEFAULT if mm_dt == jnp.bfloat16
               else jax.lax.Precision.HIGH if _MM_MODE == "high"
               else jax.lax.Precision.HIGHEST)
    S_mm = S_all.astype(mm_dt)

    # points whose system is unusable never converge by the step-size
    # test; mark them converged up front so they can't stall the
    # all-converged early exit below
    dead = ~(cond_ok & in_bounds0 & valid)

    def step(lx, ly, conv):
        cx = jnp.clip(lx - r, 0.0, lmax)
        cy = jnp.clip(ly - r, 0.0, lmax)
        R = hat_sel(cy)                                  # rows  (N,win,S)
        C = hat_sel(cx)                                  # cols  (N,win,S)
        J = jnp.einsum("nrs,nst,nct->nrc",
                       R.astype(mm_dt), S_mm, C.astype(mm_dt),
                       precision=mm_prec,
                       preferred_element_type=dt).astype(dt)
        diff = J - T
        bx = jnp.sum(diff * Ix, axis=(1, 2))
        by = jnp.sum(diff * Iy, axis=(1, 2))
        dx = -(gyy * bx - gxy * by) * inv_det
        dy = -(-gxy * bx + gxx * by) * inv_det
        lx_n = jnp.where(conv, lx, lx + dx)
        ly_n = jnp.where(conv, ly, ly + dy)
        conv = conv | ((dx * dx + dy * dy) < eps * eps)
        return lx_n, ly_n, conv

    def body(carry):
        i, lx, ly, conv = carry
        # UNROLL LK steps per loop trip: identical iterates (converged
        # points never move; the eps check runs per step), but the
        # sequential while_loop carries fewer trips of loop overhead
        for _ in range(UNROLL):
            lx, ly, conv = step(lx, ly, conv)
        return i + UNROLL, lx, ly, conv

    # while_loop instead of a fixed-trip fori: identical iterates (a
    # converged point never moves again), but the whole batch stops as
    # soon as every live point has converged — on gyro-seeded frames
    # that is typically well under the 30-iteration cap
    _, lx, ly, _ = jax.lax.while_loop(
        lambda c: (c[0] < iters) & ~jnp.all(c[3]),
        body, (jnp.asarray(0, jnp.int32), lx0, ly0, dead))

    good = cond_ok & in_bounds0
    use = valid & good
    g_fin = jnp.stack([jnp.where(use, lx + jx0, guess[:, 0]),
                       jnp.where(use, ly + jy0, guess[:, 1])], axis=-1)
    ok_out = use if final else valid
    if final:
        # final template residual (cv::calcOpticalFlowPyrLK's `err`
        # output: mean |window difference| at the converged position) —
        # one extra window-sampling einsum
        cx = jnp.clip(lx - r, 0.0, lmax)
        cy = jnp.clip(ly - r, 0.0, lmax)
        J = jnp.einsum("nrs,nst,nct->nrc",
                       hat_sel(cy).astype(mm_dt), S_mm,
                       hat_sel(cx).astype(mm_dt),
                       precision=mm_prec,
                       preferred_element_type=dt).astype(dt)
        err = jnp.mean(jnp.abs(J - T), axis=(1, 2))
    else:
        err = jnp.zeros(g_fin.shape[0], dt)
    return g_fin, ok_out, err


def _lk_backend() -> str:
    """Level-tracker backend: "xla" (the gather-based path, default on
    every platform) or "mxu" (hat-selector matmuls, selectable with
    XR_LK_BACKEND=mxu for A/B)."""
    import os

    return "mxu" if os.environ.get("XR_LK_BACKEND") == "mxu" else "xla"


def lk_flow(
    prev_pyr, next_pyr, pts_prev, pts_init, valid_in,
    win: int = 21, iters: int = 30, eps: float = 0.01,
    search_top: int = SEARCH,
):
    """Multi-level forward LK. pts are base-level pixel coords (N,2);
    `pts_init` seeds the flow (OPTFLOW_USE_INITIAL_FLOW). The per-level
    refinement runs the gather-based path (_track_level), or the
    hat-selector matmuls over a search block (_track_level_mxu)
    when selected by _lk_backend."""
    levels = len(prev_pyr)
    scale_top = float(2 ** (levels - 1))
    guess = pts_init / scale_top
    valid = valid_in
    err = jnp.zeros(pts_prev.shape[0], prev_pyr[0].dtype)
    backend = _lk_backend()
    for lev in range(levels - 1, -1, -1):
        s = float(2**lev)
        prev_img = prev_pyr[lev]
        ix, iy = img_ops.scharr(prev_img)
        if backend == "mxu":
            # top level absorbs the (gyro-)prediction error → wide
            # search block; lower levels are seeded within ~2 px
            guess, valid, err = _track_level_mxu(
                prev_img, ix, iy, next_pyr[lev], pts_prev / s, guess, valid,
                win=win, iters=iters, eps=eps, final=(lev == 0),
                search=search_top if lev == levels - 1 else 32,
                force_bf16=(MM_MIXED and lev > 0),
            )
        else:
            guess, valid, err = _track_level(
                prev_img, ix, iy, next_pyr[lev], pts_prev / s, guess, valid,
                win=win, iters=iters, eps=eps, final=(lev == 0),
            )
        if lev > 0:
            guess = guess * 2.0
    return guess, valid, err


@partial(jax.jit, static_argnames=("win", "iters", "border"))
def track_keypoints(
    prev_pyr, next_pyr, pts_prev, pts_init, valid_in,
    win: int = 21, iters: int = 30, eps: float = 0.01,
    border: int = 20, reverse_thresh: float = 0.5,
    max_residual: float = 25.0,
):
    """Forward+backward pyramidal LK with the reference's gates
    (opencv_image.cpp:75-154):
      - forward track seeded with pts_init,
      - 20 px border rejection,
      - displacement > rows/4 rejection,
      - backward track seeded with the original points; reject if the
        round trip misses by > 0.5 px,
      - template-residual gate: reject if the converged forward window
        differs from the template by > max_residual mean intensity
        (cv::calcOpticalFlowPyrLK's `err`; catches occlusion/appearance
        change that a zero-motion round trip cannot).

    Returns (pts_next (N,2), status (N,) bool).
    """
    H, W = prev_pyr[0].shape
    fwd, st, err = lk_flow(prev_pyr, next_pyr, pts_prev, pts_init, valid_in, win, iters, eps)

    inb = (
        (fwd[:, 0] >= border) & (fwd[:, 0] < W - border)
        & (fwd[:, 1] >= border) & (fwd[:, 1] < H - border)
    )
    disp = jnp.linalg.norm(fwd - pts_prev, axis=-1)
    st = st & inb & (disp <= H / 4.0) & (err <= max_residual)

    # The reverse pass is seeded at the ORIGINAL points (reference
    # opencv_image.cpp:116-121), so for a good forward track its flow
    # from seed is ~0: the coarse pyramid levels (there to absorb large
    # unknown motion) contribute nothing. Run it at level 0 only with a
    # small search block — a bad forward track whose true inverse flow
    # exceeds the block can't walk back within 0.5 px, so it fails the
    # round-trip gate exactly as a full-pyramid reverse pass would.
    bwd, st_b, _ = lk_flow(
        next_pyr[:1] if BWD_LEVEL0 else next_pyr,
        prev_pyr[:1] if BWD_LEVEL0 else prev_pyr,
        fwd, pts_prev, st, win, iters, eps,
        search_top=32 if BWD_LEVEL0 else SEARCH,
    )
    round_trip = jnp.linalg.norm(bwd - pts_prev, axis=-1)
    st = st & st_b & (round_trip <= reverse_thresh)
    pts_next = jnp.where(st[:, None], fwd, pts_init)
    return pts_next, st
