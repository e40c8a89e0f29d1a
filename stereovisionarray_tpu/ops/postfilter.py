"""Disparity post-filtering: 3x3 median + speckle suppression.

Standard production-SGM post-processing that the reference lacks entirely
(its output is raw WTA + a local refine pass,
``/root/reference/src/CameraStereoVision.cpp:85-95``): a median filter
knocks out single-pixel outliers the parabola can't fix, and a speckle
filter suppresses small floating blobs of locally-consistent-but-wrong
disparity that survive the LR check.

Program shapes: the median is a 9-element sorting network (19 min/max
pairs) over shifted copies — elementwise only, no gathers; the speckle filter is the
O(HW) windowed-support approximation (box-count of similar-disparity
neighbours) instead of exact connected components (whose iteration count
is data-dependent — hostile to XLA's static control flow).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax.numpy as jnp

from stereovisionarray_tpu.ops.refine import box_filter2d
from stereovisionarray_tpu.ops.wta import INVALID_DISPARITY

__all__ = ["median3x3", "speckle_filter", "fill_holes"]


def _shifted(x: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    """Edge-replicated shift of (H, W)."""
    if dy > 0:
        x = jnp.concatenate([x[:1].repeat(dy, 0), x[:-dy]], axis=0)
    elif dy < 0:
        x = jnp.concatenate([x[-dy:], x[-1:].repeat(-dy, 0)], axis=0)
    if dx > 0:
        x = jnp.concatenate([x[:, :1].repeat(dx, 1), x[:, :-dx]], axis=1)
    elif dx < 0:
        x = jnp.concatenate([x[:, -dx:], x[:, -1:].repeat(-dx, 1)], axis=1)
    return x


def median3x3(
    disp: jnp.ndarray, valid: Optional[jnp.ndarray] = None
) -> jnp.ndarray:
    """3x3 median of a disparity map.

    Invalid neighbours (where ~valid) contribute the CENTER value instead,
    so the median never drags valid pixels toward the invalid sentinel;
    invalid centers stay invalid."""
    if valid is not None:
        src = jnp.where(valid, disp, 0.0)
    else:
        src = disp
    vals = []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            n = _shifted(src, dy, dx)
            if valid is not None:
                nv = _shifted(valid, dy, dx)
                n = jnp.where(nv, n, src)
            vals.append(n)

    # 9-element median via a minimal sorting network (Paeth): 19 exchanges
    def mn(a, b):
        return jnp.minimum(a, b), jnp.maximum(a, b)

    p = vals
    p[1], p[2] = mn(p[1], p[2]); p[4], p[5] = mn(p[4], p[5]); p[7], p[8] = mn(p[7], p[8])
    p[0], p[1] = mn(p[0], p[1]); p[3], p[4] = mn(p[3], p[4]); p[6], p[7] = mn(p[6], p[7])
    p[1], p[2] = mn(p[1], p[2]); p[4], p[5] = mn(p[4], p[5]); p[7], p[8] = mn(p[7], p[8])
    p[0], p[3] = mn(p[0], p[3]); p[5], p[8] = mn(p[5], p[8]); p[4], p[7] = mn(p[4], p[7])
    p[3], p[6] = mn(p[3], p[6]); p[1], p[4] = mn(p[1], p[4]); p[2], p[5] = mn(p[2], p[5])
    p[4], p[7] = mn(p[4], p[7]); p[4], p[2] = mn(p[4], p[2]); p[6], p[4] = mn(p[6], p[4])
    p[4], p[2] = mn(p[4], p[2])
    med = p[4]

    if valid is not None:
        return jnp.where(valid, med, disp)
    return med


def speckle_filter(
    disp: jnp.ndarray,
    valid: Optional[jnp.ndarray] = None,
    max_diff: float = 1.0,
    window: int = 9,
    min_support: int = 12,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Suppress small isolated disparity blobs.

    A pixel survives if at least `min_support` pixels inside its
    `window`x`window` neighbourhood have disparity within `max_diff` of its
    own (windowed-support approximation of OpenCV-style speckle region
    filtering — a region smaller than ~min_support cannot provide the
    support, while large smooth regions always do).

    Returns (filtered_disp, new_valid); suppressed pixels get
    INVALID_DISPARITY.

    Method: EXACT windowed support — for every pixel, count window
    neighbours whose disparity is within `max_diff` of the pixel's own
    (window² shifted compares, all elementwise passes over (H, W); ~100 MB of
    traffic at 540x768 with window=9 — cheap). Per-side counting means
    depth discontinuities keep both surfaces (each side supports itself),
    unlike local-mean schemes."""
    v = valid if valid is not None else disp >= 0
    r = window // 2
    support = jnp.zeros_like(disp)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            nd = _shifted(disp, dy, dx)
            nv = _shifted(v, dy, dx)
            ok = nv & (jnp.abs(disp - nd) <= max_diff)
            support = support + jnp.where(ok, 1.0, 0.0)
    keep = v & (support >= min_support)
    out = jnp.where(keep, disp, INVALID_DISPARITY)
    return out, keep


def _propagate(disp: jnp.ndarray, valid: jnp.ndarray, dx: int, span: int):
    """Nearest-valid value along +-x via log-doubling jumps.

    Equivalent to a serial scan carrying the last valid disparity, but in
    ceil(log2(span)) shifted select passes over (H, W) — the data-parallel
    parallel-prefix form (a 768-step lax.scan would dispatch 768 tiny ops).
    dx=+1 propagates left values rightward; dx=-1 the reverse. Pixels with
    no valid source within `span` stay unfilled."""
    val = jnp.where(valid, disp, 0.0)
    has = valid
    step = 1
    while step < span:
        sv = _shifted(val, 0, dx * step)
        sh = _shifted(has, 0, dx * step)
        # edge replication would smear the border pixel's own (possibly
        # unfilled) state; kill wrapped-in flags at the border explicitly
        col = jnp.arange(disp.shape[1])
        inside = (col >= step) if dx > 0 else (col < disp.shape[1] - step)
        sh = sh & inside[None, :]
        take = ~has & sh
        val = jnp.where(take, sv, val)
        has = has | sh
        step *= 2
    return val, has


def fill_holes(
    disp: jnp.ndarray,
    valid: Optional[jnp.ndarray] = None,
    max_span: Optional[int] = None,
    take: str = "min",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Fill invalid disparities with the nearest valid row neighbours.

    Standard SGM gap interpolation (Hirschmueller 2008 §IV-D; absent from
    the reference, whose unmatched pixels keep uninitialized memory,
    ``/root/reference/src/CameraStereoVision.cpp:46`` / SURVEY §2.3.3):
    occlusions are filled with the BACKGROUND side of the nearest valid
    values to the left and right — an occluded pixel belongs to the
    background surface by construction — while pixels with only one valid
    side take that side. ``take`` selects which side is background:
    ``"min"`` for disparity maps (background = smaller disparity),
    ``"max"`` for plane-index maps whose index grows with depth
    (inverse-depth plane sweeps: index 0 = z_near, so background = larger
    index — models/cascade_sweep.py).

    Elementwise only: two log-doubling nearest-valid propagations + one select;
    no gathers, no data-dependent shapes. Returns (filled, filled_valid);
    filled_valid marks pixels that are valid OR were filled (rows that are
    entirely invalid stay unfilled)."""
    if take not in ("min", "max"):
        raise ValueError(f"take must be 'min' or 'max', got {take!r}")
    v = valid if valid is not None else disp >= 0
    span = int(max_span) if max_span is not None else int(disp.shape[1])
    # a doubling jump >= the row width would shift the whole row out of
    # frame (and _shifted would mis-shape); the row width always bounds
    # the useful span
    span = min(span, int(disp.shape[1]))
    lval, lhas = _propagate(disp, v, +1, span)
    rval, rhas = _propagate(disp, v, -1, span)
    both = lhas & rhas
    pick = jnp.minimum if take == "min" else jnp.maximum
    fill = jnp.where(
        both,
        pick(lval, rval),
        jnp.where(lhas, lval, rval),
    )
    any_side = lhas | rhas
    out = jnp.where(v, disp, jnp.where(any_side, fill, INVALID_DISPARITY))
    return out, v | any_side
