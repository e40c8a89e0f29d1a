"""Rectified cost-volume construction.

Replaces the reference's hot loop — per-pixel 41x41 SAD over Bresenham
candidates (``/root/reference/src/CameraStereoVision.cpp:49-95``,
O(H*W*pairs*candidates*window^2) single-threaded) — with a fully vectorized
H x W x D volume built from census hamming + Birchfield-Tomasi terms: pure
gather + XOR/popcount/abs elementwise work that XLA fuses.

Layout convention: volumes are (H, W, D) with D minor; D is the natural
shard axis for multi-device cost volumes (parallel/two_view.py).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from stereovisionarray_tpu.ops.census import census_transform, hamming_distance

# integer cost mode: fixed-point scale so 0.25-weighted BT terms stay exact
COST_SCALE = 4


def int8_cost_fits(census_window, bt_weight: float, bt_clip: float) -> bool:
    """True when the worst-case cost (all census bits + clipped BT) fits
    int8 at scale 1. The default 7x9 window gives 62 + 0.25*32 = 70; a
    noise-robust 11x13 window gives 142 + 8 = 150 > 127 and must stay
    int16 (callers fall back, models/two_view.py)."""
    wh, ww = census_window
    worst = (wh * ww - 1) + (bt_weight * bt_clip if bt_weight > 0.0 else 0.0)
    return worst <= 127.0


def cost_scale_for(dtype) -> int:
    """Fixed-point scale for an integer cost dtype.

    int16 uses COST_SCALE=4 (0.25-bit resolution, exact for the default
    bt_weight). int8 must fit the worst cost (62 census bits + 8 BT = 70
    for the default 7x9 window) in [-128, 127], so it quantizes to whole
    census bits (scale 1). Float dtypes scale by 1."""
    dt = jnp.dtype(dtype)
    if dt == jnp.int16:
        return COST_SCALE
    if dt == jnp.int8:
        return 1
    return 1


def census_cost_volume(
    left: jnp.ndarray,
    right: jnp.ndarray,
    num_disparities: int,
    window: Tuple[int, int] = (7, 9),
    dtype=jnp.float32,
    d_offset: int = 0,
) -> jnp.ndarray:
    """(H, W, D) census hamming cost volume for a rectified pair.

    cost[y, x, d] = hamming(census_L[y, x], census_R[y, x - d]).
    d_offset shifts the candidate range to [d_offset, d_offset + D) — the
    disparity-sharding hook (each ``disp`` mesh shard builds its own chunk).
    Out-of-image candidates (x < d) get the worst possible hamming cost so
    WTA never selects them (the reference instead *skips* out-of-bounds
    candidates, ``/root/reference/src/CameraStereoVision.cpp:66-71``).
    """
    wh, ww = window
    n_bits = wh * ww - 1
    cl = census_transform(left, window)  # (H, W, P) uint32
    cr = census_transform(right, window)

    def cost_at(d):
        shifted = _roll_x(cr, d)
        c = hamming_distance(cl, shifted, dtype=dtype)
        # mask invalid (x < d)
        x = jax.lax.broadcasted_iota(jnp.int32, c.shape, c.ndim - 1)
        return jnp.where(x < d, jnp.asarray(n_bits, dtype=dtype), c)

    d_idx = d_offset + jnp.arange(num_disparities, dtype=jnp.int32)
    return jax.vmap(cost_at, out_axes=-1)(d_idx)


def _roll_x(arr: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """Dynamic shift along the x axis by traced integer d (edge-clamped
    gather): out[..., x, ...] = arr[..., max(x-d, 0), ...].

    Census arrays are (H, W, P) — x axis is -2; plain images are (H, W) —
    x axis is -1."""
    axis = -2 if arr.ndim >= 3 else -1
    n = arr.shape[axis]
    idx = jnp.clip(jnp.arange(n) - d, 0, n - 1)
    return jnp.take(arr, idx, axis=axis)


def birchfield_tomasi_volume(
    left: jnp.ndarray,
    right: jnp.ndarray,
    num_disparities: int,
    clip: float = 32.0,
    dtype=jnp.float32,
    d_offset: int = 0,
) -> jnp.ndarray:
    """(H, W, D) Birchfield-Tomasi sampling-insensitive absolute difference.

    BT(xL, xR) = max(0, I_L(xL) - max window_R, min window_R - I_L(xL))
    symmetrized, where window_R is the half-pixel interpolated neighbourhood
    of the right pixel. Robust to half-pixel aliasing that plain SAD (the
    reference's getAbsDiff) suffers from.
    """
    left = left.astype(dtype)
    right = right.astype(dtype)

    def half_pix_bounds(img):
        left_half = 0.5 * (img + jnp.roll(img, 1, axis=-1))
        right_half = 0.5 * (img + jnp.roll(img, -1, axis=-1))
        mn = jnp.minimum(jnp.minimum(left_half, right_half), img)
        mx = jnp.maximum(jnp.maximum(left_half, right_half), img)
        return mn, mx

    r_mn, r_mx = half_pix_bounds(right)
    l_mn, l_mx = half_pix_bounds(left)

    def cost_at(d):
        rs = _roll_x(right, d)
        rmn = _roll_x(r_mn, d)
        rmx = _roll_x(r_mx, d)
        # d(L->R): how far left intensity falls outside right's half-pixel range
        d_lr = jnp.maximum(0.0, jnp.maximum(left - rmx, rmn - left))
        d_rl = jnp.maximum(0.0, jnp.maximum(rs - l_mx, l_mn - rs))
        c = jnp.minimum(jnp.minimum(d_lr, d_rl), clip)
        x = jax.lax.broadcasted_iota(jnp.int32, c.shape, c.ndim - 1)
        return jnp.where(x < d, jnp.asarray(clip, dtype=dtype), c)

    d_idx = d_offset + jnp.arange(num_disparities, dtype=jnp.int32)
    return jax.vmap(cost_at, out_axes=-1)(d_idx)


def fused_cost_volume(
    left: jnp.ndarray,
    right: jnp.ndarray,
    num_disparities: int,
    census_window: Tuple[int, int] = (7, 9),
    bt_weight: float = 0.25,
    bt_clip: float = 32.0,
    dtype=jnp.float32,
    d_offset: int = 0,
) -> jnp.ndarray:
    """Census hamming + weighted BT — the production matching cost
    (PlaneSweep/SGM configs 1-2 in BASELINE.json), (H, W, D)."""
    out_dtype = jnp.dtype(dtype)
    integer_costs = jnp.issubdtype(out_dtype, jnp.integer)
    # integer mode: build in f32, scale by COST_SCALE, round into the
    # integer dtype (XLA fuses the conversion into the producer, so the
    # volume is written once at half the bytes of f32; the SGM penalties
    # are scaled by the same factor, models/two_view.py::aggregate_costs)
    build_dtype = jnp.float32 if integer_costs else out_dtype
    vol = census_cost_volume(
        left, right, num_disparities, census_window, dtype=build_dtype,
        d_offset=d_offset,
    )
    if bt_weight > 0.0:
        vol = vol + bt_weight * birchfield_tomasi_volume(
            left, right, num_disparities, clip=bt_clip, dtype=build_dtype,
            d_offset=d_offset,
        )
    if integer_costs:
        vol = jnp.round(vol * cost_scale_for(out_dtype)).astype(out_dtype)
    return vol


def right_from_left_volume(vol: jnp.ndarray) -> jnp.ndarray:
    """Re-index a left cost volume as the right camera's volume:
    cost_R[y, x, d] = cost_L[y, x + d, d]. Used by the left-right consistency
    check without building a second volume.

    Implemented as one edge-clamped column shift per d-slice (vmap over D)."""
    h, w, D = vol.shape

    def shift_slice(slice_d: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
        idx = jnp.clip(jnp.arange(w) + d, 0, w - 1)
        return jnp.take(slice_d, idx, axis=1)

    return jax.vmap(shift_slice, in_axes=(-1, 0), out_axes=-1)(
        vol, jnp.arange(D, dtype=jnp.int32)
    )
