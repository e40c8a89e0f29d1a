"""Census transform + Hamming distance — the matching cost that replaces the
reference's 41x41 SAD patches (``/root/reference/src/CameraStereoVision.cpp:44,57``,
``getAbsDiff`` at ``/root/reference/src/functions.cpp:215-218``).

Census is the standard SGM cost: robust to radiometric differences, and it
turns the whole patch comparison into a couple of uint32 XOR + popcount
elementwise ops per candidate instead of a window reduction, so the cost volume build is
pure elementwise work that XLA fuses into the gather.

Bit packing: a (wh, ww) census window has wh*ww - 1 comparison bits; they are
packed little-endian into ``ceil(bits/32)`` uint32 planes so any window up to
the configured size works (default 7x9 = 62 bits = 2 planes, matching classic
SGM implementations).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def census_transform(image: jnp.ndarray, window: Tuple[int, int] = (7, 9)) -> jnp.ndarray:
    """Census transform of a grayscale image.

    image: (..., H, W) float or integer intensities.
    window: (wh, ww), both odd.

    Returns (..., H, W, P) uint32 with P = ceil((wh*ww - 1) / 32) bit planes.
    Out-of-bounds neighbours compare against an edge-padded image (standard
    practice; keeps shapes static and borders usable).
    """
    wh, ww = window
    if wh % 2 == 0 or ww % 2 == 0:
        raise ValueError(f"census window must be odd, got {window}")
    n_bits = wh * ww - 1
    n_planes = (n_bits + 31) // 32

    ph, pw = wh // 2, ww // 2
    pad = [(0, 0)] * (image.ndim - 2) + [(ph, ph), (pw, pw)]
    padded = jnp.pad(image, pad, mode="edge")

    h, w = image.shape[-2], image.shape[-1]
    center = image

    planes = []
    bit_idx = 0
    current = jnp.zeros(image.shape, dtype=jnp.uint32)
    for dy in range(-ph, ph + 1):
        for dx in range(-pw, pw + 1):
            if dy == 0 and dx == 0:
                continue
            neighbor = jax.lax.dynamic_slice_in_dim(
                jax.lax.dynamic_slice_in_dim(padded, dy + ph, h, axis=-2),
                dx + pw,
                w,
                axis=-1,
            )
            bit = (neighbor < center).astype(jnp.uint32)
            current = current | (bit << jnp.uint32(bit_idx % 32))
            bit_idx += 1
            if bit_idx % 32 == 0:
                planes.append(current)
                current = jnp.zeros(image.shape, dtype=jnp.uint32)
    if bit_idx % 32 != 0:
        planes.append(current)
    assert len(planes) == n_planes
    return jnp.stack(planes, axis=-1)


def hamming_distance(a: jnp.ndarray, b: jnp.ndarray, dtype=jnp.float32) -> jnp.ndarray:
    """Hamming distance between packed census codes.

    a, b: (..., P) uint32 bit planes. Returns (...,) in `dtype` — popcount of
    XOR summed over planes (one elementwise op chain; the reference's whole 41x41
    getAbsDiff patch loop collapses to this)."""
    x = jax.lax.population_count(a ^ b)
    return jnp.sum(x, axis=-1).astype(dtype)
