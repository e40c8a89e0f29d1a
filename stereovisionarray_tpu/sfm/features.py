"""Harris corner detection + normalized-patch descriptors.

The reference has no feature pipeline at all (poses are hard-coded constants,
``/root/reference/src/CameraStereoVision.cpp:33-39``); this provides the
measurement front-end for array calibration (SURVEY.md §7 step 8).

Static-shape discipline: every image yields exactly ``max_features`` corners
(top-k by NMS'd Harris response) with a validity mask — no dynamic shapes, so
detection vmaps over the 25-view array and the descriptor distance matrix is
one matmul.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp


class Features(NamedTuple):
    uv: jnp.ndarray  # (F, 2) float32 pixel coords (u=x, v=y), subpixel
    response: jnp.ndarray  # (F,) Harris response
    descriptor: jnp.ndarray  # (F, K) L2-normalized patch descriptor
    valid: jnp.ndarray  # (F,) bool


def _sobel(image: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Image gradients via 3x3 Sobel (edge-padded, separable)."""
    p = jnp.pad(image, 1, mode="edge")
    # horizontal derivative: smooth in y, diff in x
    sy = p[:-2, :] + 2.0 * p[1:-1, :] + p[2:, :]
    gx = (sy[:, 2:] - sy[:, :-2]) / 8.0
    sx = p[:, :-2] + 2.0 * p[:, 1:-1] + p[:, 2:]
    gy = (sx[2:, :] - sx[:-2, :]) / 8.0
    return gx, gy


def _box(x: jnp.ndarray, k: int) -> jnp.ndarray:
    """k x k mean filter (separable cumsum, edge-padded)."""
    p = k // 2

    def along(a, axis):
        pad = [(0, 0)] * a.ndim
        pad[axis] = (p + 1, p)
        ap = jnp.pad(a, pad, mode="edge")
        c = jnp.cumsum(ap, axis=axis)
        hi = jax.lax.slice_in_dim(c, k, k + a.shape[axis], axis=axis)
        lo = jax.lax.slice_in_dim(c, 0, a.shape[axis], axis=axis)
        return (hi - lo) / k

    return along(along(x, -1), -2)


def harris_response(image: jnp.ndarray, k: float = 0.05, window: int = 5) -> jnp.ndarray:
    """Harris corner response det(M) - k tr(M)^2 of the box-filtered
    structure tensor M = [[gx^2, gx gy], [gx gy, gy^2]]."""
    gx, gy = _sobel(image.astype(jnp.float32))
    a = _box(gx * gx, window)
    b = _box(gx * gy, window)
    c = _box(gy * gy, window)
    det = a * c - b * b
    tr = a + c
    return det - k * tr * tr


def _nms(resp: jnp.ndarray, radius: int) -> jnp.ndarray:
    """Non-maximum suppression: keep responses equal to their local max in a
    (2r+1)^2 window (implemented as a max reduce_window)."""
    k = 2 * radius + 1
    local_max = jax.lax.reduce_window(
        resp, -jnp.inf, jax.lax.max, (k, k), (1, 1), "SAME"
    )
    return jnp.where(resp >= local_max, resp, -jnp.inf)


@functools.partial(
    jax.jit, static_argnames=("max_features", "nms_radius", "window", "border")
)
def detect_features(
    image: jnp.ndarray,
    max_features: int = 512,
    k: float = 0.05,
    nms_radius: int = 4,
    window: int = 5,
    border: int = 8,
    min_response_ratio: float = 1e-4,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Top ``max_features`` Harris corners after NMS.

    Returns (uv (F, 2) float32, response (F,), valid (F,) bool). Corners
    weaker than ``min_response_ratio * max_response`` or inside ``border``
    pixels of the edge are invalid (padding slots)."""
    h, w = image.shape
    resp = harris_response(image, k=k, window=window)
    nms = _nms(resp, nms_radius)
    # exclude image border (descriptor patches must fit)
    v_idx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    u_idx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    interior = (
        (v_idx >= border) & (v_idx < h - border) & (u_idx >= border) & (u_idx < w - border)
    )
    nms = jnp.where(interior, nms, -jnp.inf)

    flat = nms.reshape(-1)
    top_vals, top_idx = jax.lax.top_k(flat, max_features)
    vv = (top_idx // w).astype(jnp.int32)
    uu = (top_idx % w).astype(jnp.int32)

    # subpixel refinement: 1D parabola through the raw response along each
    # axis. Integer corners carry a per-view quantization *bias* (the same
    # physical corner rounds differently in different views), which
    # propagates into multi-millimetre pose bias in calibration — subpixel
    # localization removes it to first order.
    def parab(center, minus, plus):
        denom = minus - 2.0 * center + plus
        delta = jnp.where(jnp.abs(denom) > 1e-12, 0.5 * (minus - plus) / denom, 0.0)
        return jnp.clip(delta, -0.5, 0.5)

    def r_at(dv, du):
        return resp[jnp.clip(vv + dv, 0, h - 1), jnp.clip(uu + du, 0, w - 1)]

    du = parab(r_at(0, 0), r_at(0, -1), r_at(0, 1))
    dv = parab(r_at(0, 0), r_at(-1, 0), r_at(1, 0))
    uv = jnp.stack([uu.astype(jnp.float32) + du, vv.astype(jnp.float32) + dv], axis=-1)
    max_resp = jnp.maximum(top_vals[0], 1e-12)
    valid = (top_vals > min_response_ratio * max_resp) & jnp.isfinite(top_vals)
    return uv, top_vals, valid


@functools.partial(jax.jit, static_argnames=("patch", "stride"))
def describe_patches(
    image: jnp.ndarray, uv: jnp.ndarray, patch: int = 8, stride: int = 2
) -> jnp.ndarray:
    """Mean/std-normalized intensity patch descriptors.

    Samples a (patch x patch) grid with ``stride``-pixel spacing around each
    corner (bilinear), normalizes to zero mean / unit norm — a cheap,
    rotation-fragile descriptor that is plenty for the near-parallel views of
    a camera array (the reference's implicit assumption too: its pair search
    is pure translation, ``/root/reference/src/functions.cpp:55-77``)."""
    half = (patch - 1) / 2.0
    offs = (jnp.arange(patch, dtype=jnp.float32) - half) * stride
    du, dv = jnp.meshgrid(offs, offs, indexing="xy")
    su = uv[:, None, None, 0] + du[None]  # (F, p, p)
    sv = uv[:, None, None, 1] + dv[None]
    h, w = image.shape
    u0 = jnp.floor(su).astype(jnp.int32)
    v0 = jnp.floor(sv).astype(jnp.int32)
    fu = su - u0
    fv = sv - v0

    def g(vi, ui):
        return image[jnp.clip(vi, 0, h - 1), jnp.clip(ui, 0, w - 1)]

    val = (
        g(v0, u0) * (1 - fu) * (1 - fv)
        + g(v0, u0 + 1) * fu * (1 - fv)
        + g(v0 + 1, u0) * (1 - fu) * fv
        + g(v0 + 1, u0 + 1) * fu * fv
    )
    d = val.reshape(val.shape[0], -1)
    d = d - jnp.mean(d, axis=-1, keepdims=True)
    n = jnp.linalg.norm(d, axis=-1, keepdims=True)
    return d / jnp.maximum(n, 1e-6)


def extract_features(
    image: jnp.ndarray,
    max_features: int = 512,
    k: float = 0.05,
    nms_radius: int = 4,
    patch: int = 8,
    stride: int = 2,
) -> Features:
    """Detection + description in one call (vmap over views for the array)."""
    uv, resp, valid = detect_features(
        image, max_features=max_features, k=k, nms_radius=nms_radius
    )
    desc = describe_patches(image, uv, patch=patch, stride=stride)
    return Features(uv=uv, response=resp, descriptor=desc, valid=valid)
