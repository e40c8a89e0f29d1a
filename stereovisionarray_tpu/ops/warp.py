"""View-warping operators — the vectorized generalization of the reference's
per-pixel perspective shifts.

Reference equivalents (``/root/reference/src/functions.cpp:55-103``):
 - ``shiftPerspectiveWithDisparity``: backward gather along the unit baseline
   direction, ``dst(y,x) = src(y + d*uy, x + d*ux)`` -> :func:`warp_with_disparity`
   (with bilinear interpolation instead of integer truncation).
 - ``shiftPerspective2``: forward depth splat with no z-buffering ->
   :func:`splat_depth` (with a proper min-z scatter so near surfaces win).

Plus :func:`homography_warp`, the plane-sweep primitive (one 3x3 homography
per (view, depth-plane), applied to the whole pixel grid as einsum + bilinear
gather — the inner loop of N-view fusion).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp


def bilinear_sample(
    image: jnp.ndarray,
    coords: jnp.ndarray,
    fill: float = 0.0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Bilinearly sample `image` (H, W) at float coords (..., 2) in uv order
    (u = x = column, v = y = row).

    Returns (values (...,), in_bounds (...,) bool). Out-of-bounds samples get
    `fill` and in_bounds=False. Implemented as 4 clipped gathers + lerp —
    static shapes, no data-dependent control flow."""
    h, w = image.shape[-2:]
    u = coords[..., 0]
    v = coords[..., 1]
    u0 = jnp.floor(u)
    v0 = jnp.floor(v)
    fu = u - u0
    fv = v - v0
    u0i = u0.astype(jnp.int32)
    v0i = v0.astype(jnp.int32)

    def gather(yi, xi):
        yc = jnp.clip(yi, 0, h - 1)
        xc = jnp.clip(xi, 0, w - 1)
        return image[..., yc, xc]

    i00 = gather(v0i, u0i)
    i01 = gather(v0i, u0i + 1)
    i10 = gather(v0i + 1, u0i)
    i11 = gather(v0i + 1, u0i + 1)
    top = i00 * (1.0 - fu) + i01 * fu
    bot = i10 * (1.0 - fu) + i11 * fu
    val = top * (1.0 - fv) + bot * fv
    inb = (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1)
    return jnp.where(inb, val, fill), inb


def homography_warp(
    image: jnp.ndarray,
    H: jnp.ndarray,
    out_shape: Optional[Tuple[int, int]] = None,
    fill: float = 0.0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Warp `image` (Hs, Ws) into the reference frame through homography H
    (3, 3) mapping *reference* pixels to *source* pixels (the direction
    returned by ``CameraArray.fronto_plane_homography``).

    Returns (warped (Ho, Wo), valid (Ho, Wo))."""
    ho, wo = out_shape if out_shape is not None else image.shape[-2:]
    v, u = jnp.meshgrid(
        jnp.arange(ho, dtype=image.dtype if jnp.issubdtype(image.dtype, jnp.floating) else jnp.float32),
        jnp.arange(wo, dtype=image.dtype if jnp.issubdtype(image.dtype, jnp.floating) else jnp.float32),
        indexing="ij",
    )
    ones = jnp.ones_like(u)
    # full f32: a 1e-3 relative error is ~0.4 px at 360 columns
    src = jnp.einsum("ij,jhw->ihw", H, jnp.stack([u, v, ones]),
                     precision=jax.lax.Precision.HIGHEST)
    z = src[2]
    inv_z = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    coords = jnp.stack([src[0] * inv_z, src[1] * inv_z], axis=-1)
    return bilinear_sample(image, coords, fill=fill)


def warp_with_disparity(
    image: jnp.ndarray,
    disparity: jnp.ndarray,
    baseline_uv: jnp.ndarray,
    fill: float = 0.0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Warp a source image into the reference view given a per-pixel
    disparity magnitude and the (unit) epipolar direction `baseline_uv` (2,).

    dst(y, x) = src(y + d*uy, x + d*ux) — bilinear. Pixels with disparity
    <= 0 are filled (the reference skips them,
    ``/root/reference/src/functions.cpp:66``)."""
    h, w = image.shape
    v, u = jnp.meshgrid(
        jnp.arange(h, dtype=disparity.dtype), jnp.arange(w, dtype=disparity.dtype), indexing="ij"
    )
    coords = jnp.stack(
        [u + disparity * baseline_uv[0], v + disparity * baseline_uv[1]], axis=-1
    )
    val, inb = bilinear_sample(image, coords, fill=fill)
    ok = inb & (disparity > 0)
    return jnp.where(ok, val, fill), ok


def splat_depth(
    depth: jnp.ndarray,
    shift_uv: jnp.ndarray,
    fill: float = 0.0,
) -> jnp.ndarray:
    """Forward-splat a depth map into another view by per-pixel shift
    (..., 2) with min-z resolution (nearest surface wins — fixing the
    reference's last-write-wins hole-punching,
    ``/root/reference/src/functions.cpp:91-95``).

    depth: (H, W); shift_uv: (H, W, 2) integer-roundable pixel offsets.
    Returns (H, W) splatted depth, `fill` in holes."""
    h, w = depth.shape
    v, u = jnp.meshgrid(jnp.arange(h), jnp.arange(w), indexing="ij")
    tu = jnp.round(u + shift_uv[..., 0]).astype(jnp.int32)
    tv = jnp.round(v + shift_uv[..., 1]).astype(jnp.int32)
    inb = (tu >= 0) & (tu < w) & (tv >= 0) & (tv < h) & (depth > 0)
    flat_idx = jnp.where(inb, tv * w + tu, h * w)  # OOB bucket at the end
    big = jnp.finfo(depth.dtype).max
    src = jnp.where(inb, depth, big).reshape(-1)
    out = jnp.full((h * w + 1,), big, dtype=depth.dtype)
    out = out.at[flat_idx.reshape(-1)].min(src)
    out = out[:-1].reshape(h, w)
    return jnp.where(out == big, fill, out)
