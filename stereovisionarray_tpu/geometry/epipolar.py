"""Epipolar candidate generation — the vectorized replacement of
the reference's per-pixel Bresenham rasterization.

The reference enumerates disparity candidates by projecting two points at
0.5x and 1.0x along each pixel's ray and walking the integer segment between
them with Bresenham (reference ``src/CameraStereoVision.cpp:60-73`` and
``src/functions.cpp:253-321``). Here that becomes: sample D
depth hypotheses (uniform in inverse depth), backproject + reproject the whole
pixel grid at once, and bilinearly gather — no integer line walking, no
per-pixel control flow, static shapes throughout.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from stereovisionarray_tpu.geometry.camera import CameraArray


def inverse_depth_samples(z_near: float, z_far: float, num: int, dtype=jnp.float32) -> jnp.ndarray:
    """(D,) depth hypotheses uniform in inverse depth (near -> far). Uniform
    inverse depth makes pixel-space candidate spacing roughly uniform — the
    principled version of the reference's [0.5x, 1.0x]-ray bracket."""
    inv = jnp.linspace(1.0 / z_near, 1.0 / z_far, num, dtype=dtype)
    return 1.0 / inv


def pixel_grid(height: int, width: int, dtype=jnp.float32) -> jnp.ndarray:
    """(H, W, 2) pixel-center coordinates, uv order (u = column, v = row)."""
    v, u = jnp.meshgrid(
        jnp.arange(height, dtype=dtype), jnp.arange(width, dtype=dtype), indexing="ij"
    )
    return jnp.stack([u, v], axis=-1)


def epipolar_candidates(
    cameras: CameraArray,
    ref: int,
    src: int,
    resolution: Tuple[int, int],
    depths: jnp.ndarray,
) -> jnp.ndarray:
    """Candidate match coordinates in the source view.

    For every reference pixel and every depth hypothesis, backproject from the
    reference camera and project into the source camera.

    Returns (D, H, W, 2) float source-pixel coords (uv order). D leads so a
    scan/shard over the disparity axis touches contiguous slabs.
    """
    h, w = resolution
    cam_ref = cameras[ref]
    cam_src = cameras[src]
    uv = pixel_grid(h, w)  # (H, W, 2)
    depths = jnp.asarray(depths, dtype=uv.dtype)

    def at_depth(d):
        pts = cam_ref.backproject(uv, jnp.full((h, w), d, dtype=uv.dtype))
        uv_src, _ = cam_src.project(pts)
        return uv_src

    return jax.vmap(at_depth)(jnp.atleast_1d(depths))


def rectified_shift_candidates(width: int, num_disparities: int, dtype=jnp.float32) -> jnp.ndarray:
    """(D, W) source x-coordinates for a rectified pair: x_src = x - d.
    The degenerate (and by far most common) epipolar geometry; used by the
    two-view SGM pipeline where candidates never need explicit coords —
    provided for parity tests against :func:`epipolar_candidates`."""
    x = jnp.arange(width, dtype=dtype)[None, :]
    d = jnp.arange(num_disparities, dtype=dtype)[:, None]
    return x - d
