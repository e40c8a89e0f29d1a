"""Geometric ROI mask construction (jitted, fixed shapes).

Reference equivalents:
 - ``getFaceMask``: ``cv::fillConvexPoly`` over jaw landmarks 0-16 plus brow
   landmarks 24 and 19 (``/root/reference/src/dlibFaceSelect.cpp:29-36``)
   -> :func:`face_mask_from_landmarks` (half-plane intersection test — the
   whole-array polygon fill: one sign test per edge per pixel, no scanline).
 - ``getFaceCircle``: ellipse from landmarks 0/16 (face width) and 8 (chin)
   with empirical factors 0.75 / 0.25 / 1.7
   (``/root/reference/src/dlibFaceSelect.cpp:50-62``)
   -> :func:`face_ellipse_from_landmarks` + :func:`ellipse_mask`.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("shape",))
def ellipse_mask(
    shape: Tuple[int, int],
    center: jnp.ndarray,
    axes: jnp.ndarray,
    angle: jnp.ndarray = 0.0,
) -> jnp.ndarray:
    """(H, W) bool mask of an ellipse.

    center: (2,) (u, v); axes: (2,) semi-axes (a along the rotated u axis,
    b along v); angle: radians, counter-clockwise."""
    h, w = shape
    v = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    u = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    du = u - center[0]
    dv = v - center[1]
    ca = jnp.cos(angle)
    sa = jnp.sin(angle)
    x = du * ca + dv * sa
    y = -du * sa + dv * ca
    a = jnp.maximum(axes[0], 1e-6)
    b = jnp.maximum(axes[1], 1e-6)
    return (x / a) ** 2 + (y / b) ** 2 <= 1.0


@functools.partial(jax.jit, static_argnames=("shape",))
def convex_polygon_mask(shape: Tuple[int, int], vertices: jnp.ndarray) -> jnp.ndarray:
    """(H, W) bool mask of a convex polygon given CCW-or-CW vertices (K, 2)
    in (u, v) pixel coords.

    Pixel p is inside iff every edge cross product shares one sign — a dense
    K-way AND over the pixel grid (the reference's fillConvexPoly scanline,
    vectorized)."""
    h, w = shape
    v = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    u = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    p0 = vertices
    p1 = jnp.roll(vertices, -1, axis=0)
    # cross((p1-p0), (p - p0)) per edge, per pixel: (K, H, W)
    ex = (p1[:, 0] - p0[:, 0])[:, None, None]
    ey = (p1[:, 1] - p0[:, 1])[:, None, None]
    px = u[None] - p0[:, 0][:, None, None]
    py = v[None] - p0[:, 1][:, None, None]
    cross = ex * py - ey * px
    inside_ccw = jnp.all(cross >= 0.0, axis=0)
    inside_cw = jnp.all(cross <= 0.0, axis=0)
    return inside_ccw | inside_cw


def face_mask_from_landmarks(
    shape: Tuple[int, int], landmarks: jnp.ndarray
) -> jnp.ndarray:
    """Face mask from 68-point landmarks (u, v): convex hull of the jaw
    contour (0-16) plus the brow points 24 and 19 — the exact vertex recipe
    of the reference (``/root/reference/src/dlibFaceSelect.cpp:29-34``)."""
    poly = jnp.concatenate(
        [landmarks[0:17], landmarks[24:25], landmarks[19:20]], axis=0
    )
    return convex_polygon_mask(shape, poly)


def face_ellipse_from_landmarks(landmarks: jnp.ndarray):
    """(center (2,), axes (2,), angle) — the reference's getFaceCircle
    geometry: width from landmarks 0-16, chin at 8, ellipse centred 0.75 /
    0.25 between brow line and chin, height 1.7x the half-width
    (``/root/reference/src/dlibFaceSelect.cpp:50-62``)."""
    left = landmarks[0]
    right = landmarks[16]
    chin = landmarks[8]
    width = jnp.linalg.norm(right - left)
    mid = 0.5 * (left + right)
    center = 0.75 * mid + 0.25 * chin
    a = 0.5 * width
    b = 0.5 * 1.7 * width
    angle = jnp.arctan2(right[1] - left[1], right[0] - left[0])
    return center, jnp.stack([a, b]), angle
