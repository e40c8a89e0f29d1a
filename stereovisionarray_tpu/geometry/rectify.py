"""Planar stereo rectification for general calibrated pairs.

The reference's matcher assumes a translation-only rig, so its epipolar
lines are trivially axis-aligned (``/root/reference/src/Camera.cpp:15-33``
has no rotation at all). The general engine needs the standard step the
reference skips: given two cameras with arbitrary R|t, compute the pair of
homographies that map both images onto a common fronto-parallel plane where
epipolar lines are horizontal and row-aligned — after which
``models/two_view.two_view_disparity`` applies directly.

Method (Fusiello-Trucco-Verri "A compact algorithm for rectification of
stereo pairs"): the new shared rotation takes the baseline as the x axis,
the y axis orthogonal to both the baseline and the old z, and z completing
the frame; both views get a common intrinsic matrix; each homography is
``K_new · R_new · R_oldᵀ · K_old⁻¹``.

Pure jax.numpy, jit-safe, batched over nothing (two 3x3 solves).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

# float32 matmuls pinned to full precision: a GPU may otherwise run them in
# TF32 (about 3 decimal digits)
_HI = jax.lax.Precision.HIGHEST

from stereovisionarray_tpu.geometry.camera import CameraArray
from stereovisionarray_tpu.ops.warp import homography_warp

__all__ = ["RectifiedPair", "rectify_pair", "rectified_disparity_to_depth"]


class RectifiedPair(NamedTuple):
    H_left: jnp.ndarray  # (3, 3) maps NEW left pixels -> OLD left pixels
    H_right: jnp.ndarray  # (3, 3) same for right
    K_new: jnp.ndarray  # (3, 3) shared rectified intrinsics
    baseline: jnp.ndarray  # scalar metric baseline along the new x axis
    R_new: jnp.ndarray  # (3, 3) shared rectified world-to-cam rotation


def _camera_K_Rt(cameras: CameraArray, i: int):
    K = cameras.K
    K_i = K[i] if K.ndim == 3 else K
    R_i = cameras.R[i] if cameras.R.ndim == 3 else cameras.R
    t_i = cameras.t[i] if cameras.t.ndim == 2 else cameras.t
    return K_i, R_i, t_i


def rectify_pair(cameras: CameraArray, left: int, right: int) -> RectifiedPair:
    """Rectifying homographies for views (left, right) of a calibrated array.

    Returns homographies in the REFERENCE-pixels -> SOURCE-pixels direction
    (directly consumable by ``ops.warp.homography_warp``): warp each image
    with its homography and the results form a row-aligned rectified pair
    with disparity along +x."""
    K_l, R_l, t_l = _camera_K_Rt(cameras, left)
    K_r, R_r, t_r = _camera_K_Rt(cameras, right)
    # camera centers: x_cam = R x + t -> C = -Rᵀ t
    c_l = -jnp.matmul(R_l.T, t_l, precision=_HI)
    c_r = -jnp.matmul(R_r.T, t_r, precision=_HI)

    # new x axis: the baseline (left -> right)
    b = c_r - c_l
    baseline = jnp.linalg.norm(b)
    x_new = b / jnp.maximum(baseline, 1e-12)
    # new y axis: orthogonal to x and the old left optical axis (R_l row 2)
    z_old = R_l[2]
    y_new = jnp.cross(z_old, x_new)
    y_new = y_new / jnp.maximum(jnp.linalg.norm(y_new), 1e-12)
    z_new = jnp.cross(x_new, y_new)
    R_new = jnp.stack([x_new, y_new, z_new])  # world-to-cam rows

    # shared intrinsics: average the two (standard choice)
    K_new = 0.5 * (K_l + K_r)
    # homography mapping NEW pixels to OLD pixels: inverse of old->new
    # old->new: K_new R_new R_oldᵀ K_old⁻¹ ; we return its inverse per view
    def new_to_old(K_old, R_old):
        H_on = jnp.linalg.multi_dot(
            [K_new, R_new, R_old.T, jnp.linalg.inv(K_old)], precision=_HI)
        return jnp.linalg.inv(H_on)

    return RectifiedPair(
        H_left=new_to_old(K_l, R_l),
        H_right=new_to_old(K_r, R_r),
        K_new=K_new,
        baseline=baseline,
        R_new=R_new,
    )


def rectify_images(
    left_img: jnp.ndarray,
    right_img: jnp.ndarray,
    rect: RectifiedPair,
    out_shape: Tuple[int, int] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Warp both images into the rectified frame.

    Returns (left_rect, left_valid, right_rect, right_valid)."""
    lw, lv = homography_warp(left_img, rect.H_left, out_shape)
    rw, rv = homography_warp(right_img, rect.H_right, out_shape)
    return lw, lv, rw, rv


def rectified_disparity_to_depth(
    disparity: jnp.ndarray, rect: RectifiedPair, invalid_fill: float = 0.0
) -> jnp.ndarray:
    """depth (along the rectified z axis) = f_x_new * B / d."""
    fx = rect.K_new[0, 0]
    safe = jnp.where(disparity > 1e-6, disparity, 1.0)
    depth = fx * rect.baseline / safe
    return jnp.where(disparity > 1e-6, depth, invalid_fill)
