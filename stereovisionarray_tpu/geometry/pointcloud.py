"""Point-cloud ⇄ depth-map converters — the batched generalization of the
reference's embryonic reconstruction API (`DepthMapToPoints3D` /
`Points3DToDepthMap`, ``/root/reference/src/functions.cpp:118-146``).

Differences from the reference (deliberate, see SURVEY.md §2.3):

* fully vectorized (one fused XLA program instead of per-pixel loops);
* `points_to_depth_map` z-buffers via a min-scatter so the NEAREST point wins
  at each landed pixel — the reference forward-splats with no z-buffer, so an
  arbitrary (iteration-order-dependent) point wins
  (``/root/reference/src/functions.cpp:128``);
* invalid / masked pixels are explicit (`mask` in, `valid` out) rather than
  the reference's uninitialized-memory convention.

All functions are jittable with static shapes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax.numpy as jnp

from .camera import CameraArray

__all__ = [
    "depth_map_to_points",
    "points_to_depth_map",
    "point_cloud_colors",
]


def depth_map_to_points(
    camera: CameraArray,
    depth: jnp.ndarray,
    mask: Optional[jnp.ndarray] = None,
    min_depth: float = 1e-6,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Backproject a dense depth map to world-space 3D points.

    Vectorized analogue of `DepthMapToPoints3D`
    (``/root/reference/src/functions.cpp:134-146``): the reference loops
    pixels, emits `cam.pos + inv_project(pixel - halfRes) * depth` for every
    pixel with depth > 0.1; here the whole (H, W) grid backprojects in one
    `backproject` call and invalid pixels are flagged instead of dropped (so
    shapes stay static under jit).

    Args:
      camera: a single camera (``CameraArray`` of size 1 or scalar-indexed).
      depth: (H, W) metric depth along the camera z axis.
      mask: optional (H, W) boolean; pixels outside are invalid.
      min_depth: pixels with depth <= min_depth are invalid (the reference's
        `depth > 0.1` gate generalized).

    Returns:
      points: (H, W, 3) world-space points (garbage where ~valid).
      valid: (H, W) boolean.
    """
    h, w = depth.shape
    v, u = jnp.mgrid[0:h, 0:w]
    uv = jnp.stack([u, v], axis=-1).astype(depth.dtype)  # (H, W, 2) pixel centers
    pts = camera.backproject(uv.reshape(-1, 2), depth.reshape(-1))
    pts = pts.reshape(h, w, 3)
    valid = depth > min_depth
    if mask is not None:
        valid = valid & mask
    return pts, valid


def points_to_depth_map(
    camera: CameraArray,
    points: jnp.ndarray,
    resolution: Tuple[int, int],
    valid: Optional[jnp.ndarray] = None,
    fill: float = 0.0,
) -> jnp.ndarray:
    """Project a 3D point set into a camera and rasterize a depth map.

    Z-buffered analogue of `Points3DToDepthMap`
    (``/root/reference/src/functions.cpp:118-132``). The reference writes
    `z - cam.z` (translation-only camera depth) at each landed pixel with no
    z-buffer — last point in iteration order wins. Here the scatter is a
    `min`-reduction over camera-frame depth, so occlusions resolve to the
    nearest surface deterministically regardless of point order (important
    for bit-determinism across shardings, SURVEY.md §7 "hard parts").

    Args:
      camera: a single camera.
      points: (N, 3) world-space points.
      resolution: (H, W) of the output map.
      valid: optional (N,) boolean; invalid points are ignored.
      fill: value for pixels no point lands on.

    Returns:
      (H, W) depth map; `fill` in holes.
    """
    h, w = resolution
    uv, z = camera.project(points)
    in_front = z > 0
    ui = jnp.round(uv[..., 0]).astype(jnp.int32)
    vi = jnp.round(uv[..., 1]).astype(jnp.int32)
    ok = in_front & (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)
    if valid is not None:
        ok = ok & valid
    # Out-of-bounds / invalid points land on a sentinel pixel outside the crop.
    flat = jnp.where(ok, vi * w + ui, h * w)
    big = jnp.asarray(jnp.inf, dtype=z.dtype)
    zbuf = jnp.full((h * w + 1,), big, dtype=z.dtype)
    zbuf = zbuf.at[flat].min(jnp.where(ok, z, big))
    depth = zbuf[: h * w].reshape(h, w)
    return jnp.where(jnp.isfinite(depth), depth, jnp.asarray(fill, depth.dtype))


def point_cloud_colors(
    image: jnp.ndarray, valid: jnp.ndarray
) -> jnp.ndarray:
    """Per-point colors for a depth-map-derived cloud: broadcast a (H, W) gray
    or (H, W, 3) RGB image to (H*W, 3) uint8 (zeros where ~valid)."""
    img = image
    if img.ndim == 2:
        img = jnp.stack([img] * 3, axis=-1)
    img = jnp.where(valid[..., None], img, 0)
    img = jnp.clip(img, 0, 255).astype(jnp.uint8)
    return img.reshape(-1, 3)
