"""Batched pinhole camera model — the batched generalization of the
reference's scalar translation-only ``Camera`` class.

The reference camera (``/root/reference/include/Camera.h:6-21``,
``/root/reference/src/Camera.cpp:15-33``) supports only fronto-parallel,
zero-rotation cameras: ``pixel = (P.xy - C.xy) * f / ((P.z - C.z) * pixel_size)``
and ``inv_project(pixel) = normalize(u*s, v*s, f)``. Here that becomes the
special case ``R = I`` of a full intrinsics+extrinsics pinhole model, stored as
struct-of-arrays so every operation is batched over the camera axis in plain
``jax.numpy`` (no per-camera Python objects, no scalar loops).

Conventions
-----------
 - World-to-camera: ``x_cam = R @ X_world + t``; camera center ``C = -R^T t``.
 - Pixel coords: ``u = fx * x/z + cx``, ``v = fy * y/z + cy`` (u = column,
   v = row). The reference has no principal point (coords relative to the
   image center, offset by ``halfRes`` at call sites, e.g.
   ``/root/reference/src/functions.cpp:125,141``); ``translation_only_array``
   bakes that offset into ``(cx, cy)``.
 - All arrays are float32 unless stated otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

# Geometry matmuls are tiny (3x3) but precision-critical: pin them to full
# f32 so a reduced-precision matmul default (TF32 on a GPU) cannot degrade
# pose/pixel accuracy.
_HI = jax.lax.Precision.HIGHEST


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CameraArray:
    """A batch of N pinhole cameras as a JAX pytree (struct of arrays).

    Fields:
      fx, fy: (N,) focal lengths in pixels.
      cx, cy: (N,) principal point in pixels.
      R:      (N, 3, 3) world-to-camera rotation.
      t:      (N, 3) world-to-camera translation (x_cam = R @ X + t).
    """

    fx: jnp.ndarray
    fy: jnp.ndarray
    cx: jnp.ndarray
    cy: jnp.ndarray
    R: jnp.ndarray
    t: jnp.ndarray

    # ------------------------------------------------------------------ #
    # Structure helpers
    # ------------------------------------------------------------------ #
    def __len__(self) -> int:
        return self.fx.shape[0]

    def __getitem__(self, idx) -> "CameraArray":
        """Slice / gather the camera batch (idx may be an int, slice, or
        integer array). An int index keeps a leading batch dim of 1 removed —
        fields become unbatched scalars/matrices."""
        return jax.tree_util.tree_map(lambda x: x[idx], self)

    @property
    def centers(self) -> jnp.ndarray:
        """(N, 3) camera centers in world coordinates, C = -R^T t."""
        return -jnp.einsum("...ji,...j->...i", self.R, self.t, precision=_HI)

    @property
    def K(self) -> jnp.ndarray:
        """(N, 3, 3) intrinsics matrices."""
        z = jnp.zeros_like(self.fx)
        o = jnp.ones_like(self.fx)
        rows = jnp.stack(
            [
                jnp.stack([self.fx, z, self.cx], axis=-1),
                jnp.stack([z, self.fy, self.cy], axis=-1),
                jnp.stack([z, z, o], axis=-1),
            ],
            axis=-2,
        )
        return rows

    # ------------------------------------------------------------------ #
    # Core projective ops (batched; broadcast over arbitrary point shapes)
    # ------------------------------------------------------------------ #
    def world_to_cam(self, points: jnp.ndarray) -> jnp.ndarray:
        """points: (..., 3) world -> (..., 3) camera frame.

        Camera batch dims broadcast against leading point dims, i.e. for a
        batch of N cameras pass points shaped (N, ..., 3) or (..., 3) with a
        single camera (unbatched fields)."""
        R = self.R if self.R.ndim == 2 else self.R[..., None, :, :]
        t = self.t if self.t.ndim == 1 else self.t[..., None, :]
        if self.R.ndim == 2:
            return jnp.einsum("ij,...j->...i", R, points, precision=_HI) + t
        # (N, 1, 3, 3) @ (N, P, 3)
        return jnp.einsum("...ij,...j->...i", R, points, precision=_HI) + t

    def cam_to_world(self, points_cam: jnp.ndarray) -> jnp.ndarray:
        """Inverse of :meth:`world_to_cam`."""
        if self.R.ndim == 2:
            return jnp.einsum("ji,...j->...i", self.R, points_cam - self.t, precision=_HI)
        t = self.t[..., None, :]
        return jnp.einsum("...ji,...j->...i", self.R[..., None, :, :], points_cam - t, precision=_HI)

    def project(self, points: jnp.ndarray, eps: float = 1e-9) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Project world points to pixels.

        Returns ``(uv, depth)`` with uv: (..., 2) pixel coords and depth:
        (...,) positive in front of the camera. The reference equivalent is
        ``Camera::project`` (``/root/reference/src/Camera.cpp:15-22``) which
        truncates to int and has no principal point; we keep float subpixel
        coords (truncation is a visualization concern, not a geometry one).
        """
        pc = self.world_to_cam(points)
        z = pc[..., 2]
        inv_z = 1.0 / jnp.where(jnp.abs(z) < eps, jnp.where(z < 0, -eps, eps), z)
        fx, fy, cx, cy = self._bcast_intrinsics(z)
        u = fx * pc[..., 0] * inv_z + cx
        v = fy * pc[..., 1] * inv_z + cy
        return jnp.stack([u, v], axis=-1), z

    def backproject(self, uv: jnp.ndarray, depth: jnp.ndarray) -> jnp.ndarray:
        """Pixel coords (..., 2) + depth (...,) -> world points (..., 3).

        ``depth`` is the z coordinate in the camera frame (not ray length),
        matching the reference's depth-map convention
        (``/root/reference/src/functions.cpp:134-146``)."""
        fx, fy, cx, cy = self._bcast_intrinsics(uv[..., 0])
        x = (uv[..., 0] - cx) / fx * depth
        y = (uv[..., 1] - cy) / fy * depth
        pc = jnp.stack([x, y, depth], axis=-1)
        return self.cam_to_world(pc)

    def pixel_rays(self, uv: jnp.ndarray) -> jnp.ndarray:
        """Unit ray directions in world coordinates for pixels (..., 2).

        The reference analogue is ``Camera::inv_project``
        (``/root/reference/src/Camera.cpp:25-33``): ``normalize(u*s, v*s, f)``
        — identical for R = I up to the principal-point shift."""
        fx, fy, cx, cy = self._bcast_intrinsics(uv[..., 0])
        d = jnp.stack(
            [(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy, jnp.ones_like(uv[..., 0])],
            axis=-1,
        )
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        if self.R.ndim == 2:
            return jnp.einsum("ji,...j->...i", self.R, d, precision=_HI)
        return jnp.einsum("...ji,...j->...i", self.R[..., None, :, :], d, precision=_HI)

    # one-point-per-camera convenience (observation lists in sfm/): the
    # batched ops above broadcast cameras against a trailing *point* axis,
    # so a 1:1 pairing needs a singleton point dim inserted and squeezed.
    def project_each(self, points: jnp.ndarray, eps: float = 1e-9):
        """points (N, 3), one per camera in this (N,)-batched array ->
        (uv (N, 2), depth (N,))."""
        uv, z = self.project(points[..., None, :], eps=eps)
        return uv[..., 0, :], z[..., 0]

    def rays_each(self, uv: jnp.ndarray) -> jnp.ndarray:
        """uv (N, 2), one per camera -> unit world rays (N, 3)."""
        return self.pixel_rays(uv[..., None, :])[..., 0, :]

    def world_to_cam_each(self, points: jnp.ndarray) -> jnp.ndarray:
        """points (N, 3), one per camera -> camera-frame points (N, 3)."""
        return self.world_to_cam(points[..., None, :])[..., 0, :]

    def _bcast_intrinsics(self, like: jnp.ndarray):
        """Reshape (N,) intrinsics to broadcast against point dims of `like`
        (shape (N, ...) for batched cameras)."""
        if self.fx.ndim == 0:
            return self.fx, self.fy, self.cx, self.cy
        extra = like.ndim - self.fx.ndim
        shape = self.fx.shape + (1,) * extra
        return (
            self.fx.reshape(shape),
            self.fy.reshape(shape),
            self.cx.reshape(shape),
            self.cy.reshape(shape),
        )

    # ------------------------------------------------------------------ #
    # Pairwise / planar geometry (plane sweep, rectification)
    # ------------------------------------------------------------------ #
    def relative_pose(self, i, j) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Pose of camera j relative to camera i: x_j = R_rel @ x_i + t_rel."""
        Ri, ti = self.R[i], self.t[i]
        Rj, tj = self.R[j], self.t[j]
        R_rel = jnp.einsum("ik,jk->ij", Rj, Ri, precision=_HI)
        t_rel = tj - jnp.einsum("ij,j->i", R_rel, ti, precision=_HI)
        return R_rel, t_rel

    def fronto_plane_homography(self, ref: int, src, depth: jnp.ndarray) -> jnp.ndarray:
        """Homographies mapping reference pixels to source pixels for
        fronto-parallel planes z_ref = depth.

        H(d) = K_s (R_rel + t_rel n^T / d) K_r^{-1} with plane normal
        n = (0,0,1) in the reference camera frame (plane z = d).

        src: (S,) source camera indices; depth: (D,) plane depths.
        Returns (S, D, 3, 3). This is the idiomatic generalization of the
        reference's per-pixel perspective shifts
        (``/root/reference/src/functions.cpp:55-103``)."""
        src = jnp.atleast_1d(jnp.asarray(src))
        depth = jnp.atleast_1d(jnp.asarray(depth, dtype=self.fx.dtype))
        R_ref, t_ref = self.R[ref], self.t[ref]
        R_rel = jnp.einsum("sik,jk->sij", self.R[src], R_ref, precision=_HI)  # (S, 3, 3)
        t_rel = self.t[src] - jnp.einsum("sij,j->si", R_rel, t_ref, precision=_HI)  # (S, 3)
        K_ref_inv = jnp.linalg.inv(self.K[ref])
        K_src = self.K[src]  # (S, 3, 3)
        n = jnp.array([0.0, 0.0, 1.0], dtype=self.fx.dtype)
        tnT = jnp.einsum("si,j->sij", t_rel, n, precision=_HI)  # (S, 3, 3)
        mid = R_rel[:, None] + tnT[:, None] / depth[None, :, None, None]  # (S, D, 3, 3)
        return jnp.einsum("sij,sdjk,kl->sdil", K_src, mid, K_ref_inv, precision=_HI)


# ---------------------------------------------------------------------- #
# Constructors
# ---------------------------------------------------------------------- #
def make_camera_array(fx, fy, cx, cy, R, t) -> CameraArray:
    """Build a CameraArray from raw arrays, casting to float32."""
    f32 = lambda x: jnp.asarray(x, dtype=jnp.float32)
    return CameraArray(fx=f32(fx), fy=f32(fy), cx=f32(cx), cy=f32(cy), R=f32(R), t=f32(t))


def translation_only_array(
    focal_length: float,
    positions,
    pixel_size: float,
    resolution: Tuple[int, int] = (0, 0),
) -> CameraArray:
    """The reference's camera model: identical rotation-free cameras on a
    rigid translation grid (``/root/reference/src/CameraStereoVision.cpp:33-39``:
    5x5 grid, 0.05 m spacing, z = -0.75; f = 0.05 m, 36 mm sensor).

    positions: (N, 3) camera centers in world coords.
    resolution: (H, W); the principal point is placed at the image center,
    absorbing the reference's explicit ``halfRes`` offsets.
    """
    positions = jnp.asarray(positions, dtype=jnp.float32)
    n = positions.shape[0]
    f_pix = jnp.full((n,), focal_length / pixel_size, dtype=jnp.float32)
    h, w = resolution
    cx = jnp.full((n,), w / 2.0, dtype=jnp.float32)
    cy = jnp.full((n,), h / 2.0, dtype=jnp.float32)
    R = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (n, 3, 3))
    t = -positions  # R = I  =>  t = -C
    return CameraArray(fx=f_pix, fy=f_pix, cx=cx, cy=cy, R=R, t=t)


def look_at_rotation(eye, target, up=(0.0, 1.0, 0.0)) -> jnp.ndarray:
    """World-to-camera rotation for a camera at `eye` looking at `target`
    (camera +z towards target, +y roughly along `up`). Used by the synthetic
    dataset generator and pose-graph tests."""
    eye = jnp.asarray(eye, dtype=jnp.float32)
    target = jnp.asarray(target, dtype=jnp.float32)
    up = jnp.asarray(up, dtype=jnp.float32)
    fwd = target - eye
    fwd = fwd / jnp.linalg.norm(fwd)
    right = jnp.cross(up, fwd)
    right = right / jnp.linalg.norm(right)
    new_up = jnp.cross(fwd, right)
    # rows of R are the camera axes expressed in world coords
    return jnp.stack([right, new_up, fwd], axis=0)
