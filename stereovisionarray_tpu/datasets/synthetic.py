"""Procedural synthetic camera-array dataset — the role of the reference's
git-ignored ``Renders2/`` render set (``/root/reference/.gitignore:8-11``,
loaded at ``/root/reference/src/CameraStereoVision.cpp:13-19``), but generated
on the fly with exact ground-truth depth, so golden tests never depend on
binary fixtures.

The scene model is analytic (fronto-parallel background plane + raised
rectangular patches + a sphere), so every camera's image AND its true depth
map come from closed-form ray intersections — correct occlusion, no mesh, no
rasterizer, fully vectorized over pixels (renders happily under jit or on
host numpy at trace time).

Texture is multi-octave value noise over world (x, y) so matching windows
carry structure at several scales.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

from stereovisionarray_tpu.geometry.camera import CameraArray, translation_only_array
from stereovisionarray_tpu.geometry.topology import grid_positions


@dataclass(frozen=True)
class SceneSpec:
    """Analytic scene: background plane at z = background_z, plus raised
    rectangular patches (world x/y extents, each at its own depth) and an
    optional sphere. All depths are in world units in front of the array
    (the reference rig looks down +z from z = -0.75)."""

    background_z: float = 0.25
    # each patch: (x0, x1, y0, y1, z)
    patches: Tuple[Tuple[float, float, float, float, float], ...] = (
        (-0.06, 0.02, -0.05, 0.04, 0.10),
        (0.03, 0.09, -0.02, 0.06, 0.16),
    )
    sphere_center: Tuple[float, float, float] = (0.0, 0.0, 0.18)
    sphere_radius: float = 0.045
    texture_octaves: int = 5
    texture_seed: int = 7
    # slanted planar patches: (x0, x1, y0, y1, z0, dzdx, dzdy) — the
    # surface z = z0 + dzdx*(x-x0) + dzdy*(y-y0) clipped to the rect
    # (fronto-parallel sweep bias fixtures, EVAL_SCENES_r05)
    slants: Tuple[Tuple[float, float, float, float, float, float, float], ...] = ()
    # textureless rectangles: (x0, x1, y0, y1, contrast) — texture
    # contrast scaled toward mid-gray inside (0 = perfectly flat wall)
    textureless: Tuple[Tuple[float, float, float, float, float], ...] = ()


def _value_noise(x: np.ndarray, y: np.ndarray, octaves: int, seed: int) -> np.ndarray:
    """Multi-octave value noise sampled at world coords (vectorized, smooth).
    Deterministic in (coords, seed); range approx [0, 255]."""
    rng = np.random.default_rng(seed)
    out = np.zeros_like(x, dtype=np.float64)
    amp = 1.0
    total = 0.0
    freq = 24.0
    for _ in range(octaves):
        # hash lattice corners to pseudo-random values via sin-free integer mix
        xi = np.floor(x * freq).astype(np.int64)
        yi = np.floor(y * freq).astype(np.int64)
        fx = x * freq - xi
        fy = y * freq - yi
        fx = fx * fx * (3 - 2 * fx)  # smoothstep
        fy = fy * fy * (3 - 2 * fy)
        salt = int(rng.integers(1, 2**31 - 1))

        def corner(ix, iy):
            h = (ix * 374761393 + iy * 668265263) ^ salt
            h = (h ^ (h >> 13)) * 1274126177
            h = h ^ (h >> 16)
            return (h & 0xFFFF).astype(np.float64) / 65535.0

        v00 = corner(xi, yi)
        v10 = corner(xi + 1, yi)
        v01 = corner(xi, yi + 1)
        v11 = corner(xi + 1, yi + 1)
        v = (v00 * (1 - fx) + v10 * fx) * (1 - fy) + (v01 * (1 - fx) + v11 * fx) * fy
        out += amp * v
        total += amp
        amp *= 0.55
        freq *= 2.1
    return (out / total * 255.0).astype(np.float32)


def reference_rig(
    rows: int = 5,
    cols: int = 5,
    spacing: float = 0.05,
    origin: Tuple[float, float] = (-0.1, -0.1),
    z: float = -0.75,
    focal_length: float = 0.05,
    sensor_width: float = 0.036,
    resolution: Tuple[int, int] = (270, 360),
) -> CameraArray:
    """The reference's 5x5 rig (``/root/reference/src/CameraStereoVision.cpp:24-39``)
    as a CameraArray; resolution defaults to the reference's 0.5x downscale."""
    pos = grid_positions(rows, cols, spacing, origin=origin, z=z)
    return translation_only_array(
        focal_length, pos, sensor_width / resolution[1], resolution=resolution
    )


def _ray_scene_depth(
    origin: np.ndarray, dirs: np.ndarray, scene: SceneSpec
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Closed-form nearest intersection of rays with the scene.

    origin: (3,) camera center; dirs: (H, W, 3) unit rays (world frame).
    Returns (depth_z (H,W), hit_x (H,W), hit_y (H,W)) where depth_z is the
    z-distance from the camera plane (the depth-map convention)."""
    big = np.float32(1e9)
    dz = dirs[..., 2]
    dz = np.where(np.abs(dz) < 1e-9, 1e-9, dz)

    def plane_t(z_plane):
        return (z_plane - origin[2]) / dz

    # background plane
    t_best = plane_t(scene.background_z)
    # raised patches: nearer planes only count inside their rect
    for (x0, x1, y0, y1, zp) in scene.patches:
        t = plane_t(zp)
        hx = origin[0] + t * dirs[..., 0]
        hy = origin[1] + t * dirs[..., 1]
        inside = (hx >= x0) & (hx < x1) & (hy >= y0) & (hy < y1) & (t > 0)
        t_best = np.where(inside & (t < t_best), t, t_best)
    # slanted planar patches: solve O_z + t d_z = z0 + a(px-x0) + b(py-y0)
    for (x0, x1, y0, y1, z0, az, bz) in scene.slants:
        denom = dz - az * dirs[..., 0] - bz * dirs[..., 1]
        denom = np.where(np.abs(denom) < 1e-9, 1e-9, denom)
        t = (z0 - origin[2] + az * (origin[0] - x0) + bz * (origin[1] - y0)) / denom
        hx = origin[0] + t * dirs[..., 0]
        hy = origin[1] + t * dirs[..., 1]
        inside = (hx >= x0) & (hx < x1) & (hy >= y0) & (hy < y1) & (t > 0)
        t_best = np.where(inside & (t < t_best), t, t_best)
    # sphere
    c = np.asarray(scene.sphere_center, dtype=np.float64)
    r = scene.sphere_radius
    if r > 0:
        oc = origin - c
        b = np.einsum("hwc,c->hw", dirs, oc)
        disc = b * b - (np.dot(oc, oc) - r * r)
        hit = disc > 0
        t = -b - np.sqrt(np.maximum(disc, 0.0))
        t_best = np.where(hit & (t > 0) & (t < t_best), t, t_best)

    t_best = np.where(t_best > 0, t_best, big)
    hx = origin[0] + t_best * dirs[..., 0]
    hy = origin[1] + t_best * dirs[..., 1]
    depth_z = t_best * dz  # z-component distance
    return depth_z.astype(np.float32), hx, hy


def render_view(
    cameras: CameraArray, index: int, resolution: Tuple[int, int], scene: SceneSpec
) -> Tuple[np.ndarray, np.ndarray]:
    """Render one camera: returns (image (H,W) float32 [0,255], depth (H,W)).

    Host-side numpy: dataset generation is I/O-side, not the device hot path."""
    h, w = resolution
    cam = cameras[index]
    fx = float(cam.fx)
    fy = float(cam.fy)
    cx = float(cam.cx)
    cy = float(cam.cy)
    R = np.asarray(cam.R, dtype=np.float64)
    C = np.asarray(cam.centers, dtype=np.float64)
    v, u = np.mgrid[0:h, 0:w].astype(np.float64)
    d_cam = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u)], axis=-1)
    d_cam /= np.linalg.norm(d_cam, axis=-1, keepdims=True)
    dirs = d_cam @ R  # R^T @ d, batched: (H,W,3) world-frame rays
    depth, hx, hy = _ray_scene_depth(C, dirs, scene)
    # depth convention is z in the CAMERA frame: t * (R_row2 . dir). The
    # helper returned t * dir_world_z which is only right for R = I.
    t = depth / np.where(np.abs(dirs[..., 2]) < 1e-9, 1e-9, dirs[..., 2])
    depth = (t * (dirs @ R[2])).astype(np.float32)
    img = _value_noise(hx, hy, scene.texture_octaves, scene.texture_seed)
    for (x0, x1, y0, y1, contrast) in scene.textureless:
        inside = (hx >= x0) & (hx < x1) & (hy >= y0) & (hy < y1)
        img = np.where(inside, 128.0 + contrast * (img - 128.0), img)
    # slight depth-dependent shading so surfaces are distinguishable
    shade = 1.0 - 0.15 * np.clip((depth - depth.min()) / max(1e-6, np.ptp(depth)), 0, 1)
    return (img * shade).astype(np.float32), depth


def render_camera_array(
    cameras: CameraArray,
    resolution: Tuple[int, int],
    scene: SceneSpec | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Render every camera in the rig.

    Returns (images (N, H, W) float32, depths (N, H, W) float32) — the
    synthetic stand-in for the reference's 25-image ``Renders2`` ingest plus
    the ``idealRef.yml`` ground truth (``/root/reference/src/functions.cpp:323``),
    except the GT here is exact for *every* view."""
    scene = scene or SceneSpec()
    n = len(cameras)
    imgs, deps = [], []
    for i in range(n):
        img, dep = render_view(cameras, i, resolution, scene)
        imgs.append(img)
        deps.append(dep)
    return np.stack(imgs), np.stack(deps)
