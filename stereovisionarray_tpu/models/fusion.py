"""Multi-view depth-map fusion: geometric-consistency filtering of per-view
depth maps into one deduplicated, confidence-weighted point cloud.

The reference stops at per-pair depth maps plus the embryonic converters
``DepthMapToPoints3D`` / ``Points3DToDepthMap``
(``/root/reference/src/functions.cpp:118-146``) — fusing the 25 array views
into a single consistent reconstruction is left to the user (its multi-pair
loop just overwrites disparity per pair, last pair wins —
``/root/reference/src/CameraStereoVision.cpp:89``, reference bug §2.3.4).
This module is the production step every array pipeline needs on top:
COLMAP/Galliani-style geometric consistency — a depth estimate survives only
if enough *other* views, reprojected through their own depth maps, agree on
the same 3D surface point — followed by cross-view deduplication and
consistency-weighted depth averaging.

Program shape: everything is one jitted program with static shapes. The pairwise
view check runs as a ``lax.scan`` over source views j; each step checks ALL
reference views i against j at once (batched project + one bilinear sample),
so the O(N^2) pair structure costs N scan steps of fat (N, H*W) elementwise work
instead of N^2 Python dispatches. The per-pixel bilinear gathers are the
irreducible data-dependent part (as in ``ops/warp.py``); fusion runs once per
frame-set, outside the per-frame hot path.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from stereovisionarray_tpu.geometry.camera import CameraArray
from stereovisionarray_tpu.ops.warp import bilinear_sample


class FusionResult(NamedTuple):
    """Per-source-pixel fusion outputs, static (N, H, W) shapes.

    A flattened cloud view lives in :func:`fused_point_cloud`."""

    points: jnp.ndarray  # (N, H, W, 3) world points at the FUSED depth
    valid: jnp.ndarray  # (N, H, W) kept after consistency + dedup
    depth: jnp.ndarray  # (N, H, W) consistency-averaged depth
    support: jnp.ndarray  # (N, H, W) int32: #views agreeing (incl. self)
    confidence: jnp.ndarray  # (N, H, W) support / N in [0, 1]


def _pixel_grid(h: int, w: int, dtype=jnp.float32) -> jnp.ndarray:
    v, u = jnp.meshgrid(
        jnp.arange(h, dtype=dtype), jnp.arange(w, dtype=dtype), indexing="ij"
    )
    return jnp.stack([u, v], axis=-1).reshape(-1, 2)  # (P, 2) uv order


@functools.partial(
    jax.jit, static_argnames=("min_support", "dedup", "average")
)
def fuse_depth_maps(
    cameras: CameraArray,
    depths: jnp.ndarray,
    valid: Optional[jnp.ndarray] = None,
    *,
    rel_thresh: float = 0.01,
    min_support: int = 3,
    min_depth: float = 1e-6,
    dedup: bool = True,
    average: bool = True,
) -> FusionResult:
    """Fuse N per-view depth maps into consistency-filtered world points.

    Args:
      cameras: ``CameraArray`` of the N views.
      depths: (N, H, W) metric z-depth per view (invalid pixels <= min_depth
        or masked via ``valid``).
      valid: optional (N, H, W) bool.
      rel_thresh: relative depth-agreement tolerance: view j supports view
        i's pixel when ``|d_j(proj) - z_ij| <= rel_thresh * z_ij``.
      min_support: minimum number of agreeing views INCLUDING the source
        view itself (2 = at least one other view agrees).
      dedup: keep a surface point only in the lowest-indexed view that sees
        it consistently (first-view-wins; the agreeing earlier view emits
        the point instead, so each surface patch appears once).
      average: replace each kept depth by the mean of all agreeing views'
        estimates (reprojected into the source camera) — the standard
        fusion noise reduction; disable for raw filtered depths.

    Returns:
      :class:`FusionResult` with static shapes; ``points`` are garbage where
      ``~valid`` (flatten with :func:`fused_point_cloud`).
    """
    n, h, w = depths.shape
    p = h * w
    f32 = jnp.float32
    depths = depths.astype(f32)
    base_valid = depths > min_depth
    if valid is not None:
        base_valid = base_valid & valid
    dflat = jnp.where(base_valid, depths, 0.0).reshape(n, p)
    vflat = base_valid.reshape(n, p)

    uv = _pixel_grid(h, w)  # (P, 2)
    # backproject every view's pixels once: (N, P, 3) world points
    pts = cameras.backproject(jnp.broadcast_to(uv, (n, p, 2)), dflat)

    depth_maps = dflat.reshape(n, h, w)
    iidx = jnp.arange(n, dtype=jnp.int32)[:, None]  # (N, 1) source view ids

    def sweep(validf):
        """One pass over source views j: per (view i, pixel) — count of
        OTHER agreeing views, sum of their reprojected depth estimates, and
        the smallest agreeing view index. ``validf`` (N, H, W) float gates
        which of view j's pixels may vouch (bilinear > 0.99)."""

        def one_view(carry, j):
            support, depth_sum, first_j = carry
            cam_j = cameras[j]
            # project ALL views' points into view j: (N, P)
            uv_ij, z_ij = cam_j.project(pts)
            dj, inb = bilinear_sample(depth_maps[j], uv_ij, fill=0.0)
            vj, _ = bilinear_sample(validf[j], uv_ij, fill=0.0)
            agree = (
                inb
                & (z_ij > min_depth)
                & (dj > min_depth)
                & (vj > 0.99)
                & (jnp.abs(dj - z_ij) <= rel_thresh * z_ij)
            )
            other = agree & (iidx != j)  # self-agreement counted separately
            # view j's depth estimate for view i's pixel, in camera i:
            # backproject (uv_ij, dj) through camera j, read its z in cam i.
            pj = cam_j.backproject(uv_ij, dj)
            z_back = cameras.world_to_cam(pj)[..., 2]
            support = support + other.astype(jnp.int32)
            depth_sum = depth_sum + jnp.where(other, z_back, 0.0)
            first_j = jnp.minimum(first_j, jnp.where(other, j, n))
            return (support, depth_sum, first_j), None

        init = (
            jnp.zeros((n, p), jnp.int32),
            jnp.zeros((n, p), f32),
            jnp.full((n, p), n, jnp.int32),
        )
        (support, depth_sum, first_j), _ = lax.scan(
            one_view, init, jnp.arange(n, dtype=jnp.int32)
        )
        return support, depth_sum, first_j

    support, depth_sum, _ = sweep(vflat.astype(f32).reshape(n, h, w))
    support_total = support + 1  # include self
    keep = vflat & (support_total >= min_support)
    if dedup:
        # first-QUALIFIED-view-wins: ownership is decided among views that
        # themselves pass the support test, so the owner provably keeps its
        # point. (Deciding against ALL valid views instead can orphan a
        # surface patch entirely: an earlier view may vouch for everyone at
        # the reprojected locations yet fail min_support at its own pixel —
        # asymmetric agreement near borders/occlusions — dropping the point
        # from every view at once.)
        qualified = keep.astype(f32).reshape(n, h, w)
        _, _, first_j = sweep(qualified)
        keep = keep & (first_j >= iidx)
    if average:
        fused = (dflat + depth_sum) / support_total.astype(f32)
    else:
        fused = dflat
    fused = jnp.where(keep, fused, 0.0)
    pts_out = cameras.backproject(jnp.broadcast_to(uv, (n, p, 2)), fused)
    conf = support_total.astype(f32) / jnp.float32(n)
    return FusionResult(
        points=pts_out.reshape(n, h, w, 3),
        valid=keep.reshape(n, h, w),
        depth=fused.reshape(n, h, w),
        support=support_total.reshape(n, h, w),
        confidence=jnp.where(keep, conf, 0.0).reshape(n, h, w),
    )


def fused_point_cloud(
    result: FusionResult,
    colors: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, Optional[jnp.ndarray]]:
    """Flatten a :class:`FusionResult` to (points (M, 3), confidence (M,),
    colors (M,) or None) keeping only valid entries (host-side boolean
    compaction — call outside jit)."""
    mask = jax.device_get(result.valid).reshape(-1)
    pts = jax.device_get(result.points).reshape(-1, 3)[mask]
    conf = jax.device_get(result.confidence).reshape(-1)[mask]
    if colors is not None:
        col = jax.device_get(colors).reshape(-1)[mask]
        return pts, conf, col
    return pts, conf, None


def reconstruct_array(
    images: jnp.ndarray,
    cameras: CameraArray,
    cfg=None,
    view_indices: Optional[Tuple[int, ...]] = None,
    *,
    use_roi: bool = False,
    rel_thresh: float = 0.01,
    min_support: int = 3,
    dedup: bool = True,
    min_confidence: float = 0.0,
) -> Tuple[FusionResult, jnp.ndarray]:
    """Full-array reconstruction: per-view depth maps -> fused point cloud.

    Runs :func:`~stereovisionarray_tpu.models.array_pipeline.array_depth_pipeline`
    once per entry of ``view_indices`` (each view as the reference of its own
    plane sweep — a host loop, since each reference has its own pair
    topology and therefore its own compiled program), then fuses the
    resulting depth maps with :func:`fuse_depth_maps`.

    This is the capability the reference's multi-pair loop gestures at but
    never delivers (per-pair disparities overwrite each other,
    ``/root/reference/src/CameraStereoVision.cpp:89``): one geometric model
    of the scene agreed on by the whole array.

    Returns (FusionResult over the selected views, depths (V, H, W))."""
    from stereovisionarray_tpu.config import EngineConfig
    from stereovisionarray_tpu.models.array_pipeline import array_depth_pipeline

    if cfg is None:
        cfg = EngineConfig()
    n = images.shape[0]
    if view_indices is None:
        view_indices = tuple(range(n))
    depths = []
    valids = []
    for ref in view_indices:
        out = array_depth_pipeline(
            images, cameras, cfg, ref_index=int(ref), use_roi=use_roi
        )
        valid = out.valid
        if min_confidence > 0.0 and out.sweep.confidence is not None:
            # matching-ambiguity gate (PKRN, ops/confidence.py) on top of
            # the geometric-consistency filter below: drop pixels whose
            # plane-sweep winner was not decisively better than its
            # second-best before they can vote at all
            valid = valid & (out.sweep.confidence >= min_confidence)
        depths.append(out.refined_depth)
        valids.append(valid)
    depths = jnp.stack(depths)
    valids = jnp.stack(valids)
    sub = cameras[jnp.asarray(list(view_indices))]
    result = fuse_depth_maps(
        sub,
        depths,
        valid=valids,
        rel_thresh=rel_thresh,
        min_support=min_support,
        dedup=dedup,
    )
    return result, depths


@jax.jit
def depth_normals(
    cameras: CameraArray,
    depth: jnp.ndarray,
    valid: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-pixel world-space surface normals from a single view's depth map.

    Central-difference tangents of the backprojected point map, normal =
    normalize(dp/du x dp/dv), oriented toward the camera. Returns
    (normals (H, W, 3), valid (H, W)); pixels whose 4-neighbourhood spans an
    invalid pixel are invalid."""
    h, w = depth.shape
    uv = _pixel_grid(h, w, depth.dtype)
    pts = cameras.backproject(uv, depth.reshape(-1)).reshape(h, w, 3)
    ok = depth > 1e-6
    if valid is not None:
        ok = ok & valid

    du = jnp.roll(pts, -1, axis=1) - jnp.roll(pts, 1, axis=1)
    dv = jnp.roll(pts, -1, axis=0) - jnp.roll(pts, 1, axis=0)
    nrm = jnp.cross(du, dv)
    mag = jnp.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = nrm / jnp.where(mag < 1e-12, 1.0, mag)
    # orient toward camera center
    center = cameras.centers
    to_cam = center - pts
    flip = jnp.sum(nrm * to_cam, axis=-1, keepdims=True) < 0
    nrm = jnp.where(flip, -nrm, nrm)
    ok4 = (
        ok
        & jnp.roll(ok, -1, axis=1) & jnp.roll(ok, 1, axis=1)
        & jnp.roll(ok, -1, axis=0) & jnp.roll(ok, 1, axis=0)
    )
    # border rolls wrap — kill the 1-pixel frame
    ok4 = ok4.at[0, :].set(False).at[-1, :].set(False)
    ok4 = ok4.at[:, 0].set(False).at[:, -1].set(False)
    return jnp.where(ok4[..., None], nrm, 0.0), ok4
