"""End-to-end camera-array depth pipeline — the reference's `main()` as one program.

Capability parity with the reference driver
(``/root/reference/src/CameraStereoVision.cpp:10-123``):

  ingest → face-ROI mask → disparity/depth over the array → multi-view
  photoconsistency refinement → golden-reference evaluation,

re-architected for the hardware: the per-pixel epipolar Bresenham/SAD loop
becomes an N-view plane-sweep cost volume + SGM (one compiled XLA program),
the sequential per-pair `improveWithDisparity` overwrite becomes a fused
all-views-vote refinement (:func:`stereovisionarray_tpu.ops.refine.multiview_refine`),
and evaluation is the masked-mean / bad-τ metric suite instead of ×50 error
windows.

Host code here only selects static indices and orchestrates; every numeric
stage is jitted.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import jax.numpy as jnp

from stereovisionarray_tpu.config import EngineConfig
from stereovisionarray_tpu.geometry.camera import CameraArray
from stereovisionarray_tpu.geometry.topology import PairTopology, camera_pairs
from stereovisionarray_tpu.models.plane_sweep import PlaneSweepOutput, plane_sweep_depth
from stereovisionarray_tpu.models.two_view import depth_to_disparity, disparity_to_depth
from stereovisionarray_tpu.ops.refine import multiview_refine
from stereovisionarray_tpu.roi.detect import detect_face_ellipse
from stereovisionarray_tpu.roi.mask import ellipse_mask

__all__ = ["ArrayPipelineOutput", "array_baselines", "array_depth_pipeline"]


def _host_centers(cameras) -> np.ndarray:
    """(N, 3) camera centers as concrete numpy, from the RAW fields.

    NOT ``cameras.centers`` — that property is a jnp einsum, which under a
    jit trace returns a tracer even for closure-constant cameras and breaks
    the host-side static computations below; the fields stay concrete."""
    return -np.einsum("nji,nj->ni", np.asarray(cameras.R), np.asarray(cameras.t))


def _shift_warp_pad(cameras, ref_index, src_indices, cfg) -> int:
    """Static bound for the plane-sweep translation-warp fast path, or 0
    when the rig is not translation-only (general homographies needed).

    Computed HOST-SIDE from the concrete camera array (this function runs
    outside jit; ``plane_sweep_depth`` takes the result as a static arg):
    the warp shift at the nearest plane is f * |c_ref - c_src| / z_near."""
    R = np.asarray(cameras.R)
    eye = np.broadcast_to(np.eye(3, dtype=R.dtype), R.shape)
    if not np.allclose(R, eye, atol=1e-6):
        return 0
    centers = _host_centers(cameras)
    idx = [ref_index, *src_indices]
    if not np.allclose(centers[idx, 2], centers[ref_index, 2], atol=1e-9):
        return 0  # differing z -> homography has a scale term
    fx = np.broadcast_to(np.asarray(cameras.fx), (len(cameras),))
    fy = np.broadcast_to(np.asarray(cameras.fy), (len(cameras),))
    if not (np.allclose(fx[idx], fx[ref_index]) and np.allclose(fy[idx], fy[ref_index])):
        return 0
    rel = centers[list(src_indices), :2] - centers[ref_index, :2]
    max_base = float(np.abs(rel).max())
    f_max = float(max(fx[ref_index], fy[ref_index]))
    # differing principal points add a constant H[0:2,2] shift on top of
    # the depth-dependent baseline term — include it in the pad bound so
    # dynamic_slice never silently clamps (the warp stays a pure shift)
    cx = np.broadcast_to(np.asarray(cameras.cx), (len(cameras),))
    cy = np.broadcast_to(np.asarray(cameras.cy), (len(cameras),))
    dpp = float(
        max(
            np.abs(cx[idx] - cx[ref_index]).max(),
            np.abs(cy[idx] - cy[ref_index]).max(),
        )
    )
    return int(np.ceil(f_max * max_base / cfg.plane_sweep.z_near + dpp)) + 2


class ArrayPipelineOutput(NamedTuple):
    depth: jnp.ndarray  # (H, W) fused depth before refinement
    refined_depth: jnp.ndarray  # (H, W) after multi-view refinement
    disparity: jnp.ndarray  # (H, W) normalized disparity (ref-baseline units)
    refined_disparity: jnp.ndarray
    valid: jnp.ndarray  # (H, W)
    mask: jnp.ndarray  # (H, W) ROI gate actually applied
    sweep: PlaneSweepOutput  # full plane-sweep diagnostics


def array_baselines(
    cameras: CameraArray, ref_index: int, src_indices: Tuple[int, ...]
) -> Tuple[np.ndarray, float]:
    """Per-view pixel-space epipolar directions for disparity warping.

    For the (translation-only) array, a point at depth z appears in source
    view j displaced from its reference pixel by
    ``(f_px / z) * (C_ref - C_j).xy`` — so warping source j back to the
    reference view samples along ``unit(C_ref - C_j)``. We normalize all
    views to ONE disparity scale (the mean baseline B0): view j's direction
    vector is scaled by ``B_j / B0`` so a single disparity map aligns every
    view (the reference instead assumes equal baselines and quantizes the
    direction to ±1 per axis, ``/root/reference/src/functions.cpp:23-25``).

    Returns (baselines_uv (V, 2) float32, B0 mean metric baseline).
    """
    centers = _host_centers(cameras)
    ref_c = centers[ref_index]
    rel = ref_c[None, :2] - centers[list(src_indices), :2]  # (V, 2)
    b_len = np.linalg.norm(rel, axis=-1)
    b0 = float(b_len.mean())
    unit = rel / np.maximum(b_len[:, None], 1e-12)
    scaled = unit * (b_len / max(b0, 1e-12))[:, None]
    return scaled.astype(np.float32), b0


def reference_and_sources(cfg: EngineConfig, n: int,
                          ref_index: Optional[int] = None
                          ) -> Tuple[int, Tuple[int, ...]]:
    """Resolve the reference view (grid center by default — the reference's
    camera 12, ``/root/reference/src/functions.cpp:150``) and its source
    views under cfg.plane_sweep.topology. The single source of truth for
    this selection — the CLI and serving layers must use it rather than
    re-deriving (a divergent copy silently mis-scales disparity/depth
    conversions downstream)."""
    if ref_index is None:
        ref_index = (cfg.camera.rows // 2) * cfg.camera.cols + cfg.camera.cols // 2
        if ref_index >= n:
            ref_index = n // 2
    topo = PairTopology(cfg.plane_sweep.topology)
    pairs = camera_pairs(topo, rows=cfg.camera.rows, cols=cfg.camera.cols,
                         center=ref_index)
    src = tuple(int(b) for a, b in pairs if a == ref_index) or tuple(
        int(b) for _, b in pairs
    )
    return int(ref_index), src


def array_depth_pipeline(
    images: jnp.ndarray,
    cameras: CameraArray,
    cfg: EngineConfig = EngineConfig(),
    ref_index: Optional[int] = None,
    use_roi: bool = False,
    mask: Optional[jnp.ndarray] = None,
    roi_mode: str = "face",
    backend: str = "auto",
) -> ArrayPipelineOutput:
    """Run the full array pipeline on (N, H, W) grayscale images.

    Args:
      images: all array views, reference-rig order (row-major grid).
      cameras: matching CameraArray.
      cfg: engine config (plane_sweep / sgm / refine sections used here).
      ref_index: reference view (default: grid center, the reference's
        camera 12, ``/root/reference/src/functions.cpp:150``).
      use_roi: gate compute to a detected subject on the reference view (the
        reference's dlib mask role,
        ``/root/reference/src/CameraStereoVision.cpp:53``).
      mask: explicit ROI override (wins over use_roi).
      roi_mode: "face" = NCC face detector with landmark convex-poly mask,
        Otsu-ellipse fallback (``roi.face.face_mask`` — the getFaceMask
        equivalent); "otsu" = foreground ellipse only.
      backend: SGM backend of the sweep (``backend.py``).
    """
    n, h, w = images.shape
    ref_index, src_indices = reference_and_sources(cfg, n, ref_index)

    if mask is None:
        if use_roi and roi_mode == "face":
            from stereovisionarray_tpu.roi.face import face_mask as _face_mask

            mask = _face_mask(images[ref_index])
        elif use_roi:
            roi = detect_face_ellipse(images[ref_index])
            # unfound -> ungated (all-True), matching roi.face.face_mask
            mask = ellipse_mask((h, w), roi.center, roi.axes, roi.angle) | ~roi.found
        else:
            mask = jnp.ones((h, w), dtype=bool)

    shift_pad = _shift_warp_pad(cameras, ref_index, src_indices, cfg)
    if (
        cfg.plane_sweep.cascade
        and cfg.plane_sweep.num_planes <= cfg.plane_sweep.cascade_fine_planes
    ):
        # the whole range fits one fine window: the cascade would only add
        # a coarse pass on top of the identical sweep — run flat
        cfg = cfg.override(**{"plane_sweep.cascade": False})
    if cfg.plane_sweep.cascade:
        from stereovisionarray_tpu.models.cascade_sweep import (
            cascade_plane_sweep_depth,
            cascade_static_params,
        )

        if shift_pad <= 0:
            raise ValueError(
                "plane_sweep.cascade requires a translation-only rig "
                "(general rigs have non-linear per-plane warps)"
            )
        ps = cfg.plane_sweep
        band_offsets, _ = cascade_static_params(
            cameras, ref_index, src_indices, ps, ps.cascade_fine_planes
        )
        sweep = cascade_plane_sweep_depth(
            images,
            cameras,
            ref_index,
            src_indices,
            ps,
            cfg.sgm,
            mask=mask,
            shift_pad=shift_pad,
            coarse_factor=ps.cascade_coarse_factor,
            fine_planes=ps.cascade_fine_planes,
            band_step=ps.cascade_band_step,
            band_offsets=band_offsets,
            mode=ps.cascade_mode,
            backend=backend,
        )
    else:
        sweep = plane_sweep_depth(
            images,
            cameras,
            ref_index,
            src_indices,
            cfg.plane_sweep,
            cfg.sgm,
            mask=mask,
            shift_pad=shift_pad,
            backend=backend,
        )

    # ---- multi-view photoconsistency refinement in disparity space ---- #
    baselines, b0 = array_baselines(cameras, ref_index, src_indices)
    f_px = float(np.broadcast_to(np.asarray(cameras.fx), (n,))[ref_index])
    disparity = depth_to_disparity(sweep.depth, b0, f_px)

    refined_disparity = disparity
    rcfg = cfg.refine
    # static disparity ceiling for the candidate-stack warp: the sweep's
    # nearest plane plus the worst-case accumulated refinement offsets —
    # each iteration can move up to (radius + 0.5) * step (the subpixel
    # parabola adds up to half a step beyond the integer window)
    d_ceiling = f_px * b0 / cfg.plane_sweep.z_near + (
        abs(rcfg.radius * rcfg.step) + 0.5 * abs(rcfg.step)
    ) * max(rcfg.iterations, 1)
    for _ in range(max(rcfg.iterations, 0)):
        out = multiview_refine(
            images[ref_index],
            images[jnp.asarray(src_indices)],
            baselines,  # host numpy -> enables the static candidate-stack path
            refined_disparity,
            mask=mask & sweep.valid,
            radius=rcfg.radius,
            step=rcfg.step,
            window=rcfg.window,
            subpixel=rcfg.subpixel,
            max_disparity=d_ceiling,
        )
        refined_disparity = out.disparity

    refined_depth = jnp.where(
        sweep.valid, disparity_to_depth(refined_disparity, b0, f_px), 0.0
    )
    return ArrayPipelineOutput(
        depth=sweep.depth,
        refined_depth=refined_depth,
        disparity=disparity,
        refined_disparity=refined_disparity,
        valid=sweep.valid,
        mask=mask,
        sweep=sweep,
    )
