"""Two-view rectified SGM disparity pipeline — BASELINE.json configs 1 + 2,
the minimum end-to-end slice (SURVEY.md §7 step 5).

Replaces the reference's driver loop (``/root/reference/src/CameraStereoVision.cpp:49-100``):
per-pixel patch SAD over Bresenham candidates + WTA + uint8 disparity +
depth = camDist * f / (d * pixelSize). Here the whole pipeline is one jitted
function: census/BT cost volume -> 8-path SGM -> WTA + subpixel + uniqueness
+ LR check -> float disparity -> guarded depth conversion (the reference
divides by zero at ``:100``; we emit an explicit invalid sentinel).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from stereovisionarray_tpu.config import CostConfig, SGMConfig
from stereovisionarray_tpu.backend import resolve_backend
from stereovisionarray_tpu.ops.cost_volume import (
    cost_scale_for,
    fused_cost_volume,
    int8_cost_fits,
    right_from_left_volume,
)
from stereovisionarray_tpu.ops.sgm import ALL_PATH_IDS, sgm_aggregate_paths
from stereovisionarray_tpu.ops.wta import disparity_from_volume


class TwoViewOutput(NamedTuple):
    disparity: jnp.ndarray  # (H, W) float32, INVALID_DISPARITY where rejected
    valid: jnp.ndarray  # (H, W) bool
    cost: jnp.ndarray  # (H, W) winning aggregated cost
    depth: Optional[jnp.ndarray] = None  # (H, W) when baseline+focal given
    confidence: Optional[jnp.ndarray] = None  # (H, W) PKRN in [0,1), 0 invalid


def disparity_to_depth(
    disparity: jnp.ndarray,
    baseline: float,
    focal_px: float,
    invalid_fill: float = 0.0,
) -> jnp.ndarray:
    """depth = B * f_px / d, guarded against d <= 0 (reference divides by
    zero, ``/root/reference/src/CameraStereoVision.cpp:98-100`` — its formula
    ``camDistance * f / (disp * pixelSize)`` is the same with f in meters,
    since f_px = f / pixel_size)."""
    safe = jnp.where(disparity > 1e-6, disparity, 1.0)
    depth = baseline * focal_px / safe
    return jnp.where(disparity > 1e-6, depth, invalid_fill)


def depth_to_disparity(
    depth: jnp.ndarray, baseline: float, focal_px: float, invalid_fill: float = 0.0
) -> jnp.ndarray:
    """Inverse of :func:`disparity_to_depth` (same guarded hyperbola)."""
    safe = jnp.where(depth > 1e-9, depth, 1.0)
    disp = baseline * focal_px / safe
    return jnp.where(depth > 1e-9, disp, invalid_fill)


def cost_dtype(cost_cfg: CostConfig):
    """The cost volume's dtype: ``cost_cfg.dtype``, except that int8 widens
    to int16 when the census window's worst cost would overflow it."""
    dtype = jnp.dtype(cost_cfg.dtype)
    if dtype == jnp.int8 and not int8_cost_fits(
        cost_cfg.census_window, cost_cfg.bt_weight, cost_cfg.bt_clip
    ):
        return jnp.dtype(jnp.int16)
    return dtype


def sgm_penalties(sgm_cfg: SGMConfig, dtype) -> dict:
    """P1, P2 and the adaptive-P2 floor in the cost volume's units: scaled
    by ``cost_scale_for(dtype)`` and rounded for integer (fixed-point)
    volumes, as given for float ones."""
    if not jnp.issubdtype(dtype, jnp.integer):
        return dict(p1=sgm_cfg.p1, p2=sgm_cfg.p2, p2_min=sgm_cfg.p2_min)
    scale = cost_scale_for(dtype)
    return dict(p1=round(sgm_cfg.p1 * scale), p2=round(sgm_cfg.p2 * scale),
                p2_min=round(sgm_cfg.p2_min * scale))


def aggregate_costs(
    vol: jnp.ndarray,
    image: jnp.ndarray,
    sgm_cfg: SGMConfig,
    path_ids: tuple,
    backend: str,
) -> jnp.ndarray:
    """SGM over ``path_ids`` of a cost volume built by ``fused_cost_volume``,
    with the penalties in the volume's units (:func:`sgm_penalties`).

    Returns the raw sum: the exact int32 sum for integer volumes, float32
    otherwise; :func:`cost_units` converts it. ``backend`` is resolved
    (``backend.resolve_backend``)."""
    return sgm_aggregate_paths(
        vol,
        path_ids=path_ids,
        image=image,
        adaptive_p2=sgm_cfg.adaptive_p2,
        backend=backend,
        **sgm_penalties(sgm_cfg, vol.dtype),
    )


def cost_units(agg: jnp.ndarray, vol_dtype) -> jnp.ndarray:
    """An aggregated volume as float32 in unscaled cost units. The scale is
    a power of two, so the conversion of the int32 sums is exact."""
    if jnp.issubdtype(vol_dtype, jnp.integer):
        return agg.astype(jnp.float32) * (1.0 / cost_scale_for(vol_dtype))
    return agg


@functools.partial(
    jax.jit,
    static_argnames=("cost_cfg", "sgm_cfg", "baseline", "focal_px", "backend"),
)
def two_view_disparity(
    left: jnp.ndarray,
    right: jnp.ndarray,
    cost_cfg: CostConfig = CostConfig(),
    sgm_cfg: SGMConfig = SGMConfig(),
    mask: Optional[jnp.ndarray] = None,
    baseline: Optional[float] = None,
    focal_px: Optional[float] = None,
    backend: str = "auto",
) -> TwoViewOutput:
    """Full rectified two-view pipeline on (H, W) grayscale images.

    All stages run on-device in one compiled program; configs are static
    (hashable frozen dataclasses) so each config compiles once.

    backend: "auto" | "xla" | "pallas" | "pallas_interpret" — how SGM
    aggregation runs (``backend.py``); every backend computes the same
    sums, so the outputs agree."""
    left = left.astype(jnp.float32)
    right = right.astype(jnp.float32)
    vol = fused_cost_volume(
        left,
        right,
        cost_cfg.num_disparities,
        census_window=cost_cfg.census_window,
        bt_weight=cost_cfg.bt_weight,
        bt_clip=cost_cfg.bt_clip,
        dtype=cost_dtype(cost_cfg),
    )
    agg = cost_units(
        aggregate_costs(vol, left, sgm_cfg, ALL_PATH_IDS[: sgm_cfg.num_paths],
                        resolve_backend(backend)),
        vol.dtype,
    )
    vol_right = right_from_left_volume(agg) if sgm_cfg.lr_max_diff > 0 else None
    res = disparity_from_volume(
        agg,
        vol_right=vol_right,
        subpixel=sgm_cfg.subpixel,
        uniqueness=sgm_cfg.uniqueness,
        lr_max_diff=sgm_cfg.lr_max_diff,
        mask=mask,
        with_confidence=True,
    )
    cost_map = res.cost

    disparity, valid = res.disparity, res.valid
    if sgm_cfg.median_filter or sgm_cfg.speckle_window > 0 or sgm_cfg.fill_holes:
        from stereovisionarray_tpu.ops.postfilter import (
            fill_holes,
            median3x3,
            speckle_filter,
        )

        if sgm_cfg.median_filter:
            disparity = median3x3(disparity, valid)
        if sgm_cfg.speckle_window > 0:
            disparity, valid = speckle_filter(
                disparity,
                valid,
                max_diff=sgm_cfg.speckle_max_diff,
                window=sgm_cfg.speckle_window,
                min_support=sgm_cfg.speckle_min_support,
            )
        if sgm_cfg.fill_holes:
            disparity, valid = fill_holes(disparity, valid)

    depth = None
    if baseline is not None and focal_px is not None:
        depth = jnp.where(
            valid,
            disparity_to_depth(disparity, baseline, focal_px),
            0.0,
        )
    conf = res.confidence
    if conf is not None:
        # post-filters can invalidate pixels after extraction
        conf = jnp.where(valid, conf, 0.0)
    return TwoViewOutput(
        disparity=disparity, valid=valid, cost=cost_map, depth=depth,
        confidence=conf,
    )
