"""Winner-take-all disparity extraction, subpixel parabola refinement,
uniqueness ratio test, and left-right consistency check.

The reference's equivalents: ``std::min_element`` WTA over the candidate SAD
list (``/root/reference/src/CameraStereoVision.cpp:85``) with the disparity
stored as a truncated uint8 magnitude (``:89``) and no consistency checking.
Here WTA is an argmin over the lane-resident D axis, disparities stay float32
with subpixel precision, and invalid pixels carry an explicit sentinel
(INVALID_DISPARITY) instead of uninitialized memory (reference bug §2.3.3).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

INVALID_DISPARITY = jnp.float32(-1.0)


def _value_at(vol: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """vol (..., D) at index d (...,) -> (...,) via a one-hot reduction.

    A masked sum is one fused elementwise pass over the volume."""
    idx = jax.lax.broadcasted_iota(jnp.int32, vol.shape, vol.ndim - 1)
    return jnp.sum(jnp.where(idx == d[..., None], vol, 0), axis=-1)


class DisparityResult(NamedTuple):
    disparity: jnp.ndarray  # (H, W) float32, INVALID_DISPARITY where rejected
    cost: jnp.ndarray  # (H, W) winning aggregated cost
    valid: jnp.ndarray  # (H, W) bool
    confidence: Optional[jnp.ndarray] = None  # (H, W) PKRN in [0,1), 0 invalid


def winner_take_all(vol: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(H, W, D) -> integer argmin disparity (H, W) int32 and its cost."""
    d = jnp.argmin(vol, axis=-1).astype(jnp.int32)
    c = jnp.min(vol, axis=-1)
    return d, c


def subpixel_refine(vol: jnp.ndarray, disp: jnp.ndarray) -> jnp.ndarray:
    """Parabola fit through (d-1, d, d+1) costs -> float disparity.

    delta = (c_minus - c_plus) / (2 * (c_minus - 2 c0 + c_plus)), clamped to
    [-0.5, 0.5]; border disparities keep their integer value."""
    D = vol.shape[-1]
    d0 = jnp.clip(disp, 1, D - 2)
    # single volume pass gathering all three neighbours via one-hot masks
    idx = jax.lax.broadcasted_iota(jnp.int32, vol.shape, vol.ndim - 1)
    rel = idx - d0[..., None]
    cm = jnp.sum(jnp.where(rel == -1, vol, 0), axis=-1)
    c0 = jnp.sum(jnp.where(rel == 0, vol, 0), axis=-1)
    cp = jnp.sum(jnp.where(rel == 1, vol, 0), axis=-1)
    denom = cm - 2.0 * c0 + cp
    delta = jnp.where(jnp.abs(denom) > 1e-9, (cm - cp) / (2.0 * denom), 0.0)
    delta = jnp.clip(delta, -0.5, 0.5)
    interior = (disp >= 1) & (disp <= D - 2)
    return jnp.where(interior, d0.astype(vol.dtype) + delta, disp.astype(vol.dtype))


def uniqueness_mask(vol: jnp.ndarray, disp: jnp.ndarray, ratio: float) -> jnp.ndarray:
    """True where best cost < ratio * second-best cost (excluding the
    immediate +-1 neighbours of the winner, which share its parabola)."""
    D = vol.shape[-1]
    d_idx = jax.lax.broadcasted_iota(jnp.int32, vol.shape, vol.ndim - 1)
    near = jnp.abs(d_idx - disp[..., None]) <= 1
    masked = jnp.where(near, jnp.inf, vol)
    second = jnp.min(masked, axis=-1)
    best = _value_at(vol, disp)
    return best < ratio * second


def left_right_check(
    disp_left: jnp.ndarray, disp_right: jnp.ndarray, max_diff: float = 1.25
) -> jnp.ndarray:
    """Standard LR consistency: |d_L(x) - d_R(x - d_L(x))| <= max_diff.

    disp_* are float maps; gathering uses the rounded left disparity."""
    h, w = disp_left.shape
    x = jnp.arange(w)[None, :]
    xr = jnp.clip(jnp.round(x - disp_left).astype(jnp.int32), 0, w - 1)
    d_r = jnp.take_along_axis(disp_right, xr, axis=1)
    ok = jnp.abs(disp_left - d_r) <= max_diff
    return ok & (disp_left >= 0) & (d_r >= 0)


def disparity_from_volume(
    vol: jnp.ndarray,
    vol_right: Optional[jnp.ndarray] = None,
    subpixel: bool = True,
    uniqueness: float = 0.0,
    lr_max_diff: float = 0.0,
    mask: Optional[jnp.ndarray] = None,
    with_confidence: bool = False,
) -> DisparityResult:
    """Full extraction: WTA -> subpixel -> uniqueness -> LR check -> mask.

    vol_right: the source-view volume (see
    ``cost_volume.right_from_left_volume``); required when lr_max_diff > 0.
    mask: optional (H, W) bool ROI gate — the face-mask role from the
    reference (``/root/reference/src/CameraStereoVision.cpp:53``), applied to
    the *output* instead of gating compute (dense compute + select is the
    whole-array version of a sparse pixel loop)."""
    d_int, c = winner_take_all(vol)
    disp = subpixel_refine(vol, d_int) if subpixel else d_int.astype(vol.dtype)
    valid = jnp.ones(disp.shape, dtype=bool)
    if uniqueness > 0.0:
        valid &= uniqueness_mask(vol, d_int, uniqueness)
    if lr_max_diff > 0.0:
        if vol_right is None:
            raise ValueError("lr_max_diff > 0 requires vol_right")
        d_r_int, _ = winner_take_all(vol_right)
        d_r = subpixel_refine(vol_right, d_r_int) if subpixel else d_r_int.astype(vol.dtype)
        valid &= left_right_check(disp, d_r, lr_max_diff)
    if mask is not None:
        valid &= mask
    disp = jnp.where(valid, disp, INVALID_DISPARITY)
    conf = None
    if with_confidence:
        from stereovisionarray_tpu.ops.confidence import confidence_from_volume

        conf = confidence_from_volume(vol, d_int, valid)
    return DisparityResult(disparity=disp, cost=c, valid=valid, confidence=conf)
