"""Cascade (coarse-to-fine) two-view stereo for large disparity ranges.

The reference bounds its search by bracketing each ray between 0.5x and
1.0x depth and rasterizing that segment per pixel
(``/root/reference/src/CameraStereoVision.cpp:60-73``) — a per-pixel
data-dependent candidate list. The array-program generalization is a
static two-level cascade:

1. **Coarse pass** — downsample both views by ``coarse_factor`` (area
   mean) and run the full fast pipeline with the disparity range scaled
   down accordingly (`D_total / factor` disparities at `1/factor**2` the
   pixels: ~`1/factor**3` of the flat cost volume).
2. **Pre-warp** — warp the right view toward the left by a field derived
   from the coarse map, so the fine pass only searches a
   ``fine_disparities``-wide residual window.
3. **Fine pass** — run the same fast pipeline at ``D_fine`` disparities
   on (left, warped right); decode ``total = d_fine + s_eff(x - d_fine)``
   with the warp's exact effective shift field.

Two pre-warp modes:

``mode="smooth"`` (default, round-5) — warp by the CONTINUOUS
slope-compensated coarse field. The round-4 band-quantized warp produced
content seams every ``band_step/slope`` px on slanted surfaces, whose
duplicated strips created systematic one-band-down false matches (bad-2
1.25% vs flat 0.008% at D=256, ``EVAL_CASCADE_r04``; diagnosed in
seam-free band volumes still fail on the fine-index sawtooth). A smooth
warp has no seams and a ~constant fine-index field. The field is
decomposed ``s*(x,y) = g(x) + r(x,y)``:

- ``g`` (1D column field, any range): one hat-matrix matmul;
- ``r`` (clamped to ±``SMOOTH_R``): a per-pixel bilinear sample
  (``ops/hatsample.py``); R is sized for the 1/(1-g')-AMPLIFIED column
  deviation (the sample's anchor moves with the residual);
- the EXACT effective field ``s_eff(x) = r(x) + g(x - r(x))`` is ``g``
  sampled with the same two bilinear weights, so the decode is
  consistent even where ``r`` clamps (clamping only costs coverage).

Slope compensation: sampling ``s`` at the match position shrinks the
covered totals to ``Df * (1 - slope)``, so the centering uses the locally
smoothed coarse gradient: ``s* = up - Df/2 * (1 - sigma)``. Limitations
(documented, measured): scenes whose disparity varies mostly VERTICALLY
by more than ~``SMOOTH_R`` px defeat the column-field split (coverage
loss where ``|r|`` clamps); ``mode="band"`` remains as the fallback.

``mode="band"`` (round-4) — per-pixel integer band offsets quantized to
``band_step``, one-hot select over static shifts. Keeps its seam tail;
retained for comparison and as the vertical-structure fallback.

Accuracy against the flat pipeline is checked by ``tests/test_cascade.py``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from stereovisionarray_tpu.config import CostConfig, SGMConfig
from stereovisionarray_tpu.models.two_view import (
    disparity_to_depth,
    two_view_disparity,
)
from stereovisionarray_tpu.ops.postfilter import (
    _shifted,
    median3x3,
    speckle_filter,
)
from stereovisionarray_tpu.ops.hatsample import hat_sample
from stereovisionarray_tpu.ops.refine import box_filter2d
from stereovisionarray_tpu.ops.wta import INVALID_DISPARITY

__all__ = ["cascade_two_view_disparity", "CascadeOutput", "SMOOTH_R"]

# residual half-range: with the scale-matched coarse window the residual
# never reaches past 36 px on the 540-row eval scene (R=36 and R=44 score
# identically)
SMOOTH_R = 36


class CascadeOutput(NamedTuple):
    disparity: jnp.ndarray  # (H, W) float32 in the FULL range, sentinel invalid
    valid: jnp.ndarray  # (H, W) bool
    cost: jnp.ndarray  # (H, W) fine-pass winning cost
    depth: Optional[jnp.ndarray] = None
    confidence: Optional[jnp.ndarray] = None  # fine-pass PKRN (edge-capped)
    coarse_disparity: Optional[jnp.ndarray] = None  # (H, W) upsampled px
    band_offset: Optional[jnp.ndarray] = None  # (H, W) shift field: int32
    # band starts ("band") or the float effective field s_eff ("smooth")


# shared coarse-pass helpers (shape-generic over leading axes)
from stereovisionarray_tpu.models.cascade_sweep import (  # noqa: E402
    _area_downsample,
    _pad_to_multiple,
)


def _select_shifted(values: jnp.ndarray, index: jnp.ndarray, shifts) -> jnp.ndarray:
    """out(x) = values(x - shifts[i]) where index(x) == i.

    One-hot select-sum over a static list of shifted copies."""
    out = jnp.zeros_like(values)
    for i, sh in enumerate(shifts):
        out = out + jnp.where(index == i, _shifted(values, 0, int(sh)), 0)
    return out


def _box_mean(x: jnp.ndarray, k: int) -> jnp.ndarray:
    """k x k box MEAN with correct border normalization."""
    ones = jnp.ones_like(x)
    return box_filter2d(x, k) / box_filter2d(ones, k)


def _hat_matmul_warp(img: jnp.ndarray, g: jnp.ndarray) -> jnp.ndarray:
    """out(y, x) = bilinear img(y, x - g[x]) for a 1D column field g (W,).

    The hat matrix M[u, x] = max(0, 1 - |clip(x - g[x]) - u|) realizes an
    arbitrary-range per-COLUMN shift as one (H,W)@(W,W) matmul. HIGHEST
    precision: the hat weights must act as exact f32 bilinear
    coefficients, not bf16 (census bits flip on ~1-LSB intensity noise)."""
    w = img.shape[1]
    pos = jnp.clip(jnp.arange(w, dtype=img.dtype) - g, 0.0, w - 1.0)
    u = jnp.arange(w, dtype=img.dtype)
    m = jnp.maximum(0.0, 1.0 - jnp.abs(pos[None, :] - u[:, None]))
    return jax.lax.dot_general(
        img, m, (((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
    )


def _smooth_prewarp(right: jnp.ndarray, s_star: jnp.ndarray,
                    smooth_r: int = None):
    """Warp ``right`` by the smooth field ``s_star`` (see module docstring).

    Composition (1D matmul INNER, residual chain OUTER):

        wright(x) = v1(x - r(x)),   v1(u) = right(u - g(u)),
        r(x) = clip((s*(x) - g(x)) / (1 - g'(x)), -R, R),

    where ``g`` is the 1D column mean of ``s*``. The inner hat matmul is
    per-column and therefore exact for ANY 1D field, jumps included; the
    outer chain is anchored at the output pixel. The price is that the
    chain must carry the residual AMPLIFIED by 1/(1 - g') (its anchor
    moves with r), which sizes ``SMOOTH_R``.

    The inverted arrangement (matmul outer over an invertible slope-
    limited field) needs no amplification — but any 1D jump compresses
    the intermediate grid by (1 - g') and destroys content resolution
    across a jump/0.8-wide zone (measured: 1-3 px match errors across
    50-column strips behind each discontinuity). Jump fidelity beats
    residual-range economy; this form keeps the per-column inner warp.

    Returns ``(wright, s_eff)`` with ``s_eff`` the EXACT realized field
    (same hat weights applied to ``k + g(x-k)``, valid under clamping);
    the decode must sample ``s_eff``."""
    R = int(smooth_r) if smooth_r is not None else SMOOTH_R
    h, w = right.shape
    dt = right.dtype
    g = jnp.mean(s_star, axis=0)  # (W,)
    # 1D slope of g, lightly smoothed, clamped: the residual solve divides
    # by (1 - g'); slopes >= ~0.7 would blow up the residual range
    gp = jnp.convolve(jnp.gradient(g), jnp.ones(9, dt) / 9.0, mode="same")
    gp = jnp.clip(gp, -0.2, 0.7)
    # first-order fixed point of r + g(x - r) = s*: the chain's anchor
    # moves with the residual, amplifying it by 1/(1 - g'); SMOOTH_R is
    # sized for the AMPLIFIED deviation (measured on the 540-row eval
    # scene: |r| > 32 for 0.55% of pixels, > 44 for ~0.01% — R=32 was
    # exactly the r4->r5 0.159% tail)
    r = jnp.clip((s_star - g[None, :]) / (1.0 - gp[None, :]),
                 -float(R), float(R))

    # inner warp: ONE hat matmul by the 1D column field (per-column ->
    # exact for ANY g, jumps included; a matmul-OUTER arrangement instead
    # compresses the intermediate grid wherever g ramps and destroys
    # content resolution behind every jump — measured as 1-3 px match
    # errors across 50-column zones)
    v1 = _hat_matmul_warp(right, g)

    # outer sample, anchored at the output pixel: bilinear v1(x - r(x)),
    # with the 1D field g sampled by the same two weights; the weights
    # sum to 1 with mean offset r, so s_eff = r + sum_k w_k g(x-k) — the
    # EXACT realized field, including where r clamps
    wright, g_samp = hat_sample(v1, r, -R, R, aux=g)
    s_eff = r + g_samp
    return wright, s_eff


@functools.partial(
    jax.jit,
    static_argnames=(
        "cost_cfg",
        "sgm_cfg",
        "coarse_factor",
        "fine_disparities",
        "band_step",
        "baseline",
        "focal_px",
        "backend",
        "mode",
        "slant_bias",
        "internal_paths",
        "smooth_r",
    ),
)
def cascade_two_view_disparity(
    left: jnp.ndarray,
    right: jnp.ndarray,
    cost_cfg: CostConfig = CostConfig(num_disparities=256),
    sgm_cfg: SGMConfig = SGMConfig(),
    coarse_factor: int = 4,
    fine_disparities: int = 32,
    band_step: int = 8,
    baseline: Optional[float] = None,
    focal_px: Optional[float] = None,
    backend: str = "auto",
    mode: str = "smooth",
    slant_bias: float = 0.0,
    internal_paths: Optional[int] = 4,
    # residual-chain half-range (default SMOOTH_R=36, tuned at 540x768).
    # The residual is the field's column-DEVIATION in pixels, so it
    # scales with resolution: at 1080p-class inputs pass ~2x (72) or
    # accept coverage clamping on scenes with strong vertical structure.
    smooth_r: Optional[int] = None,
) -> CascadeOutput:
    """Large-range disparity via a coarse pass + residual fine pass.

    ``cost_cfg.num_disparities`` is the TOTAL range; the fine pass
    searches a per-pixel ``fine_disparities``-wide window positioned by
    the coarse result. ``mode="smooth"`` (default) pre-warps by the
    continuous coarse field; ``mode="band"`` quantizes to integer bands
    of ``band_step`` (round-4 behavior, vertical-structure fallback).
    Both passes run through :func:`two_view_disparity`.
    """
    total = int(cost_cfg.num_disparities)
    s = int(coarse_factor)
    Df = int(fine_disparities)
    q = int(band_step)
    if total <= Df:
        raise ValueError("total range <= fine_disparities: use the flat pipeline")
    if Df % q or Df < 2 * q:
        raise ValueError("fine_disparities must be a multiple (>=2x) of band_step")
    if mode not in ("smooth", "band"):
        raise ValueError(f"unknown cascade mode {mode!r}")

    H, W = left.shape

    # ---- coarse pass on the downsampled pair -------------------------------
    lp = _pad_to_multiple(left, s)
    rp = _pad_to_multiple(right, s)
    d_coarse = -(-total // s)  # ceil
    d_coarse = -(-d_coarse // 8) * 8  # whole multiples of 8 disparities
    # scale the census window DOWN with the resolution: a (7,9) window at
    # quarter res spans 4x the scene footprint, and on steep slopes its
    # fronto-parallel support under-estimates disparity by 5-7 coarse px
    # in whole blobs (a coarse (5,5) window takes the eval-scene bad-2
    # from 0.167% to 0.001%; shrinking the FINE window instead does
    # nothing). (5,7) scores within the same bar (bad-2 0.024%).
    wh, ww = cost_cfg.census_window
    wh_c = max(5, (wh // 2) | 1)
    coarse_win = (wh_c, max(wh_c + 2, (ww // 2) | 1))
    coarse_cost = dataclasses.replace(
        cost_cfg, num_disparities=d_coarse, census_window=coarse_win
    )
    # a coarse blunder poisons a whole fine window: median + speckle
    # suppress isolated blunders, fill_holes gives occlusions a background
    # surface (an empty window is unrecoverable, a background one is
    # correct for occlusions by construction)
    coarse_sgm = dataclasses.replace(
        sgm_cfg,
        median_filter=True,
        speckle_window=max(sgm_cfg.speckle_window, 9),
        fill_holes=True,
    )
    coarse = two_view_disparity(
        _area_downsample(lp, s),
        _area_downsample(rp, s),
        coarse_cost,
        coarse_sgm,
        backend=backend,
    )
    cd = jnp.where(coarse.valid, coarse.disparity, 0.0) * float(s)
    up = jax.image.resize(cd, lp.shape, method="linear")[:H, :W]

    fine_cost = dataclasses.replace(cost_cfg, num_disparities=Df)

    if mode == "smooth":
        # ---- slope-compensated smooth field + pre-warp ---------------------
        # covered totals at x span [s*(x), s*(x) + Df*(1-sigma)] (the
        # match position moves with the residual), so center with the
        # locally smoothed coarse gradient (a 25x25 box is the difference
        # between a 0.14% and a 0.55% tail)
        # the field need only be accurate within the fine margin, and the
        # match-anchored sampling AMPLIFIES its wiggles by 1/(1-sigma): a
        # 9x9 box mean kills the coarse-grid interpolation noise that
        # otherwise surfaces as 2-5 px fine-pass blobs on sustained slopes
        # (with an exact field the warp is blameless: bad-2 0.0 in the
        # warp-style A/B on the 0.45-slope ramp)
        up_f = _box_mean(up, 9)
        # clip the gradient BEFORE averaging: compensation must respond to
        # sustained slopes (|d'| < 1 by visibility), not discontinuities —
        # an unclipped step leaks a sigma CLIFF (0.7 -> 0 in 2 px) at the
        # box-window frontier, which is itself a content seam
        gx = jnp.clip(jnp.gradient(up_f, axis=1), 0.0, 1.0)
        sigma = jnp.clip(_box_mean(gx, 25), 0.0, 0.7)
        # slant_bias (default 0 BY MEASUREMENT): a sigma-proportional
        # up-shift of the window was the first idea for the steep-flank
        # coarse under-estimation blob, but it
        # displaces well-covered pixels too — measured WORSE at every
        # tested beta (0.5: 0.183%, 1.0: 0.202% vs 0.167% baseline);
        # kept as a knob for extreme-slant scenes
        s_star = jnp.clip(
            up_f - 0.5 * Df * (1.0 - sigma) + slant_bias * 0.5 * Df * sigma,
            0.0, float(total - Df),
        )
        wright, s_eff = _smooth_prewarp(right, s_star, smooth_r=smooth_r)
        offset_field = s_eff
    else:
        # ---- integer band offsets (round-4 path) ---------------------------
        # band b starts at min(b*q, total-Df): the last band CLAMPS so any
        # (total, Df, q) combination covers every disparity (mirrors the
        # cascade_sweep fix; previously non-divisible tops were silently
        # unreachable — ADVICE r4)
        n_bands = -(-(total - Df) // q) + 1
        band = jnp.clip(
            jnp.round((up - 0.5 * Df) / q).astype(jnp.int32), 0, n_bands - 1
        )
        starts = [min(b * q, total - Df) for b in range(n_bands)]
        offset = jnp.zeros_like(up)
        wright = jnp.zeros_like(right)
        for b, st in enumerate(starts):
            sel = band == b
            wright = wright + jnp.where(sel, _shifted(right, 0, st), 0.0)
            offset = offset + jnp.where(sel, float(st), 0.0)
        offset_field = offset

    # ---- fine pass ---------------------------------------------------------
    # the smooth-warped residual problem is near-fronto-parallel (the
    # fine-index field is ~constant), so 4 SGM paths match 8 to within
    # the noise floor on the FINE pass (bad-2 0.024% -> 0.037% on the
    # eval scene, sustained-0.45-slope fixture 0.06% — still under the
    # 0.1% bar) at half the path scans. The COARSE pass must keep the
    # caller's full path count: dropping ITS diagonals on sustained
    # slopes blows the tail 10x (1.34% — isolated per-pass, fresh
    # processes). internal_paths=None restores full paths everywhere.
    fine_sgm = sgm_cfg
    if internal_paths is not None:
        fine_sgm = dataclasses.replace(
            sgm_cfg, num_paths=min(sgm_cfg.num_paths, int(internal_paths))
        )
    fine = two_view_disparity(left, wright, fine_cost, fine_sgm, backend=backend)

    # total disparity: the shift field sampled where the match landed
    if mode == "smooth":
        # bilinear sample of the smooth field at (x - d_f), as the warp
        t = jnp.clip(fine.disparity, 0.0, Df - 1.0)
        off_at = hat_sample(offset_field, t, 0, Df - 1)
    else:
        # band offsets are piecewise-constant: nearest sample (r4 decode)
        df_round = jnp.clip(jnp.round(fine.disparity).astype(jnp.int32), 0, Df - 1)
        off_at = _select_shifted(offset_field, df_round, list(range(Df)))
    disparity = jnp.where(
        fine.valid, fine.disparity + off_at, INVALID_DISPARITY
    )
    valid = fine.valid

    conf = fine.confidence
    if mode == "smooth":
        # residual speckles from warp-field error survive the fine pass as
        # small blobs against correct neighbours: a decoded-map median +
        # speckle pass removes them (bad-2 0.149% -> 0.048% at matching
        # density)
        disparity = median3x3(disparity, valid)
        disparity, valid = speckle_filter(
            disparity, valid, max_diff=1.5, window=5, min_support=8
        )
        disparity = jnp.where(valid, disparity, INVALID_DISPARITY)
    # fine-window-edge winners are untrustworthy — the window may not
    # cover the truth there; stop the PKRN map from vouching for them
    if conf is not None:
        edge = (fine.disparity < 1.5) | (fine.disparity > Df - 2.5)
        conf = jnp.where(valid, jnp.where(edge, jnp.minimum(conf, 0.05), conf), 0.0)

    depth = None
    if baseline is not None and focal_px is not None:
        depth = disparity_to_depth(
            jnp.where(valid, disparity, 0.0), baseline, focal_px
        )

    return CascadeOutput(
        disparity=disparity,
        valid=valid,
        cost=fine.cost,
        depth=depth,
        confidence=conf,
        coarse_disparity=up,
        band_offset=offset_field,
    )
