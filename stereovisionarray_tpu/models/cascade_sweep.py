"""Cascade (coarse-to-fine) N-view plane sweep for the camera array.

The array generalization of ``models/cascade.py``: the reference brackets
each ray between 0.5x and 1.0x depth and rasterizes the segment per pixel
(``/root/reference/src/CameraStereoVision.cpp:60-73``) — per-pixel
data-dependent candidate lists. The array-program form is a static
two-level cascade over the plane axis:

1. **Coarse pass** — area-downsample every view by ``coarse_factor`` and
   run the full :func:`plane_sweep_depth` with ``ceil(D / factor)`` planes
   on scaled intrinsics (``fx/s``, ``(cx - (s-1)/2)/s``): the cost volume
   shrinks ~``factor**3``.
2. **Band selection** — median + speckle + background hole fill
   (``fill_holes(take="max")``: plane index GROWS with depth, so the
   background surface is the larger index), upsample the plane-index map,
   and quantize to a per-pixel band start ``off(x) = q * B(x)`` such that
   the true plane lies in ``[off, off + D_fine)``.
3. **Fine pass** — pre-warp each source view by its own band shift and
   sweep only ``D_fine`` residual planes with the SAME kernels.

The pre-warp is exact in shift space because per-view shifts are LINEAR in
the plane index for translation-only rigs: planes uniform in inverse depth
give ``shift_v(j) = a_v + c_v * j`` (:func:`translation_shifts`), so
warping source ``v`` by ``a_v + c_v * q * B`` and sweeping residual shifts
``c_v * j`` for ``j in [0, D_fine)`` reproduces the flat sweep's samples at
planes ``q*B .. q*B + D_fine`` exactly. Two approximations remain, both
band-local (evaluated in ``tests/test_cascade_sweep.py``):

- the band field is read in the PRE-WARPED frame: view ``v`` at reference
  pixel ``x`` uses ``B(x + c_v * (j - D_fine/2))`` (after the per-view
  centering shift from :func:`cascade_static_params`), i.e. up to
  ``|c_v| * D_fine / 2`` px (~a few px) of band misalignment — harmless
  where ``B`` is locally constant, confined to band boundaries elsewhere;
- the pre-warp is bilinear, so the fine pass resamples already-interpolated
  content (one extra bilinear blur, <= half a pixel of support);
- the PKRN confidence is computed WITHIN the fine window: a band placed
  wrong by the coarse pass can score confidently wrong (the flat sweep's
  confidence sees the whole range). Downstream gates that must catch such
  pixels should also test multi-view support (fusion's consistency vote
  does).

Out-of-view masking: the fine kernels see only residual shifts, so their
per-plane view counts are computed in the pre-warped frame and are
optimistic near borders; the TRUE count is recomputed at decode from the
full shift ``a_v + c_v * k_win`` (pure iota arithmetic, no gathers).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from stereovisionarray_tpu.config import PlaneSweepConfig, SGMConfig
from stereovisionarray_tpu.geometry.camera import CameraArray
from stereovisionarray_tpu.geometry.epipolar import inverse_depth_samples
from stereovisionarray_tpu.models.plane_sweep import (
    PlaneSweepOutput,
    _shift_warp,
    _volume_to_maps,
    plane_sweep_depth,
    plane_sweep_volume,
    translation_shifts,
)
from stereovisionarray_tpu.ops.hatsample import hat_sample
from stereovisionarray_tpu.ops.postfilter import (
    _shifted,
    fill_holes,
    median3x3,
    speckle_filter,
)
from stereovisionarray_tpu.ops.refine import box_filter2d

__all__ = [
    "cascade_plane_sweep_depth",
    "cascade_static_params",
]


def _scale_cameras(cameras: CameraArray, s: int) -> CameraArray:
    """Intrinsics for an s-fold area downsample: coarse pixel center u'
    maps to fine u = s*u' + (s-1)/2, so fx' = fx/s and
    cx' = (cx - (s-1)/2)/s. Extrinsics are resolution-independent."""
    half = (s - 1) / 2.0
    return CameraArray(
        fx=cameras.fx / s,
        fy=cameras.fy / s,
        cx=(cameras.cx - half) / s,
        cy=(cameras.cy - half) / s,
        R=cameras.R,
        t=cameras.t,
    )


def _area_downsample(imgs: jnp.ndarray, s: int) -> jnp.ndarray:
    """(..., H, W) -> (..., H/s, W/s) area mean; H, W must be multiples of
    s. Shared with the two-view cascade (models/cascade.py)."""
    h, w = imgs.shape[-2:]
    shape = imgs.shape[:-2] + (h // s, s, w // s, s)
    return imgs.reshape(shape).mean(axis=(-3, -1))


def _pad_to_multiple(imgs: jnp.ndarray, s: int) -> jnp.ndarray:
    """Edge-pad the trailing (H, W) axes up to multiples of s."""
    h, w = imgs.shape[-2:]
    ph, pw = (-h) % s, (-w) % s
    if ph or pw:
        pad = [(0, 0)] * (imgs.ndim - 2) + [(0, ph), (0, pw)]
        imgs = jnp.pad(imgs, pad, mode="edge")
    return imgs


def _upsample_bilinear(k: jnp.ndarray, s: int) -> jnp.ndarray:
    """(h, w) -> (h*s, w*s) with ``jax.image.resize(method="linear")``
    semantics for integer factors (half-pixel centers, edge clamp), as
    ~4*s static slices + lerps. Per-op fixed cost dominates every stage at
    coarse-map shapes (probe_cascade_stages.py), so the op count is the
    cost — resize's general lowering is a fatter graph."""
    def axis_up(x, axis):
        n = x.shape[axis]
        pad = [(0, 0), (0, 0)]
        pad[axis] = (1, 1)
        xp = jnp.pad(x, pad, mode="edge")
        phases = []
        for p in range(s):
            c = (p - (s - 1) / 2.0) / s  # coarse offset of fine phase p
            b = 1 + int(np.floor(c))
            a = float(c - np.floor(c))
            lo = jax.lax.slice_in_dim(xp, b, b + n, axis=axis)
            hi = jax.lax.slice_in_dim(xp, b + 1, b + 1 + n, axis=axis)
            phases.append(lo * (1.0 - a) + hi * a)
        st = jnp.stack(phases, axis=axis + 1)
        shape = list(x.shape)
        shape[axis] = n * s
        return st.reshape(shape)

    return axis_up(axis_up(k, 0), 1)


def cascade_static_params(
    cameras: CameraArray,
    ref_index: int,
    src_indices: Tuple[int, ...],
    cfg: PlaneSweepConfig,
    fine_planes: int,
) -> tuple:
    """HOST-SIDE static parameters for :func:`cascade_plane_sweep_depth`
    (the ``translation_axis_flags`` pattern: must run on a CONCRETE camera
    array, outside jit). Returns ``(band_offsets, fine_pad)``:

    - ``band_offsets``: per-view integer (dy, dx) shifts that center each
      view's band-field read on the fine window's midpoint (halves the
      worst-case band misalignment from ``|c_v| * D_fine`` to half that);
    - ``fine_pad``: static bound on the fine pass's residual shifts
      ``|c_v| * (D_fine - 1)``. Production callers pass
      ``fine_shift_pad=None`` (reuse the full-range ``shift_pad``).

    Returns ``(None, None)`` for traced cameras; the cascade then skips
    centering and falls back to ``shift_pad``.
    """
    if isinstance(cameras.t, jax.core.Tracer):
        return None, None
    try:
        t = np.asarray(cameras.t)
        n = t.shape[0]
        fx = np.broadcast_to(np.asarray(cameras.fx), (n,))
        fy = np.broadcast_to(np.asarray(cameras.fy), (n,))
    except (jax.errors.TracerArrayConversionError, jax.errors.ConcretizationTypeError):
        return None, None
    src = [int(i) for i in src_indices]
    d = max(cfg.num_planes - 1, 1)
    step_inv = (1.0 / cfg.z_far - 1.0 / cfg.z_near) / d
    offsets = []
    max_c = 0.0
    for s in src:
        cu = fx[s] * (t[s, 0] - t[ref_index, 0]) * step_inv
        cv = fy[s] * (t[s, 1] - t[ref_index, 1]) * step_inv
        offsets.append((int(round(cv * fine_planes / 2)), int(round(cu * fine_planes / 2))))
        max_c = max(max_c, abs(cu), abs(cv))
    fine_pad = int(np.ceil(max_c * max(fine_planes - 1, 1))) + 2
    return tuple(offsets), fine_pad


def _coarse_band_prewarp(
    images: jnp.ndarray,
    cameras: CameraArray,
    ref_index: int,
    src_indices: tuple,
    cfg: PlaneSweepConfig,
    sgm_cfg: Optional[SGMConfig],
    *,
    min_views: int,
    backend: str,
    shift_pad: int,
    coarse_factor: int,
    fine_planes: int,
    band_step: int,
    band_offsets: Optional[tuple],
    mode: str = "smooth",
) -> tuple:
    """Coarse pass + shift field + per-view pre-warp — everything the
    cascade does BEFORE the fine sweep. Shared by the single-chip
    :func:`cascade_plane_sweep_depth` and the plane-sharded program
    (parallel/cascade_sweep.py), whose fine passes differ.

    ``mode="smooth"`` (default) pre-warps each view by the CONTINUOUS
    plane-index field (box-smoothed coarse map), realized as two bilinear
    sampling passes per view (vertical via transpose, then horizontal —
    ``ops/hatsample.py``).
    The round-4 band quantization put ``|c_v|*band_step``-px content
    seams in every pre-warped view; on slanted surfaces those seams are
    the entire bad-2 tail (EVAL_CASCADE_SWEEP_r04: 0.39% vs flat 0.06%).
    The horizontal pass samples its field at un-warped rows — a
    ``|s_v| * d(field)/dy`` anchor approximation for diagonal views, the
    round-4 band-misalignment class, sub-plane in practice.

    ``mode="band"`` keeps the round-4 one-hot integer band warp.

    Returns ``(wsrc, offset, a, c, depths_full)``: pre-warped sources
    (S, H, W), the per-pixel plane-index offset field (H, W) — integer
    band starts ("band") or the float field ("smooth") — the per-view
    shift intercepts/steps (S, 2) each, and the full (D,) plane depths.
    """
    total = int(cfg.num_planes)
    s = int(coarse_factor)
    df = int(fine_planes)
    q = int(band_step)
    dtype = images.dtype if jnp.issubdtype(images.dtype, jnp.floating) else jnp.float32
    images = images.astype(dtype)
    n, h, w = images.shape
    src = jnp.asarray(src_indices, dtype=jnp.int32)
    src_images = images[src]
    n_src = len(src_indices)

    # ---- coarse pass on the downsampled rig --------------------------------
    imgs_p = _pad_to_multiple(images, s)
    d_coarse = -(-total // s)
    d_coarse = -(-d_coarse // 8) * 8  # whole multiples of 8 planes
    # census patch scaled DOWN with resolution (the two-view cascade's
    # census A/B: a full-size window at quarter res spans 4x the scene
    # footprint and under-estimates on slants — models/cascade.py)
    cfg_c = dataclasses.replace(
        cfg, num_planes=d_coarse,
        patch=max(3, (cfg.patch // s) | 1),
    )
    coarse = plane_sweep_depth(
        _area_downsample(imgs_p, s),
        _scale_cameras(cameras, s),
        ref_index,
        src_indices,
        cfg_c,
        sgm_cfg,
        min_views=min_views,
        backend=backend,
        shift_pad=-(-shift_pad // s) + 2,
    )

    # a coarse blunder poisons a whole fine band: median + speckle suppress
    # isolated blunders; occlusion holes get the BACKGROUND (max-index) band.
    # At these tiny coarse shapes the op count is the cost, so window/span
    # are chosen for it (speckle w5 = 25 shifted compares vs 81; fill span
    # 32 = 5 doubling steps; a coarse occlusion hole wider than 32 coarse px
    # would need a disparity range far beyond the plane bracket)
    kc = median3x3(coarse.plane, coarse.valid)
    kc, vc = speckle_filter(kc, coarse.valid, max_diff=2.0, window=5,
                            min_support=8)
    kc, vc = fill_holes(kc, vc, take="max", max_span=32)
    kc = jnp.where(vc, kc, (d_coarse - 1) / 2.0)

    ratio = (total - 1) / max(d_coarse - 1, 1)
    k_up = _upsample_bilinear(kc * ratio, s)[:h, :w]

    # ---- per-pixel band starts ---------------------------------------------
    # band b starts at min(b*q, total-df): the last band CLAMPS to the top
    # of the range so any (num_planes, fine_planes, band_step) combination
    # covers every plane (no divisibility requirement); min() keeps the
    # start a closed-form function of the band index — no table lookup
    n_bands = -(-(total - df) // q) + 1
    band = jnp.clip(jnp.round((k_up - 0.5 * df) / q).astype(jnp.int32), 0, n_bands - 1)
    offset = jnp.minimum(band * q, total - df).astype(dtype)  # (H, W) band start

    # ---- band pre-warp of every source view --------------------------------
    depths_full = inverse_depth_samples(cfg.z_near, cfg.z_far, total, dtype=dtype)
    sh_full = translation_shifts(cameras, ref_index, src, depths_full)  # (S, D, 2)
    a = sh_full[:, 0, :]  # (S, 2) shift at plane 0
    c = (sh_full[:, total - 1, :] - a) / max(total - 1, 1)  # (S, 2) per-plane step

    if mode == "smooth":
        ones = jnp.ones_like(k_up)
        k_s = box_filter2d(k_up, 9) / box_filter2d(ones, 9)
        K_star = jnp.clip(k_s - 0.5 * df, 0.0, float(total - df))
        pad = int(shift_pad) + 1
        warped = []
        for v in range(n_src):
            if band_offsets is not None:
                dy, dx = band_offsets[v]
                Kv = _shifted(K_star, dy, dx)
            else:
                Kv = K_star
            su = a[v, 0] + c[v, 0] * Kv
            sv = a[v, 1] + c[v, 1] * Kv
            # vertical pass on the transposed view, then horizontal
            tmp = hat_sample(src_images[v].T, jnp.clip(-sv, -pad, pad).T,
                             -pad, pad).T
            warped.append(hat_sample(tmp, jnp.clip(-su, -pad, pad),
                                     -pad, pad))
        return jnp.stack(warped), K_star, a, c, depths_full

    if band_offsets is not None:
        bv = jnp.stack([_shifted(band, dy, dx) for dy, dx in band_offsets])
    else:
        bv = jnp.broadcast_to(band, (n_src, h, w))

    pad = shift_pad + 1
    padded = jnp.pad(src_images, ((0, 0), (pad, pad), (pad, pad)))
    warp_one = jax.vmap(lambda p, o: _shift_warp(p, o[0], o[1], h, w, pad))
    wsrc = jnp.zeros((n_src, h, w), dtype)
    for b in range(n_bands):
        # one-hot select over static per-band shifts
        start_b = min(b * q, total - df)
        wsrc = wsrc + jnp.where(bv == b, warp_one(padded, a + c * start_b), 0.0)
    return wsrc, offset, a, c, depths_full


@functools.partial(
    jax.jit,
    static_argnames=(
        "ref_index", "src_indices", "cfg", "sgm_cfg", "min_views", "backend",
        "shift_pad", "coarse_factor", "fine_planes", "band_step",
        "band_offsets", "fine_shift_pad", "mode",
    ),
)
def cascade_plane_sweep_depth(
    images: jnp.ndarray,
    cameras: CameraArray,
    ref_index: int,
    src_indices: tuple,
    cfg: PlaneSweepConfig = PlaneSweepConfig(),
    sgm_cfg: Optional[SGMConfig] = SGMConfig(lr_max_diff=0.0),
    min_views: int = 2,
    mask: Optional[jnp.ndarray] = None,
    backend: str = "auto",
    shift_pad: int = 0,
    coarse_factor: int = 4,
    fine_planes: int = 48,
    band_step: int = 8,
    band_offsets: Optional[tuple] = None,
    fine_shift_pad: Optional[int] = None,
    mode: str = "smooth",
) -> PlaneSweepOutput:
    """Drop-in :func:`plane_sweep_depth` for large plane counts on
    translation-only rigs (``shift_pad > 0`` REQUIRED — general rigs have
    non-linear per-plane warps and must use the flat sweep).

    ``cfg.num_planes`` is the TOTAL range; the fine pass sweeps a per-pixel
    ``fine_planes``-wide window positioned by the coarse result (window
    starts quantized to ``band_step`` planes). Compute
    ``band_offsets`` / ``fine_shift_pad`` host-side with
    :func:`cascade_static_params` when the cameras are concrete.
    """
    total = int(cfg.num_planes)
    s = int(coarse_factor)
    df = int(fine_planes)
    q = int(band_step)
    if shift_pad <= 0:
        raise ValueError("cascade_plane_sweep_depth requires the translation "
                         "fast path (shift_pad > 0)")
    if total <= df:
        raise ValueError("total planes <= fine_planes: use plane_sweep_depth")
    if df < 2 * q:
        raise ValueError("fine_planes must be >= 2*band_step (the window "
                         "must out-margin the band quantization)")

    if mode not in ("smooth", "band"):
        raise ValueError(f"unknown cascade mode {mode!r}")
    wsrc, offset, a, c, depths_full = _coarse_band_prewarp(
        images, cameras, ref_index, src_indices, cfg, sgm_cfg,
        min_views=min_views, backend=backend, shift_pad=shift_pad,
        coarse_factor=s, fine_planes=df, band_step=q,
        band_offsets=band_offsets, mode=mode,
    )
    dtype = wsrc.dtype
    n_src = len(src_indices)
    h, w = offset.shape
    ref = images.astype(dtype)[ref_index]

    # ---- fine pass: residual shifts c_v * j over the pre-warped sources ----
    j = jnp.arange(df, dtype=dtype)
    fine_shifts = c[:, None, :] * j[None, :, None]  # (S, Df, 2)
    cfg_f = dataclasses.replace(cfg, num_planes=df)
    vol, _, _ = plane_sweep_volume(
        jnp.concatenate([ref[None], wsrc], axis=0),
        cameras,  # unused: explicit shifts
        0,
        tuple(range(1, n_src + 1)),
        cfg_f,
        shift_pad=fine_shift_pad if fine_shift_pad is not None else shift_pad,
        depths=depths_full[:df],
        shifts=fine_shifts,
    )
    k_f, cost, conf, _ = _volume_to_maps(vol, ref, cfg_f, sgm_cfg, backend)

    # ---- decode to the full plane range ------------------------------------
    k_full = k_f + offset
    inv_near = 1.0 / cfg.z_near
    step = (1.0 / cfg.z_far - inv_near) / max(total - 1, 1)
    depth = 1.0 / jnp.maximum(inv_near + k_full * step, 1e-9)

    # true per-view visibility at the winning plane, in the ORIGINAL frame
    # (the fine kernels only saw residual shifts) — pure iota arithmetic
    u_iota = jax.lax.broadcasted_iota(dtype, (h, w), 1)
    v_iota = jax.lax.broadcasted_iota(dtype, (h, w), 0)
    pu = u_iota[None] + a[:, 0, None, None] + c[:, 0, None, None] * k_full[None]
    pv = v_iota[None] + a[:, 1, None, None] + c[:, 1, None, None] * k_full[None]
    ok = (pu >= 0.0) & (pu <= w - 1.0) & (pv >= 0.0) & (pv <= h - 1.0)
    views_at_win = jnp.sum(ok, axis=0).astype(jnp.int32)

    valid = views_at_win >= min_views
    if mask is not None:
        valid = valid & mask
    depth = jnp.where(valid, depth, 0.0)
    return PlaneSweepOutput(
        depth=depth,
        plane=k_full,
        cost=cost,
        valid=valid,
        num_views=views_at_win,
        confidence=jnp.where(valid, conf, 0.0),
    )
