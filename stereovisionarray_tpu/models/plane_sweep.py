"""N-view plane-sweep depth over the camera array — BASELINE.json config 3.

The idiomatic generalization of the reference's multi-view machinery:
 - per-pair perspective warps (``/root/reference/src/functions.cpp:55-103``)
   become one 3x3 fronto-parallel-plane homography per (view, depth-plane),
   applied to the whole pixel grid as einsum + bilinear gather;
 - the pair topologies (``/root/reference/src/functions.cpp:148-213``) choose
   which array views contribute;
 - the +-5-step local photoconsistency refine
   (``improveWithDisparity``, ``/root/reference/src/functions.cpp:11-52``)
   becomes a dense sweep over D depth planes with robust multi-view cost
   fusion — instead of updating one disparity map pair-by-pair (last pair
   wins, reference bug §2.3.4), all views vote in one cost volume.

Execution: the sweep is a ``lax.map`` over planes (bounds the (S, H, W)
warp intermediate), each plane a vmap over source views of
warp + census/SAD/ZNCC cost, fused over views by mean / top-k mean. The
resulting (H, W, D) volume feeds the same SGM aggregation as two-view
stereo — smoothness across *plane index* plays the role of disparity
smoothness — then WTA + parabola refinement in inverse-depth space.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp

from stereovisionarray_tpu.backend import resolve_backend
from stereovisionarray_tpu.config import PlaneSweepConfig, SGMConfig
from stereovisionarray_tpu.geometry.camera import CameraArray
from stereovisionarray_tpu.geometry.epipolar import inverse_depth_samples
from stereovisionarray_tpu.ops.census import census_transform, hamming_distance
from stereovisionarray_tpu.ops.confidence import confidence_from_volume
from stereovisionarray_tpu.ops.sgm import sgm_aggregate
from stereovisionarray_tpu.ops.warp import homography_warp
from stereovisionarray_tpu.ops.wta import winner_take_all, subpixel_refine


class PlaneSweepOutput(NamedTuple):
    depth: jnp.ndarray  # (H, W) float32 fused depth, 0 where invalid
    plane: jnp.ndarray  # (H, W) float32 fractional winning plane index
    cost: jnp.ndarray  # (H, W) winning fused cost
    valid: jnp.ndarray  # (H, W) bool
    num_views: jnp.ndarray  # (H, W) int32 valid views at the winning plane
    confidence: Optional[jnp.ndarray] = None  # (H, W) PKRN in [0,1), 0 invalid


def _box_filter(x: jnp.ndarray, k: int) -> jnp.ndarray:
    """(.., H, W) mean filter with a k x k window via two separable cumsum
    passes (edge-padded) — O(HW) independent of k."""
    if k <= 1:
        return x
    p = k // 2

    def along(a, axis):
        pad = [(0, 0)] * a.ndim
        pad[axis] = (p + 1, p)
        ap = jnp.pad(a, pad, mode="edge")
        c = jnp.cumsum(ap, axis=axis)
        upper = jax.lax.slice_in_dim(c, k, k + a.shape[axis], axis=axis)
        lower = jax.lax.slice_in_dim(c, 0, a.shape[axis], axis=axis)
        return (upper - lower) / k

    return along(along(x, -1), -2)


def translation_shifts(
    cameras: CameraArray, ref_index: int, src, depths: jnp.ndarray
) -> jnp.ndarray:
    """(S, D, 2) exact per-plane pixel shifts (su, sv) for the
    translation-only fast path: warping source s to the reference at plane
    depth d samples ``src(u + su, v + sv)`` with

        su(d) = fx * (t_src - t_ref).x / d + (cx_s - cx_r)

    (and sv analogously). Algebraically this IS the fronto-plane
    homography's (H[0,2]/H[2,2], H[1,2]/H[2,2]) for the R = I, equal-focal,
    equal-z rigs the ``shift_pad > 0`` gate admits, but computed WITHOUT
    the K^{-1} matrix round trip: the homography chain leaves
    ``fx * (cx/fx) != cx`` dirt of ~1e-5 px in components that are exactly
    zero, which slightly biases the warp.
    """
    src = jnp.atleast_1d(jnp.asarray(src))
    n = cameras.t.shape[0]
    fx = jnp.broadcast_to(cameras.fx, (n,))
    fy = jnp.broadcast_to(cameras.fy, (n,))
    cx = jnp.broadcast_to(cameras.cx, (n,))
    cy = jnp.broadcast_to(cameras.cy, (n,))
    t_rel = cameras.t[src] - cameras.t[ref_index]  # (S, 3); R == I gate
    inv_d = 1.0 / depths  # (D,)
    su = fx[src][:, None] * t_rel[:, 0:1] * inv_d[None, :] + (
        cx[src] - cx[ref_index]
    )[:, None]
    sv = fy[src][:, None] * t_rel[:, 1:2] * inv_d[None, :] + (
        cy[src] - cy[ref_index]
    )[:, None]
    return jnp.stack([su, sv], axis=-1)


def _view_cost(
    ref: jnp.ndarray,
    ref_census: Optional[jnp.ndarray],
    warped: jnp.ndarray,
    valid: jnp.ndarray,
    cfg: PlaneSweepConfig,
    dtype,
) -> jnp.ndarray:
    """Photoconsistency cost of one warped view against the reference.
    Invalid (out-of-view) pixels get the cost ceiling so fusion ignores them
    via the top-k (reference instead skipped them pixel-by-pixel,
    ``/root/reference/src/CameraStereoVision.cpp:66-71``)."""
    if cfg.cost == "census":
        wc = census_transform(warped, (cfg.patch, cfg.patch))
        c = hamming_distance(ref_census, wc, dtype=dtype)
        ceiling = jnp.asarray(cfg.patch * cfg.patch - 1, dtype)
    elif cfg.cost == "sad":
        c = _box_filter(jnp.abs(ref - warped), cfg.patch)
        ceiling = jnp.asarray(255.0, dtype)
    elif cfg.cost == "zncc":
        mu_r = _box_filter(ref, cfg.patch)
        mu_w = _box_filter(warped, cfg.patch)
        var_r = _box_filter(ref * ref, cfg.patch) - mu_r * mu_r
        var_w = _box_filter(warped * warped, cfg.patch) - mu_w * mu_w
        cov = _box_filter(ref * warped, cfg.patch) - mu_r * mu_w
        ncc = cov * jax.lax.rsqrt(jnp.maximum(var_r * var_w, 1e-6))
        c = 1.0 - jnp.clip(ncc, -1.0, 1.0)  # in [0, 2]
        ceiling = jnp.asarray(2.0, dtype)
    else:
        raise ValueError(f"unknown plane-sweep cost {cfg.cost!r}")
    return jnp.where(valid, c, ceiling), ceiling


def _fuse_views(
    costs: jnp.ndarray, valids: jnp.ndarray, ceiling, cfg: PlaneSweepConfig
) -> jnp.ndarray:
    """Fuse per-view costs (S, H, W) -> (H, W). top-k mean over the best
    views is the standard occlusion-robust choice: an occluded view's high
    cost drops out of the k best."""
    if cfg.fusion == "min":
        return jnp.min(costs, axis=0)
    if cfg.fusion == "mean":
        n = jnp.maximum(jnp.sum(valids, axis=0), 1)
        return jnp.sum(jnp.where(valids, costs, 0.0), axis=0) / n
    if cfg.fusion == "topk_mean":
        k = min(cfg.topk, costs.shape[0])
        if k == costs.shape[0]:
            # top-k of all views is a plain mean — skip lax.top_k
            return jnp.mean(costs, axis=0)
        # k smallest = -(k largest of negated)
        top = -jax.lax.top_k(-jnp.moveaxis(costs, 0, -1), k)[0]  # (H, W, k)
        return jnp.mean(top, axis=-1)
    raise ValueError(f"unknown fusion {cfg.fusion!r}")


def _chunked_plane_map(per_plane, plane_args: jnp.ndarray, chunk: int):
    """lax.map over planes in vmapped chunks.

    One plane of work here is ~30 small ops on a (270, 360)-class image —
    per-kernel dispatch overhead dominates when lax.map runs them one plane
    at a time. Mapping
    over chunks of `chunk` planes with an inner vmap turns every op into a
    chunk-deep fused kernel: same peak-memory bound (one (chunk, S, H, W)
    warp stack) at a fraction of the dispatch count. The plane count is
    padded to a chunk multiple by repeating the last plane; the pad is
    sliced off after.
    """
    d = plane_args.shape[0]
    chunk = max(1, min(chunk, d))
    n_chunks = -(-d // chunk)
    pad = n_chunks * chunk - d
    if pad:
        plane_args = jnp.concatenate(
            [plane_args, jnp.repeat(plane_args[-1:], pad, axis=0)], axis=0
        )
    chunked = plane_args.reshape((n_chunks, chunk) + plane_args.shape[1:])
    outs = jax.lax.map(jax.vmap(per_plane), chunked)
    outs = jax.tree_util.tree_map(
        lambda x: x.reshape((n_chunks * chunk,) + x.shape[2:])[:d], outs
    )
    return outs


def _shift_warp(padded: jnp.ndarray, su, sv, h: int, w: int, pad: int):
    """Sample a `pad`-padded source image at a UNIFORM subpixel shift:
    out[y, x] = src[y + sv, x + su], bilinear.

    Four `dynamic_slice`s + lerp: the shift is uniform over the image, so
    contiguous slices replace a per-pixel gather. Used when every homography of
    the sweep is a pure translation (translation-only rigs — the reference
    geometry)."""
    j0 = jnp.floor(sv)
    i0 = jnp.floor(su)
    fv = sv - j0
    fu = su - i0
    y0 = (pad + j0).astype(jnp.int32)
    x0 = (pad + i0).astype(jnp.int32)

    def sl(dy, dx):
        return jax.lax.dynamic_slice(padded, (y0 + dy, x0 + dx), (h, w))

    top = sl(0, 0) * (1.0 - fu) + sl(0, 1) * fu
    bot = sl(1, 0) * (1.0 - fu) + sl(1, 1) * fu
    return top * (1.0 - fv) + bot * fv


@functools.partial(
    jax.jit,
    static_argnames=("ref_index", "src_indices", "cfg", "shift_pad"),
)
def plane_sweep_volume(
    images: jnp.ndarray,
    cameras: CameraArray,
    ref_index: int,
    src_indices: tuple,
    cfg: PlaneSweepConfig = PlaneSweepConfig(),
    shift_pad: int = 0,
    depths: Optional[jnp.ndarray] = None,
    shifts: Optional[jnp.ndarray] = None,
) -> tuple:
    """Build the fused (H, W, D) plane-sweep cost volume and the per-plane
    valid-view counts (H, W, D).

    images: (N, H, W); src_indices: static tuple of source view ids.
    shift_pad: when > 0, use the translation-only fast path — every
    (view, plane) homography is treated as the pure pixel translation
    (H[0,2], H[1,2]) and warping becomes padded dynamic slices + lerp
    (valid for rigs with identical K and R; callers check, see
    ``array_depth_pipeline``). `shift_pad` must bound the largest |shift|.
    depths: optional explicit (D_local,) plane depths — the plane-sharding
    hook (parallel/plane_sweep.py): each ``disp`` mesh shard sweeps its own
    chunk of the inverse-depth samples (planes are independent, so the
    plane axis shards with NO halo); default = the full cfg sample set.
    shifts: optional explicit (S, D, 2) per-view/plane pixel shifts that
    REPLACE the camera-derived :func:`translation_shifts` on the
    translation fast path (requires shift_pad > 0) — the cascade hook
    (models/cascade_sweep.py): band-pre-warped sources sweep residual
    shifts that no camera geometry describes. ``cameras`` is unused then.
    """
    dtype = images.dtype if jnp.issubdtype(images.dtype, jnp.floating) else jnp.float32
    images = images.astype(dtype)
    ref = images[ref_index]
    h, w = ref.shape
    if depths is None:
        depths = inverse_depth_samples(cfg.z_near, cfg.z_far, cfg.num_planes, dtype=dtype)
    if shifts is not None and shift_pad <= 0:
        raise ValueError("explicit shifts require the translation fast path (shift_pad > 0)")
    src = jnp.asarray(src_indices, dtype=jnp.int32)

    ref_census = (
        census_transform(ref, (cfg.patch, cfg.patch)) if cfg.cost == "census" else None
    )
    src_images = images[src]  # (S, H, W)

    if shift_pad > 0:
        pad = shift_pad + 1
        padded = jnp.pad(src_images, ((0, 0), (pad, pad), (pad, pad)))
        # (S, D, 2): (su, sv) per view/plane, in the exact closed form
        if shifts is None:
            shifts = translation_shifts(cameras, ref_index, src, depths)
        v_iota = jax.lax.broadcasted_iota(dtype, (h, w), 0)
        u_iota = jax.lax.broadcasted_iota(dtype, (h, w), 1)

        def per_plane(shift_d):
            def per_view(img_p, s_uv):
                warped = _shift_warp(img_p, s_uv[0], s_uv[1], h, w, pad)
                ok = (
                    (u_iota + s_uv[0] >= 0.0)
                    & (u_iota + s_uv[0] <= w - 1.0)
                    & (v_iota + s_uv[1] >= 0.0)
                    & (v_iota + s_uv[1] <= h - 1.0)
                )
                return warped, ok

            warped, ok = jax.vmap(per_view)(padded, shift_d)  # (S, H, W)
            costs, ceiling = _view_cost(ref, ref_census, warped, ok, cfg, dtype)
            fused = _fuse_views(costs, ok, ceiling, cfg)
            return fused, jnp.sum(ok, axis=0).astype(jnp.int32)

        fused, nviews = _chunked_plane_map(
            per_plane, jnp.swapaxes(shifts, 0, 1), cfg.plane_chunk
        )
    else:
        H_all = cameras.fronto_plane_homography(
            ref_index, src, depths
        )  # (S, D, 3, 3)

        def per_plane(Hs_d):
            # Hs_d: (S, 3, 3) homographies of every source view for this plane
            def per_view(img, Hm):
                warped, ok = homography_warp(img, Hm)
                return warped, ok

            warped, ok = jax.vmap(per_view)(src_images, Hs_d)  # (S, H, W)
            costs, ceiling = _view_cost(ref, ref_census, warped, ok, cfg, dtype)
            fused = _fuse_views(costs, ok, ceiling, cfg)
            return fused, jnp.sum(ok, axis=0).astype(jnp.int32)

        # chunked map over planes bounds peak memory at one (chunk, S, H, W)
        # warp stack while amortizing kernel dispatch across the chunk
        fused, nviews = _chunked_plane_map(
            per_plane, jnp.swapaxes(H_all, 0, 1), cfg.plane_chunk
        )  # (D, H, W)
    vol = jnp.moveaxis(fused, 0, -1)  # (H, W, D)
    nv = jnp.moveaxis(nviews, 0, -1)
    return vol, nv, depths



@functools.partial(
    jax.jit,
    static_argnames=(
        "ref_index", "src_indices", "cfg", "sgm_cfg", "min_views", "backend",
        "shift_pad",
    ),
)
def plane_sweep_depth(
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
) -> PlaneSweepOutput:
    """Full N-view fused depth for the reference view.

    The winning plane is refined by parabola interpolation in *inverse-depth*
    space (planes are uniform in 1/z, so the parabola is well-conditioned).
    Pixels seen by fewer than ``min_views`` sources at their winning plane
    are invalidated (they have no photoconsistency evidence).

    backend: "auto" | "xla" | "pallas" | "pallas_interpret" — how SGM
    aggregation over the plane axis runs (``backend.py``); smoothness over
    the plane index is the same recurrence as disparity smoothness.
    """
    vol, nv, depths = plane_sweep_volume(
        images, cameras, ref_index, src_indices, cfg, shift_pad=shift_pad,
    )
    k, cost, conf, k_int = _volume_to_maps(
        vol, images[ref_index], cfg, sgm_cfg, backend
    )

    inv_near = 1.0 / cfg.z_near
    inv_far = 1.0 / cfg.z_far
    step = (inv_far - inv_near) / max(cfg.num_planes - 1, 1)
    inv_depth = inv_near + k * step
    depth = 1.0 / jnp.maximum(inv_depth, 1e-9)

    d_sel = jax.lax.broadcasted_iota(jnp.int32, nv.shape, nv.ndim - 1)
    views_at_win = jnp.sum(
        jnp.where(d_sel == k_int[..., None], nv, 0), axis=-1
    )
    valid = views_at_win >= min_views
    if mask is not None:
        valid = valid & mask
    depth = jnp.where(valid, depth, 0.0)
    return PlaneSweepOutput(
        depth=depth, plane=k, cost=cost, valid=valid, num_views=views_at_win,
        confidence=jnp.where(valid, conf, 0.0),
    )


def _volume_to_maps(
    vol: jnp.ndarray,
    ref_image: jnp.ndarray,
    cfg: PlaneSweepConfig,
    sgm_cfg: Optional[SGMConfig],
    backend: str,
) -> tuple:
    """(H, W, D) fused cost volume -> per-pixel winner maps.

    SGM aggregation over the plane axis + WTA + subpixel parabola +
    PKRN confidence, SGM on the requested backend. Returns
    ``(k, cost, conf, k_int)`` with ``k`` the fractional winning plane
    index. Shared by :func:`plane_sweep_depth` and the cascade fine pass
    (models/cascade_sweep.py), which decode plane indices differently.
    """
    if sgm_cfg is not None:
        vol = sgm_aggregate(
            vol,
            p1=sgm_cfg.p1,
            p2=sgm_cfg.p2,
            num_paths=sgm_cfg.num_paths,
            image=ref_image,
            adaptive_p2=sgm_cfg.adaptive_p2,
            p2_min=sgm_cfg.p2_min,
            backend=resolve_backend(backend),
        )
    k_int, cost = winner_take_all(vol)
    k = subpixel_refine(vol, k_int)  # fractional plane index
    conf = confidence_from_volume(vol, k_int)
    return k, cost, conf, k_int
