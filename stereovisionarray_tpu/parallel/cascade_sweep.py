"""Mesh-sharded cascade plane sweep — the coarse-to-fine array pipeline
(models/cascade_sweep.py) composed with the multi-chip architecture.

Sharding map (the ``parallel/plane_sweep.py`` pattern applied to the
cascade's structure):

  data axis — frame-sets (B): embarrassingly parallel;
  disp axis — FINE planes: the banded fine sweep's planes are mutually
      independent exactly like the flat sweep's (per-pixel band pre-warps
      are plane-agnostic), so each shard sweeps its chunk of the residual
      shifts with NO communication, all-gathers fused cost chunks along
      the plane axis, then aggregates a disjoint subset of SGM paths
      combined with one ``psum``;
  tile axis — must be 1 (see parallel/plane_sweep.py).

The coarse pass + band field + pre-warp replicate across the disp axis:
at coarse_factor 4 they are ~10% of the fine sweep's work, and
replicating them costs no communication (every shard derives the same
band field deterministically from the replicated frame-set).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from stereovisionarray_tpu.config import PlaneSweepConfig, SGMConfig
from stereovisionarray_tpu.geometry.camera import CameraArray
from stereovisionarray_tpu.models.cascade_sweep import _coarse_band_prewarp
from stereovisionarray_tpu.models.plane_sweep import (
    PlaneSweepOutput,
    plane_sweep_volume,
)
from stereovisionarray_tpu.backend import resolve_backend
from stereovisionarray_tpu.ops.sgm import sgm_aggregate_paths
from stereovisionarray_tpu.ops.wta import subpixel_refine, winner_take_all
from stereovisionarray_tpu.parallel.mesh import AXIS_DATA, AXIS_DISP, AXIS_TILE
from stereovisionarray_tpu.parallel.two_view import _split_paths

__all__ = ["sharded_cascade_sweep_depth"]


@functools.lru_cache(maxsize=32)
def _cascade_program(
    mesh: Mesh,
    ref_index: int,
    src_indices: tuple,
    cfg: PlaneSweepConfig,
    sgm_cfg: Optional[SGMConfig],
    min_views: int,
    shift_pad: int,
    backend: str,
    coarse_factor: int,
    fine_planes: int,
    band_step: int,
    band_offsets: Optional[tuple],
    mode: str,
    B: int,
    N: int,
    H: int,
    W: int,
):
    n_data = mesh.shape[AXIS_DATA]
    n_tile = mesh.shape[AXIS_TILE]
    n_disp = mesh.shape[AXIS_DISP]
    df = int(fine_planes)
    if n_tile != 1:
        raise ValueError(
            f"sharded cascade shards (data, fine planes); tile axis must be 1 "
            f"(got {n_tile})"
        )
    if B % n_data or df % n_disp:
        raise ValueError(
            f"shapes (B={B}, fine_planes={df}) not divisible by mesh "
            f"({n_data}, {n_disp})"
        )
    df_local = df // n_disp
    path_chunks = (
        _split_paths(sgm_cfg.num_paths, n_disp) if sgm_cfg is not None else None
    )
    total = int(cfg.num_planes)
    inv_near = 1.0 / cfg.z_near
    step = (1.0 / cfg.z_far - inv_near) / max(total - 1, 1)
    n_src = len(src_indices)

    def _one_set(imgs: jnp.ndarray, cameras, disp_idx) -> tuple:
        wsrc, offset, a, c, depths_full = _coarse_band_prewarp(
            imgs, cameras, ref_index, src_indices, cfg, sgm_cfg,
            min_views=min_views, backend=backend, shift_pad=shift_pad,
            coarse_factor=coarse_factor, fine_planes=df, band_step=band_step,
            band_offsets=band_offsets, mode=mode,
        )
        dtype = wsrc.dtype
        ref = imgs.astype(dtype)[ref_index]

        # local chunk of the residual fine shifts: planes are independent,
        # so the fine sweep shards with zero communication
        j = (disp_idx * df_local + jnp.arange(df_local)).astype(dtype)
        fine_shifts = c[:, None, :] * j[None, :, None]  # (S, df_local, 2)
        cfg_f = dataclasses.replace(cfg, num_planes=df)
        depths_loc = lax.dynamic_slice(
            depths_full, (disp_idx * df_local,), (df_local,)
        )
        vol, _, _ = plane_sweep_volume(
            jnp.concatenate([ref[None], wsrc], axis=0),
            cameras,  # unused: explicit shifts
            0,
            tuple(range(1, n_src + 1)),
            cfg_f,
            shift_pad=shift_pad,
            depths=depths_loc,
            shifts=fine_shifts,
        )
        if n_disp > 1:
            vol = lax.all_gather(vol, AXIS_DISP, axis=-1, tiled=True)

        if sgm_cfg is not None:
            sgm_kwargs = dict(
                p1=sgm_cfg.p1,
                p2=sgm_cfg.p2,
                image=ref,
                adaptive_p2=sgm_cfg.adaptive_p2,
                p2_min=sgm_cfg.p2_min,
                backend=resolve_backend(backend),
            )
            if n_disp == 1:
                vol = sgm_aggregate_paths(vol, path_ids=path_chunks[0], **sgm_kwargs)
            else:
                branches = [
                    functools.partial(sgm_aggregate_paths, path_ids=chunk, **sgm_kwargs)
                    for chunk in path_chunks
                ]
                vol = lax.psum(lax.switch(disp_idx, branches, vol), AXIS_DISP)

        k_int, cost = winner_take_all(vol)
        k_f = subpixel_refine(vol, k_int)
        k_full = k_f + offset
        depth = 1.0 / jnp.maximum(inv_near + k_full * step, 1e-9)

        # true per-view visibility in the ORIGINAL frame (the fine volume
        # only saw residual shifts) — models/cascade_sweep.py decode
        u_iota = lax.broadcasted_iota(dtype, (H, W), 1)
        v_iota = lax.broadcasted_iota(dtype, (H, W), 0)
        pu = u_iota[None] + a[:, 0, None, None] + c[:, 0, None, None] * k_full[None]
        pv = v_iota[None] + a[:, 1, None, None] + c[:, 1, None, None] * k_full[None]
        ok = (pu >= 0.0) & (pu <= W - 1.0) & (pv >= 0.0) & (pv <= H - 1.0)
        views_at_win = jnp.sum(ok, axis=0).astype(jnp.int32)
        valid = views_at_win >= min_views
        depth = jnp.where(valid, depth, 0.0)
        from stereovisionarray_tpu.ops.confidence import confidence_from_volume

        conf = jnp.where(valid, confidence_from_volume(vol, k_int), 0.0)
        return depth, k_full, cost, valid, views_at_win, conf

    def _local(imgs: jnp.ndarray, cameras) -> tuple:
        disp_idx = lax.axis_index(AXIS_DISP)
        return jax.vmap(lambda x: _one_set(x, cameras, disp_idx))(imgs)

    spec_in = P(AXIS_DATA, None, None, None)
    spec_out = P(AXIS_DATA, None, None)
    sharded = jax.shard_map(
        _local,
        mesh=mesh,
        in_specs=(spec_in, P()),
        out_specs=(spec_out,) * 6,
        check_vma=False,
    )
    return jax.jit(sharded), spec_in


def sharded_cascade_sweep_depth(
    images: jnp.ndarray,
    cameras: CameraArray,
    ref_index: int,
    src_indices: tuple,
    mesh: Mesh,
    cfg: PlaneSweepConfig = PlaneSweepConfig(),
    sgm_cfg: Optional[SGMConfig] = SGMConfig(lr_max_diff=0.0),
    min_views: int = 2,
    shift_pad: int = 0,
    backend: str = "auto",
    coarse_factor: int = 4,
    fine_planes: int = 48,
    band_step: int = 8,
    band_offsets: Optional[tuple] = None,
    mode: str = "smooth",
) -> PlaneSweepOutput:
    """Batched, mesh-sharded ``cascade_plane_sweep_depth``.

    images: (B, N, H, W) frame-sets; B divisible by the data axis,
    ``fine_planes`` by the disp axis; the disp axis must divide
    sgm_cfg.num_paths (or sgm_cfg be None); tile axis must be 1.
    ``shift_pad > 0`` required (translation-only rigs, as single-chip).

    Returns PlaneSweepOutput of (B, H, W) maps sharded along data.
    """
    if shift_pad <= 0:
        raise ValueError("sharded cascade requires the translation fast "
                         "path (shift_pad > 0)")
    B, N, H, W = images.shape
    program, spec_in = _cascade_program(
        mesh, ref_index, tuple(src_indices), cfg, sgm_cfg, int(min_views),
        int(shift_pad), str(backend), int(coarse_factor), int(fine_planes),
        int(band_step),
        tuple(band_offsets) if band_offsets is not None else None,
        str(mode), B, N, H, W,
    )
    images = jax.device_put(
        images.astype(jnp.float32), NamedSharding(mesh, spec_in)
    )
    depth, k, cost, valid, nviews, conf = program(images, cameras)
    return PlaneSweepOutput(
        depth=depth, plane=k, cost=cost, valid=valid, num_views=nviews,
        confidence=conf,
    )
