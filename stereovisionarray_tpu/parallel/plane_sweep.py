"""Mesh-sharded N-view plane-sweep depth — BASELINE.json config 3 at
multi-device scale (VERDICT r1 item 7: config 3 previously had no sharded
implementation).

Sharding map (generalizing ``/root/reference/src/functions.cpp:55-103`` —
the per-pair perspective-shift warps):

  data axis — frame-sets (B): embarrassingly parallel;
  disp axis — depth PLANES: each shard sweeps its own chunk of the
      inverse-depth samples (planes are mutually independent, so the sweep
      phase shards with NO communication at all), all-gathers fused cost
      chunks along the plane axis, then aggregates a disjoint subset of SGM
      paths combined with one ``psum`` (path parallelism, exactly the
      two-view pattern in ``parallel/two_view.py``);
  tile axis — must be 1 here: the sweep's vertical warp shifts make row
      halos depend on the depth range; tile-shard the TWO-VIEW pipeline
      instead when rows must scale.

Views are replicated (a frame-set is small vs the cost volume; top-k view
fusion is not psum-decomposable, so view sharding would force mean fusion).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from stereovisionarray_tpu.config import PlaneSweepConfig, SGMConfig
from stereovisionarray_tpu.geometry.camera import CameraArray
from stereovisionarray_tpu.geometry.epipolar import inverse_depth_samples
from stereovisionarray_tpu.models.plane_sweep import (
    PlaneSweepOutput,
    plane_sweep_volume,
)
from stereovisionarray_tpu.backend import resolve_backend
from stereovisionarray_tpu.ops.sgm import sgm_aggregate_paths
from stereovisionarray_tpu.ops.wta import subpixel_refine, winner_take_all
from stereovisionarray_tpu.parallel.mesh import AXIS_DATA, AXIS_DISP, AXIS_TILE
from stereovisionarray_tpu.parallel.two_view import _split_paths


@functools.lru_cache(maxsize=32)
def _plane_sweep_program(
    mesh: Mesh,
    ref_index: int,
    src_indices: tuple,
    cfg: PlaneSweepConfig,
    sgm_cfg: Optional[SGMConfig],
    min_views: int,
    shift_pad: int,
    backend: str,
    B: int,
    N: int,
    H: int,
    W: int,
):
    """Build (and cache) the jitted shard_map program — a fresh shard_map
    closure per call would re-trace and re-compile every invocation (see
    ``parallel.two_view._two_view_program``). Cameras are a runtime
    argument (replicated pytree), not a cache key — jnp leaves aren't
    hashable and shouldn't bust the cache anyway."""
    n_data = mesh.shape[AXIS_DATA]
    n_tile = mesh.shape[AXIS_TILE]
    n_disp = mesh.shape[AXIS_DISP]
    D = cfg.num_planes
    if n_tile != 1:
        raise ValueError(
            "sharded plane sweep shards (data, planes); tile axis must be 1 "
            f"(got {n_tile})"
        )
    if B % n_data or D % n_disp:
        raise ValueError(
            f"shapes (B={B}, planes={D}) not divisible by mesh "
            f"({n_data}, {n_disp})"
        )
    d_local = D // n_disp
    path_chunks = (
        _split_paths(sgm_cfg.num_paths, n_disp) if sgm_cfg is not None else None
    )

    inv_near = 1.0 / cfg.z_near
    inv_far = 1.0 / cfg.z_far
    step = (inv_far - inv_near) / max(D - 1, 1)

    def _one_set(imgs: jnp.ndarray, cameras, disp_idx) -> tuple:
        # imgs: (N, H, W) one frame-set, replicated over the disp axis
        depths_all = inverse_depth_samples(cfg.z_near, cfg.z_far, D, dtype=imgs.dtype)
        depths_loc = lax.dynamic_slice(depths_all, (disp_idx * d_local,), (d_local,))
        vol, nv, _ = plane_sweep_volume(
            imgs, cameras, ref_index, src_indices, cfg,
            shift_pad=shift_pad, depths=depths_loc,
        )
        if n_disp > 1:
            vol = lax.all_gather(vol, AXIS_DISP, axis=-1, tiled=True)
            nv = lax.all_gather(nv, AXIS_DISP, axis=-1, tiled=True)

        if sgm_cfg is not None:
            sgm_kwargs = dict(
                p1=sgm_cfg.p1,
                p2=sgm_cfg.p2,
                image=imgs[ref_index],
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
        k = subpixel_refine(vol, k_int)
        inv_depth = inv_near + k * step
        depth = 1.0 / jnp.maximum(inv_depth, 1e-9)
        d_sel = jax.lax.broadcasted_iota(jnp.int32, nv.shape, nv.ndim - 1)
        views_at_win = jnp.sum(
            jnp.where(d_sel == k_int[..., None], nv, 0), axis=-1
        )
        valid = views_at_win >= min_views
        depth = jnp.where(valid, depth, 0.0)
        from stereovisionarray_tpu.ops.confidence import confidence_from_volume

        conf = jnp.where(valid, confidence_from_volume(vol, k_int), 0.0)
        return depth, k, cost, valid, views_at_win, conf

    def _local(imgs: jnp.ndarray, cameras) -> tuple:
        disp_idx = lax.axis_index(AXIS_DISP)
        return jax.vmap(lambda x: _one_set(x, cameras, disp_idx))(imgs)

    spec_in = P(AXIS_DATA, None, None, None)
    spec_out = P(AXIS_DATA, None, None)
    sharded = jax.shard_map(
        _local,
        mesh=mesh,
        in_specs=(spec_in, P()),  # cameras: replicated pytree
        out_specs=(spec_out,) * 6,
        check_vma=False,
    )
    return jax.jit(sharded), spec_in


def sharded_plane_sweep_depth(
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
) -> PlaneSweepOutput:
    """Batched, mesh-sharded ``models.plane_sweep.plane_sweep_depth``.

    images: (B, N, H, W) frame-sets; B divisible by the data axis,
    cfg.num_planes by the disp axis; the disp axis must divide
    sgm_cfg.num_paths (or sgm_cfg be None); tile axis must be 1.

    The compiled program is cached per (mesh, configs, shapes); repeat
    calls skip tracing entirely (cameras are a runtime argument).

    backend: SGM backend (``backend.py``): "auto" runs the Triton path
    kernel on a GPU and the XLA scans on the CPU.

    Returns PlaneSweepOutput of (B, H, W) maps sharded along data.
    """
    B, N, H, W = images.shape
    program, spec_in = _plane_sweep_program(
        mesh, ref_index, tuple(src_indices), cfg, sgm_cfg,
        int(min_views), int(shift_pad), str(backend), B, N, H, W,
    )
    images = jax.device_put(
        images.astype(jnp.float32), NamedSharding(mesh, spec_in)
    )
    depth, k, cost, valid, nviews, conf = program(images, cameras)
    return PlaneSweepOutput(
        depth=depth, plane=k, cost=cost, valid=valid, num_views=nviews,
        confidence=conf,
    )
