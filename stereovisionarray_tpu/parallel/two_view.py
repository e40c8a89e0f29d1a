"""Sharded two-view SGM pipeline over a (data, tile, disp) mesh.

The multi-device realization of BASELINE.json config 5's stereo half
("disparity-sharded cost volume"), replacing the reference's single-threaded
pixel loop (``/root/reference/src/CameraStereoVision.cpp:49-95``) with:

  data axis — batch of stereo pairs, embarrassingly parallel;
  tile axis — image rows, coupled only through ``halo`` boundary rows
      exchanged once via ``ppermute`` (vertical/diagonal SGM paths are
      truncated at the halo depth; the min-normalized SGM recurrence forgets
      its carry geometrically, so a few dozen rows of halo reproduce the
      unsharded result to float tolerance — verified by
      tests/test_parallel.py);
  disp axis — each shard builds its own D-chunk of the cost volume
      (``d_offset``), all-gathers chunks along D, then aggregates a disjoint
      *subset of SGM paths* (path parallelism — total = sum over 8
      independent paths) combined with one ``psum``.

All collectives (ppermute / all_gather / psum) are compiler-scheduled
(NCCL over NVLink on a GPU host) — no hand-written communication backend
(SURVEY.md §2.2 P6).

SGM aggregation runs on the ``backend`` of ``backend.py`` (the Triton path
kernel on a GPU) in halo mode; exact tile mode relays XLA scan carries.
Integer (fixed-point) costs aggregate to exact int32 sums, so the psum over
path subsets and the carry relay reproduce the single-device sums exactly.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from stereovisionarray_tpu.config import CostConfig, SGMConfig
from stereovisionarray_tpu.models.two_view import (
    TwoViewOutput,
    aggregate_costs,
    cost_dtype,
    cost_units,
    disparity_to_depth,
    sgm_penalties,
)
from stereovisionarray_tpu.ops.cost_volume import (
    fused_cost_volume,
    right_from_left_volume,
)
from stereovisionarray_tpu.ops.sgm import (
    ALL_PATH_IDS,
    _edge_p2,
    _scan_along_axis0,
    scan_with_carry,
)
from stereovisionarray_tpu.ops.wta import disparity_from_volume, winner_take_all
from stereovisionarray_tpu.parallel.halo import (
    crop_halo,
    exchange_halo,
    mask_out_of_image,
)
from stereovisionarray_tpu.parallel.mesh import AXIS_DATA, AXIS_DISP, AXIS_TILE

# Uniform cost assigned to out-of-image halo rows: any constant works (the
# SGM recurrence renormalizes a uniform carry to a fresh start); zero keeps
# the volume's dynamic range.
_OOB_COST = 0.0


def _split_paths(num_paths: int, n_disp: int) -> list:
    """Disjoint path-id chunks, one per disp shard."""
    ids = ALL_PATH_IDS[:num_paths]
    if num_paths % n_disp != 0:
        raise ValueError(
            f"disp mesh axis ({n_disp}) must divide num_paths ({num_paths}) "
            "for path-parallel SGM"
        )
    k = num_paths // n_disp
    return [tuple(ids[i * k : (i + 1) * k]) for i in range(n_disp)]


from stereovisionarray_tpu.backend import (
    resolve_backend as _resolve_parallel_backend,
)


from stereovisionarray_tpu.ops.sgm import _BIG as _BIGF  # fresh-start carry
# sentinel — the relay's bit-for-bit exactness claim REQUIRES the same
# constant as the single-device scans, so import it rather than re-declare

# path id -> (reverse, diag_shift) for the vertical/diagonal paths that cross
# tile-shard boundaries (ids per ops.sgm.ALL_PATH_IDS)
_VERTICAL_PATHS = {0: (False, 0), 1: (True, 0), 4: (False, +1), 5: (False, -1),
                   6: (True, +1), 7: (True, -1)}


def _relay_scan(vol, p2_row, p1, diag_shift, reverse, n_tile):
    """EXACT vertical SGM path over tile-sharded rows: a K-round sequential
    relay of the (W, D) wavefront via ppermute (SURVEY.md §7 'hard parts';
    VERDICT r1 item 4). Round k computes shard k's local scan seeded with
    shard k-1's final front; only the round matching this shard's position in
    the scan order is kept. Work is K x local-rows per shard (the vertical
    paths don't scale with tile sharding — the price of bit-exactness; the
    horizontal paths, cost build and extraction still do)."""
    v = jnp.flip(vol, 0) if reverse else vol
    p = jnp.flip(p2_row, 0) if reverse else p2_row
    my = lax.axis_index(AXIS_TILE)
    pos = (n_tile - 1 - my) if reverse else my  # my position in scan order
    if reverse:
        src_dst = [(i, i - 1) for i in range(1, n_tile)]
    else:
        src_dst = [(i, i + 1) for i in range(n_tile - 1)]
    big = jnp.full(v.shape[1:], jnp.asarray(_BIGF, v.dtype))

    def body(k, state):
        incoming, out = state
        rows, final = scan_with_carry(v, p1, p, diag_shift, init_carry=incoming)
        out = jnp.where(pos == k, rows, out)
        nxt = lax.ppermute(final, AXIS_TILE, src_dst)
        return nxt, out

    _, out = lax.fori_loop(0, n_tile, body, (big, jnp.zeros_like(v)))
    return jnp.flip(out, 0) if reverse else out


def _sgm_aggregate_exact(vol, p2_y, p2_x, p1, path_ids, n_tile):
    """Path-subset SGM aggregation on LOCAL rows (h_local, W, D) with exact
    cross-shard carries: vertical/diagonal paths relay their wavefront
    (:func:`_relay_scan`); horizontal paths scan complete local rows. Path
    order matches ``ops.sgm.sgm_aggregate_paths`` so the f32 accumulation
    order (and hence the bits) match the unsharded aggregate."""
    p1 = jnp.asarray(p1, vol.dtype)
    total = jnp.zeros_like(vol)
    for pid in path_ids:
        if pid in _VERTICAL_PATHS:
            reverse, diag = _VERTICAL_PATHS[pid]
            total += _relay_scan(vol, p2_y, p1, diag, reverse, n_tile)
        elif pid == 2:  # left -> right: complete rows, no shard coupling
            vol_t = jnp.swapaxes(vol, 0, 1)
            total += jnp.swapaxes(
                _scan_along_axis0(vol_t, p1, None, 0, p2_row=jnp.swapaxes(p2_x, 0, 1)),
                0, 1,
            )
        elif pid == 3:  # right -> left
            vol_t = jnp.flip(jnp.swapaxes(vol, 0, 1), 0)
            p2_t = jnp.flip(jnp.swapaxes(p2_x, 0, 1), 0)
            total += jnp.swapaxes(
                jnp.flip(_scan_along_axis0(vol_t, p1, None, 0, p2_row=p2_t), 0), 0, 1
            )
        else:
            raise ValueError(f"unknown SGM path id {pid}")
    return total


@functools.lru_cache(maxsize=64)
def _two_view_program(
    mesh: Mesh,
    cost_cfg: CostConfig,
    sgm_cfg: SGMConfig,
    halo: int,
    resolved: str,
    tile_mode: str,
    B: int,
    H: int,
    W: int,
):
    """Build (and cache) the jitted shard_map program for one
    (mesh, configs, shapes) combination.

    Rebuilding the shard_map closure per call would RE-TRACE AND RE-COMPILE
    on every invocation (a fresh Python callable defeats jax's jit cache) —
    measured minutes per call on the CPU mesh. The cache key is all static
    configuration; the returned program takes already-sharded (left, right)
    and returns (disparity, valid, cost)."""
    n_data = mesh.shape[AXIS_DATA]
    n_tile = mesh.shape[AXIS_TILE]
    n_disp = mesh.shape[AXIS_DISP]
    D = cost_cfg.num_disparities
    if B % n_data or H % n_tile or D % n_disp:
        raise ValueError(
            f"shapes (B={B}, H={H}, D={D}) not divisible by mesh "
            f"({n_data}, {n_tile}, {n_disp})"
        )
    d_local = D // n_disp
    exact_tiles = tile_mode == "exact" and n_tile > 1
    if exact_tiles and n_disp > 1:
        # path-parallel chunks contain UNEVEN numbers of vertical paths
        # (e.g. {0,1,2,3} has 2 relays, {4,5,6,7} has 4): disp shards would
        # execute different collective-permute counts inside lax.switch and
        # deadlock the mesh. Fold those devices into data/tile instead.
        raise ValueError(
            "tile_mode='exact' requires a disp axis of 1 (relay collectives "
            f"cannot sit inside uneven switch branches; got disp={n_disp})"
        )
    dtype = cost_dtype(cost_cfg)
    path_chunks = _split_paths(sgm_cfg.num_paths, n_disp)
    if exact_tiles:
        # exact mode needs only the census half-window of image rows to make
        # boundary COSTS exact (census pads edge-mode, exactly what
        # exchange_halo's edge fill reproduces at the global border); SGM
        # carries cross shards via the relay, not the halo
        use_halo = min(max(cost_cfg.census_window[0] // 2, 1), H // n_tile)
    else:
        # cap at full coverage: (n_tile-1) blocks reconstructs every row of
        # the global image on each shard (exchange_halo relays multi-hop
        # when the halo spans several blocks), making halo-mode SGM
        # bit-exact at any tile count
        use_halo = min(halo, H - H // n_tile) if n_tile > 1 else 0

    def _one_pair_exact(l_ext: jnp.ndarray, r_ext: jnp.ndarray, disp_idx) -> tuple:
        """Exact tile sharding: cost on the (small) halo-extended rows, crop
        to local rows, then carry-relay SGM + local extraction."""
        vol = fused_cost_volume(
            l_ext,
            r_ext,
            d_local,
            census_window=cost_cfg.census_window,
            bt_weight=cost_cfg.bt_weight,
            bt_clip=cost_cfg.bt_clip,
            dtype=dtype,
            d_offset=disp_idx * d_local,
        )
        # n_disp == 1 here by construction — _two_view_program rejects
        # tile_mode='exact' with a disp axis (relay collectives inside
        # uneven switch branches would deadlock the mesh), so no all_gather
        vol = crop_halo(vol, use_halo, axis=0)

        # the relay scans in float32, as sgm_aggregate_paths' XLA path:
        # integer costs and their rounded penalties are exact there
        integer = jnp.issubdtype(dtype, jnp.integer)
        pens = sgm_penalties(sgm_cfg, dtype)
        map_dtype = jnp.int32 if integer else dtype
        if sgm_cfg.adaptive_p2:
            # gradients of the halo-extended rows == global gradients on
            # the kept rows
            p2_y, p2_x = (
                crop_halo(_edge_p2(l_ext, ax, pens["p2"], pens["p2_min"], map_dtype),
                          use_halo, axis=0)
                for ax in (0, 1)
            )
        else:
            p2_y = jnp.full((vol.shape[0], W), pens["p2"], map_dtype)
            p2_x = p2_y
        agg = _sgm_aggregate_exact(
            vol.astype(jnp.float32), p2_y.astype(jnp.float32)[..., None],
            p2_x.astype(jnp.float32)[..., None], pens["p1"], path_chunks[0],
            n_tile,
        )
        if integer:
            agg = agg.astype(jnp.int32)
        return _extract(cost_units(agg, dtype))

    def _one_pair(l_ext: jnp.ndarray, r_ext: jnp.ndarray, disp_idx) -> tuple:
        """Pipeline on one halo-extended (h_ext, W) pair; disp_idx traced."""
        vol = fused_cost_volume(
            l_ext,
            r_ext,
            d_local,
            census_window=cost_cfg.census_window,
            bt_weight=cost_cfg.bt_weight,
            bt_clip=cost_cfg.bt_clip,
            dtype=dtype,
            d_offset=disp_idx * d_local,
        )
        if n_disp > 1:
            vol = lax.all_gather(vol, AXIS_DISP, axis=-1, tiled=True)
        vol = mask_out_of_image(vol, use_halo, AXIS_TILE, axis=0, fill_value=_OOB_COST)

        branches = [
            functools.partial(aggregate_costs, image=l_ext, sgm_cfg=sgm_cfg,
                              path_ids=chunk, backend=resolved)
            for chunk in path_chunks
        ]
        if n_disp == 1:
            agg = branches[0](vol)
        else:
            agg = lax.psum(lax.switch(disp_idx, branches, vol), AXIS_DISP)
        return _extract(cost_units(agg, dtype))

    def _extract(agg: jnp.ndarray) -> tuple:
        vol_right = right_from_left_volume(agg) if sgm_cfg.lr_max_diff > 0 else None
        res = disparity_from_volume(
            agg,
            vol_right=vol_right,
            subpixel=sgm_cfg.subpixel,
            uniqueness=sgm_cfg.uniqueness,
            lr_max_diff=sgm_cfg.lr_max_diff,
            with_confidence=True,
        )
        return res.disparity, res.valid, res.cost, res.confidence

    one_pair = _one_pair_exact if exact_tiles else _one_pair

    def _local(l: jnp.ndarray, r: jnp.ndarray) -> tuple:
        # l, r: (b_local, h_local, W)
        disp_idx = lax.axis_index(AXIS_DISP)
        if use_halo > 0:
            l = exchange_halo(l, use_halo, AXIS_TILE, axis=1, edge_mode="edge")
            r = exchange_halo(r, use_halo, AXIS_TILE, axis=1, edge_mode="edge")
        d, v, c, cf = jax.vmap(lambda a, b: one_pair(a, b, disp_idx))(l, r)
        if use_halo > 0 and not exact_tiles:  # exact mode crops internally
            d = crop_halo(d, use_halo, axis=1)
            v = crop_halo(v, use_halo, axis=1)
            c = crop_halo(c, use_halo, axis=1)
            cf = crop_halo(cf, use_halo, axis=1)
        return d, v, c, cf

    spec_in = P(AXIS_DATA, AXIS_TILE, None)
    sharded = jax.shard_map(
        _local,
        mesh=mesh,
        in_specs=(spec_in, spec_in),
        out_specs=(spec_in, spec_in, spec_in, spec_in),
        check_vma=False,
    )
    return jax.jit(sharded), spec_in


def sharded_two_view_disparity(
    left: jnp.ndarray,
    right: jnp.ndarray,
    mesh: Mesh,
    cost_cfg: CostConfig = CostConfig(),
    sgm_cfg: SGMConfig = SGMConfig(),
    halo: int = 48,
    mask: Optional[jnp.ndarray] = None,
    baseline: Optional[float] = None,
    focal_px: Optional[float] = None,
    backend: str = "auto",
    tile_mode: str = "halo",
) -> TwoViewOutput:
    """Batched, mesh-sharded version of ``models.two_view.two_view_disparity``.

    left/right: (B, H, W) with B divisible by the data axis and H by the
    tile axis; the D axis (cost_cfg.num_disparities) must be divisible by
    the disp axis, and the disp axis must divide sgm_cfg.num_paths (xla
    backend) / be in {1, 2, 4} (pallas backend, sweep granularity).

    tile_mode: how vertical SGM paths handle the tile-shard boundary —
      "halo"  (default): truncate path history at `halo` exchanged rows; an
              approximation that scales linearly (the SGM recurrence forgets
              its carry geometrically, so a few dozen rows suffice in
              practice — see tests);
      "exact": relay the (W, D) wavefront between shards via a sequential
              ppermute chain (:func:`_relay_scan`) — bit-identical to the
              unsharded result at ANY tile count, at the cost of the
              vertical sweeps serializing across shards (XLA scans on
              every backend).

    The compiled program is cached per (mesh, configs, shapes) — repeat
    calls skip tracing entirely (:func:`_two_view_program`).

    Returns a TwoViewOutput of (B, H, W) maps, sharded (data, tile).
    """
    B, H, W = left.shape
    if tile_mode not in ("halo", "exact"):
        raise ValueError(f"unknown tile_mode {tile_mode!r}")
    resolved = _resolve_parallel_backend(backend)
    program, spec_in = _two_view_program(
        mesh, cost_cfg, sgm_cfg, int(halo), resolved, tile_mode, B, H, W
    )
    left = jax.device_put(left.astype(jnp.float32), NamedSharding(mesh, spec_in))
    right = jax.device_put(right.astype(jnp.float32), NamedSharding(mesh, spec_in))
    disp, valid, cost, conf = program(left, right)
    if mask is not None:
        valid = valid & mask
        disp = jnp.where(valid, disp, -1.0)
    conf = jnp.where(valid, conf, 0.0)
    depth = None
    if baseline is not None and focal_px is not None:
        depth = jnp.where(valid, disparity_to_depth(disp, baseline, focal_px), 0.0)
    return TwoViewOutput(disparity=disp, valid=valid, cost=cost, depth=depth,
                         confidence=conf)


def sharded_wta(
    vol: jnp.ndarray, mesh: Mesh
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Disparity-sharded winner-take-all — the min-reduce collective pattern
    (SURVEY.md §5 "long-context" analogue) usable standalone when no SGM
    aggregation is wanted (the reference's raw-WTA mode,
    ``/root/reference/src/CameraStereoVision.cpp:85``).

    vol: (H, W, D) sharded P(tile, None, disp). Each shard takes the argmin
    of its D-chunk; per-shard (min, argmin) pairs are all-gathered (n_disp
    scalars per pixel — tiny vs the volume) and reduced. Tie-break matches
    the unsharded argmin (lowest d wins).

    Returns (disparity int32 (H, W), cost (H, W)) sharded P(tile, None).
    """
    n_disp = mesh.shape[AXIS_DISP]
    d_local = vol.shape[-1] // n_disp

    def _local(v):
        d0 = lax.axis_index(AXIS_DISP) * d_local
        d_loc, c_loc = winner_take_all(v)
        d_glob = d_loc + d0
        cs = lax.all_gather(c_loc, AXIS_DISP)  # (n_disp, h, w) in d order
        ds = lax.all_gather(d_glob, AXIS_DISP)
        k = jnp.argmin(cs, axis=0)
        # one-hot select over the tiny shard axis
        sel = jax.lax.broadcasted_iota(jnp.int32, cs.shape, 0) == k[None]
        best_c = jnp.sum(jnp.where(sel, cs, 0), axis=0)
        best_d = jnp.sum(jnp.where(sel, ds, 0), axis=0)
        return best_d, best_c

    return jax.shard_map(
        _local,
        mesh=mesh,
        in_specs=P(AXIS_TILE, None, AXIS_DISP),
        out_specs=(P(AXIS_TILE, None), P(AXIS_TILE, None)),
        check_vma=False,
    )(vol)
