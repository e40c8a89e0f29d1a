"""SGM path aggregation as a Pallas kernel through Triton (NVIDIA GPUs).

The recurrence is ``ops/sgm.py``'s; this module only changes how one path
is walked. One ``pallas_call`` runs one path direction:

- a program owns ``block`` lanes and the whole disparity range (padded to
  a power of two) and walks the scan axis inside the kernel with
  ``lax.fori_loop``, so a 540-row path is one launch, not 540 loop
  iterations of XLA kernels;
- lanes are image columns for the row-scanning paths (down, up and the
  four diagonals) and image rows for the column-scanning paths; the
  column-scanning paths read strided rows, so no transposed copy of the
  volume is made;
- a diagonal path skews its lanes by one column per step and wraps at the
  image edge: lane ``l`` reads column ``(l +- s) mod W`` at step ``s``. A
  lane that wraps has reached the start of another diagonal, so it starts
  afresh there (``L = C``), which is the value ``_scan_along_axis0``'s
  shifted-in border carry (BIG) produces. Every lane does useful work at
  every step;
- the carry's ``d -+ 1`` neighbours are read back through a two-slot
  scratch buffer per program in device memory (Triton has no register
  shuffle along a tensor axis). A block barrier orders each step's store
  before the next step's loads; alternating slots keep one step's loads
  clear of the next step's store. The loads are volatile so the compiler
  cannot hoist them above the barrier.

Paths chain through ``input_output_aliases``: path ``k`` adds its ``L`` to
the running total in place, in path-id order, which is the float32
summation order of ``sgm_aggregate_paths`` (so float32 results agree bit
for bit). Integer volumes (int8/int16) run an int32 carry and an int32
sum, which is exact.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["aggregate_paths", "launch_params"]

# path id (ops.sgm.ALL_PATH_IDS) -> (scan axis, reverse, diagonal shift).
# Axis 0 scans rows (lanes are columns), axis 1 scans columns.
_PATHS = {
    0: (0, False, 0), 1: (0, True, 0), 2: (1, False, 0), 3: (1, True, 0),
    4: (0, False, 1), 5: (0, False, -1), 6: (0, True, 1), 7: (0, True, -1),
}


def _next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def _big(dtype):
    """Carry value that never wins a min (the fresh-start sentinel of
    ``ops/sgm.py``; 2**29 leaves int32 room for the penalties)."""
    if jnp.issubdtype(dtype, jnp.integer):
        return 1 << 29
    return 1e9


def launch_params(d_pad: int) -> tuple:
    """(block lanes, warps) for a padded disparity range ``d_pad``.

    One lane per program and one warp per 128 disparities: the step is
    latency-bound (scratch round trip + barrier), so many small programs
    resident on each SM beat wide ones. Measured on an H200 at 540x768x64,
    270x360x128 and 1080x1536x128 against blocks of 2-8 lanes with 1-4
    warps (see PERF.md)."""
    return 1, max(1, min(8, d_pad // 128))


def _path_kernel(*refs, h, w, d, dp, block, axis, reverse, shift, accumulate,
                 sync):
    if accumulate:
        vol_ref, p2_ref, p1_ref, acc_ref, out_ref, scr_ref = refs
    else:
        vol_ref, p2_ref, p1_ref, out_ref, scr_ref = refs
        acc_ref = None
    n_lanes, n_steps = (w, h) if axis == 0 else (h, w)
    dt = out_ref.dtype
    big = jnp.asarray(_big(dt), dt)
    p1 = p1_ref[0]

    pid = pl.program_id(0)
    lane = pid * block + lax.broadcasted_iota(jnp.int32, (block,), 0)
    lane_ok = lane < n_lanes
    dd = lax.broadcasted_iota(jnp.int32, (block, dp), 1)
    d_ok = dd < d
    m2 = lane_ok[:, None] & d_ok
    up_ok = m2 & (dd >= 1)
    dn_ok = m2 & (dd + 1 < d)
    slot = block * dp
    scr0 = (2 * pid * block
            + lax.broadcasted_iota(jnp.int32, (block, dp), 0)) * dp + dd

    def pixel(s):
        """Flat pixel index of every lane at step s, and (diagonals) which
        lanes start a new diagonal there."""
        pos = (n_steps - 1 - s) if reverse else s
        if axis == 1:
            return jnp.where(lane_ok, lane * w + pos, 0), None
        if shift > 0:
            col = lax.rem(lane + lax.rem(s, w), w)
            fresh = col == 0
        elif shift < 0:
            col = lax.rem(lane + (w - lax.rem(s, w)), w)
            fresh = col == w - 1
        else:
            col, fresh = lane, None
        return jnp.where(lane_ok, pos * w + col, 0), fresh

    def emit(s, pix, cost_l):
        """Store step s's path cost to the scratch slot and the total."""
        cost_l = jnp.where(d_ok, cost_l, big)
        plgpu.store(scr_ref.at[scr0 + (s & 1) * slot], cost_l,
                    mask=lane_ok[:, None])
        voff = pix[:, None] * d + dd
        if accumulate:
            tot = plgpu.load(acc_ref.at[voff], mask=m2, other=0) + cost_l
        else:
            tot = cost_l
        plgpu.store(out_ref.at[voff], tot, mask=m2)
        if sync:
            plgpu.debug_barrier()
        return cost_l

    def load_cost(pix):
        voff = pix[:, None] * d + dd
        return plgpu.load(vol_ref.at[voff], mask=m2, other=0).astype(dt)

    pix0, _ = pixel(0)
    first = emit(0, pix0, load_cost(pix0))

    def step(s, prev):
        pix, fresh = pixel(s)
        cost = load_cost(pix)
        so = scr0 + ((s - 1) & 1) * slot
        up = plgpu.load(scr_ref.at[so - 1], mask=up_ok, other=big,
                        volatile=True) + p1
        dn = plgpu.load(scr_ref.at[so + 1], mask=dn_ok, other=big,
                        volatile=True) + p1
        p2 = plgpu.load(p2_ref.at[pix], mask=lane_ok, other=0)[:, None]
        prev_min = jnp.min(prev, axis=1, keepdims=True)
        best = jnp.minimum(jnp.minimum(prev, prev_min + p2),
                           jnp.minimum(up, dn))
        # (best - prev_min) before adding the cost, as ops/sgm.py::_step
        cost_l = cost + (best - prev_min)
        if fresh is not None:
            cost_l = jnp.where(fresh[:, None], cost, cost_l)
        return emit(s, pix, cost_l)

    lax.fori_loop(1, n_steps, step, first)


def _one_path(vol, p2_map, p1, acc, pid, *, interpret):
    h, w, d = vol.shape
    axis, reverse, shift = _PATHS[pid]
    dt = p2_map.dtype
    dp = _next_pow2(d)
    n_lanes = w if axis == 0 else h
    block, num_warps = launch_params(dp)
    n_prog = -(-n_lanes // block)
    kernel = functools.partial(
        _path_kernel, h=h, w=w, d=d, dp=dp, block=block, axis=axis,
        reverse=reverse, shift=shift, accumulate=acc is not None,
        sync=not interpret,
    )
    args = [vol.reshape(-1), p2_map.reshape(-1), jnp.reshape(p1, (1,)).astype(dt)]
    aliases = {}
    if acc is not None:
        aliases = {3: 0}
        args.append(acc)
    out, _ = pl.pallas_call(
        kernel,
        grid=(n_prog,),
        out_shape=(
            jax.ShapeDtypeStruct((h * w * d,), dt),
            jax.ShapeDtypeStruct((n_prog * 2 * block * dp,), dt),
        ),
        input_output_aliases=aliases,
        backend="triton",
        # one stage: no software pipelining across the barrier-ordered
        # scratch round trip
        compiler_params=plgpu.CompilerParams(num_warps=num_warps, num_stages=1),
        interpret=interpret,
        name=f"sgm_path{pid}",
    )(*args)
    return out


def aggregate_paths(vol, p1, p2_y, p2_x, path_ids, *, interpret=False):
    """Sum of the SGM paths ``path_ids`` over an (H, W, D) volume.

    p2_y / p2_x: (H, W) per-pixel P2 for the row-scanning and the
    column-scanning paths, in the carry dtype (float32 for float volumes,
    int32 for integer ones).

    Returns the (H, W, D) total in float32, or int32 for integer volumes.
    """
    h, w, d = vol.shape
    if h * w * _next_pow2(d) >= 2**31:
        raise ValueError(f"volume {vol.shape} exceeds 32-bit kernel indexing")
    total = None
    for pid in path_ids:
        p2_map = p2_x if _PATHS[pid][0] == 1 else p2_y
        total = _one_path(vol, p2_map, p1, total, pid, interpret=interpret)
    return total.reshape(h, w, d)
