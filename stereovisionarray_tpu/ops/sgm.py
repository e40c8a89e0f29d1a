"""8-path semi-global matching (SGM) aggregation as vectorized XLA scans.

The reference has no global aggregation — winner-take-all over raw SAD
(``/root/reference/src/CameraStereoVision.cpp:85``) plus a +-5-step local
photoconsistency refine (``/root/reference/src/functions.cpp:27-39``). SGM
generalizes that into the standard smoothness-regularized recurrence

    L_r(p, d) = C(p, d) + min( L_r(p-r, d),
                               L_r(p-r, d-1) + P1,
                               L_r(p-r, d+1) + P1,
                               min_d' L_r(p-r, d') + P2 )
                       - min_d' L_r(p-r, d')

aggregated over 4 or 8 path directions r.

The recurrence is sequential only along the scan direction; the carry is
the full (W, D) [or (H, D)] wavefront, so every scan step is one dense
elementwise op over W*D values — the "wavefront parallel across the
perpendicular axis" design from SURVEY.md §7. Diagonal paths reuse the row
scan with the carry shifted one column per step.

Two implementations of the same recurrence, chosen by ``backend``:
``"xla"`` runs one ``lax.scan`` per path; ``"pallas"`` runs the Triton
kernel of ``ops/sgm_triton.py`` (one launch per path, the scan loop inside
the kernel); ``"pallas_interpret"`` runs that kernel in the Pallas
interpreter (CPU tests). Integer volumes (the fixed-point costs of
``CostConfig.dtype``) are aggregated exactly and returned as int32: the
kernel carries int32, the XLA scan computes in float32, which is exact
for these integer magnitudes.

``sgm_aggregate_reference`` is the deliberately-slow numpy-style oracle used
by the golden tests (SURVEY.md §4: "SGM single-path recurrence vs tiny
dynamic-program oracle").
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

_BIG = jnp.float32(1e9)


def _step(prev: jnp.ndarray, cost: jnp.ndarray, p1, p2) -> jnp.ndarray:
    """One SGM recurrence step.

    prev: (..., D) previous aggregated costs along the path.
    cost: (..., D) matching cost at the current pixel front.
    p1/p2: scalars or (...,1)-broadcastable arrays (adaptive P2)."""
    prev_min = jnp.min(prev, axis=-1, keepdims=True)
    up = jnp.concatenate([prev[..., :1] + p1 + 1.0, prev[..., :-1] + p1], axis=-1)
    dn = jnp.concatenate([prev[..., 1:] + p1, prev[..., -1:] + p1 + 1.0], axis=-1)
    best = jnp.minimum(jnp.minimum(prev, prev_min + p2), jnp.minimum(up, dn))
    # (best - prev_min) BEFORE adding cost: at fresh-start borders the carry
    # is _BIG and f32 absorption in (cost + _BIG) - _BIG would zero the cost
    return cost + (best - prev_min)


def _scan_along_axis0(
    vol: jnp.ndarray, p1, p2, diag_shift: int = 0, p2_row: Optional[jnp.ndarray] = None
) -> jnp.ndarray:
    """Scan the SGM recurrence along axis 0 of vol (N_steps, W, D).

    diag_shift: 0 for axis-aligned paths; +-1 shifts the carry one column per
    step (diagonal paths). Shifted-in border columns get a fresh start
    (carry = BIG so `best` falls back to prev_min + p2 semantics — standard
    SGM border handling is carry = 0-cost restart; we restart with the raw
    cost by making prev uninformative).
    p2_row: optional (N_steps, W, 1) adaptive P2 per step (edge-aware)."""

    def step(prev, xs):
        cost, p2_t = xs
        if diag_shift != 0:
            pad = jnp.full_like(prev[:1], _BIG)
            if diag_shift > 0:
                prev = jnp.concatenate([pad, prev[:-1]], axis=0)
            else:
                prev = jnp.concatenate([prev[1:], pad], axis=0)
        out = _step(prev, cost, p1, p2_t)
        return out, out

    if p2_row is None:
        p2_arr = jnp.broadcast_to(jnp.asarray(p2, vol.dtype), (vol.shape[0], 1, 1))
    else:
        p2_arr = p2_row
    # Path start: L(p0) = C(p0) — seed the carry with the first slice.
    first = vol[0]
    _, rest = jax.lax.scan(step, first, (vol[1:], p2_arr[1:]))
    return jnp.concatenate([first[None], rest], axis=0)


def scan_with_carry(
    vol: jnp.ndarray,
    p1,
    p2_row: jnp.ndarray,
    diag_shift: int = 0,
    init_carry: Optional[jnp.ndarray] = None,
):
    """SGM path scan along axis 0 of (N_steps, W, D) with an EXPLICIT carry
    boundary — the building block of the exact tile-sharded mode
    (parallel/two_view.py): shard k scans its local rows starting from shard
    k-1's final wavefront, relayed via ppermute.

    init_carry: (W, D) front from the predecessor, or None for a fresh path
    start. A BIG-filled carry is mathematically identical to the fresh start
    (``best - prev_min == 0`` when prev is uniformly BIG), so
    ``scan_with_carry(vol, ..., init_carry=None)`` equals
    ``_scan_along_axis0(vol, ...)`` bit-for-bit.

    Returns (L, final_carry): the aggregated rows and the post-update front
    after the last row (what the NEXT shard needs as init_carry).
    """
    if init_carry is None:
        init_carry = jnp.full(vol.shape[1:], _BIG, vol.dtype)

    def step(prev, xs):
        cost, p2_t = xs
        if diag_shift != 0:
            pad = jnp.full_like(prev[:1], _BIG)
            if diag_shift > 0:
                prev = jnp.concatenate([pad, prev[:-1]], axis=0)
            else:
                prev = jnp.concatenate([prev[1:], pad], axis=0)
        out = _step(prev, cost, p1, p2_t)
        return out, out

    final, rows = jax.lax.scan(step, init_carry, (vol, p2_row))
    return rows, final


def _edge_p2(image: jnp.ndarray, axis: int, p2: float, p2_min: float, dtype) -> jnp.ndarray:
    """Adaptive P2 per pixel: scale P2 down across strong intensity edges
    (P2 / |grad|, floored at p2_min) — standard SGM practice, preserves depth
    discontinuities the reference's local search smears.

    Computed in f32 and rounded into `dtype` (exact for the int16 cost
    path, identity for float dtypes)."""
    img = image.astype(jnp.float32)
    g = jnp.abs(jnp.diff(img, axis=axis, prepend=jnp.take(img, jnp.array([0]), axis=axis)))
    p2_map = jnp.maximum(jnp.float32(p2) / (1.0 + 0.5 * g), jnp.float32(p2_min))
    if jnp.issubdtype(jnp.dtype(dtype), jnp.integer):
        return jnp.round(p2_map).astype(dtype)
    return p2_map.astype(dtype)


# Path ids: 0 down, 1 up, 2 left->right, 3 right->left, 4..7 diagonals
# (down-right, down-left, up-right, up-left). Paths 0-3 are the 4-path set.
ALL_PATH_IDS = (0, 1, 2, 3, 4, 5, 6, 7)


@functools.partial(jax.jit, static_argnames=("path_ids", "adaptive_p2", "backend"))
def sgm_aggregate_paths(
    vol: jnp.ndarray,
    p1: float = 8.0,
    p2: float = 96.0,
    path_ids: tuple = ALL_PATH_IDS,
    image: Optional[jnp.ndarray] = None,
    adaptive_p2: bool = False,
    p2_min: float = 24.0,
    backend: str = "xla",
) -> jnp.ndarray:
    """Aggregate an (H, W, D) cost volume over the given subset of the 8 SGM
    paths. The subset form is the unit of *path parallelism*: the ``disp``
    mesh axis splits ``ALL_PATH_IDS`` across shards and ``psum``s the partial
    sums (parallel/two_view.py), since total = sum over independent paths.

    backend: a resolved backend (``backend.resolve_backend``): "xla",
    "pallas" or "pallas_interpret". Float volumes return float32 (the
    input dtype); integer volumes return the exact int32 sum, with P1/P2
    taken in the volume's fixed-point units."""
    h, w, D = vol.shape
    integer = jnp.issubdtype(vol.dtype, jnp.integer)
    # integer P2 maps are rounded in int32, as the fixed-point costs are
    map_dtype = jnp.int32 if integer else vol.dtype
    if adaptive_p2 and image is not None:
        p2_y = _edge_p2(image, 0, p2, p2_min, map_dtype)
        p2_x = _edge_p2(image, 1, p2, p2_min, map_dtype)
    else:
        p2_y = jnp.full((h, w), p2, map_dtype)
        p2_x = p2_y

    if backend in ("pallas", "pallas_interpret"):
        from stereovisionarray_tpu.ops.sgm_triton import aggregate_paths

        return aggregate_paths(
            vol, jnp.asarray(p1, map_dtype), p2_y, p2_x, tuple(path_ids),
            interpret=backend == "pallas_interpret",
        )
    if backend != "xla":
        raise ValueError(f"unknown SGM backend {backend!r}")

    dtype = jnp.float32 if integer else vol.dtype
    out_dtype = vol.dtype if not integer else jnp.int32
    vol = vol.astype(dtype)
    p1 = jnp.asarray(p1, dtype)
    p2_y = p2_y.astype(dtype)[..., None]  # (H, W, 1)
    p2_x = p2_x.astype(dtype)[..., None]
    total = _xla_paths(vol, p1, p2_y, p2_x, path_ids)
    return total.astype(out_dtype)


def _xla_paths(vol, p1, p2_y, p2_x, path_ids):
    total = jnp.zeros_like(vol)
    fv = jnp.flip(vol, 0)
    fp = jnp.flip(p2_y, 0)

    for pid in path_ids:
        if pid == 0:  # down: scan over rows, carry (W, D)
            total += _scan_along_axis0(vol, p1, None, 0, p2_row=p2_y)
        elif pid == 1:  # up
            total += jnp.flip(
                _scan_along_axis0(fv, p1, None, 0, p2_row=fp), 0
            )
        elif pid == 2:  # left -> right: transpose so columns lead, carry (H, D)
            vol_t = jnp.swapaxes(vol, 0, 1)
            total += jnp.swapaxes(
                _scan_along_axis0(vol_t, p1, None, 0, p2_row=jnp.swapaxes(p2_x, 0, 1)), 0, 1
            )
        elif pid == 3:  # right -> left
            vol_t = jnp.flip(jnp.swapaxes(vol, 0, 1), 0)
            p2_t = jnp.flip(jnp.swapaxes(p2_x, 0, 1), 0)
            total += jnp.swapaxes(
                jnp.flip(_scan_along_axis0(vol_t, p1, None, 0, p2_row=p2_t), 0), 0, 1
            )
        # Diagonal paths: scan over rows with carry shifted +-1 column/step.
        # Use the vertical-edge P2 (dominant direction of travel is y).
        elif pid == 4:
            total += _scan_along_axis0(vol, p1, None, +1, p2_row=p2_y)
        elif pid == 5:
            total += _scan_along_axis0(vol, p1, None, -1, p2_row=p2_y)
        elif pid == 6:
            total += jnp.flip(_scan_along_axis0(fv, p1, None, +1, p2_row=fp), 0)
        elif pid == 7:
            total += jnp.flip(_scan_along_axis0(fv, p1, None, -1, p2_row=fp), 0)
        else:
            raise ValueError(f"unknown SGM path id {pid}")
    return total


@functools.partial(jax.jit, static_argnames=("num_paths", "adaptive_p2", "backend"))
def sgm_aggregate(
    vol: jnp.ndarray,
    p1: float = 8.0,
    p2: float = 96.0,
    num_paths: int = 8,
    image: Optional[jnp.ndarray] = None,
    adaptive_p2: bool = False,
    p2_min: float = 24.0,
    backend: str = "xla",
) -> jnp.ndarray:
    """Aggregate an (H, W, D) cost volume over 4 or 8 SGM paths.

    Returns the summed path costs (H, W, D): float32 for float volumes,
    int32 for integer (fixed-point) volumes. See
    :func:`sgm_aggregate_paths` for ``backend``.

    image: (H, W) grayscale used for edge-adaptive P2 when adaptive_p2.
    """
    if num_paths not in (4, 8):
        raise ValueError("num_paths must be 4 or 8")
    return sgm_aggregate_paths(
        vol,
        p1=p1,
        p2=p2,
        path_ids=ALL_PATH_IDS[:num_paths],
        image=image,
        adaptive_p2=adaptive_p2,
        p2_min=p2_min,
        backend=backend,
    )


# ---------------------------------------------------------------------- #
# Slow oracle for tests
# ---------------------------------------------------------------------- #
# path id -> (dy, dx) direction of travel, ids per ALL_PATH_IDS
_PATH_DIRS = {0: (1, 0), 1: (-1, 0), 2: (0, 1), 3: (0, -1),
              4: (1, 1), 5: (1, -1), 6: (-1, 1), 7: (-1, -1)}


def sgm_aggregate_reference(
    vol: np.ndarray, p1: float, p2: float, num_paths: int = 8,
    path_ids: Optional[tuple] = None,
) -> np.ndarray:
    """Tiny dynamic-program oracle (pure numpy, per-pixel loops) used by the
    golden tests to validate the scan kernels. Constant P2 only.
    ``path_ids`` (ids per ALL_PATH_IDS) overrides ``num_paths``."""
    vol = np.asarray(vol, dtype=np.float64)
    h, w, D = vol.shape
    if path_ids is None:
        path_ids = ALL_PATH_IDS[:num_paths]
    dirs = [_PATH_DIRS[p] for p in path_ids]
    total = np.zeros_like(vol)
    for dy, dx in dirs:
        L = np.zeros_like(vol)
        ys = range(h) if dy >= 0 else range(h - 1, -1, -1)
        xs = range(w) if dx >= 0 else range(w - 1, -1, -1)
        for y in ys:
            for x in xs:
                py, px = y - dy, x - dx
                if 0 <= py < h and 0 <= px < w:
                    prev = L[py, px]
                    pmin = prev.min()
                    cand = np.minimum(prev, pmin + p2)
                    cand = np.minimum(cand, np.concatenate([[prev[0] + p1 + 1.0], prev[:-1] + p1]))
                    cand = np.minimum(cand, np.concatenate([prev[1:] + p1, [prev[-1] + p1 + 1.0]]))
                    L[y, x] = vol[y, x] + cand - pmin
                else:
                    L[y, x] = vol[y, x]
        total += L
    return total
