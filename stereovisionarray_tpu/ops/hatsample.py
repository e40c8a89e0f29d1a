"""Per-pixel bilinear column sampling along image rows.

``hat_sample(values, t, k0, k1)`` computes

    out(y, x) = sum_{k=k0}^{k1} max(0, 1 - |t(y,x) - k|) * values(y, x-k)

with edge-replicated columns and ``t`` clamped to ``[k0, k1]``: a bilinear
sample of ``values`` at ``x - t(y, x)``. Only the two integer taps that
straddle ``t`` have nonzero hat weight, so the sum is a floor, two
``take_along_axis`` gathers and a lerp. This is the smooth-cascade
residual warp and its decode sampler (``models/cascade.py``,
``models/cascade_sweep.py``), replacing the reference's per-pixel epipolar
candidate addressing (reference ``src/CameraStereoVision.cpp:73-83``)
at the warp level.

``aux`` (optional, a 1D per-column table, e.g. the cascade's column field
``g``) is sampled with the same two weights:

    aux_out(y, x) = sum_k hat(t - k) * aux(x - k)

``hat_sample_reference`` is the hat-weighted tap sum written out over
every tap, the oracle the sampler is checked against.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

__all__ = ["hat_sample", "hat_sample_reference"]


@functools.partial(jax.jit, static_argnames=("k0", "k1"))
def hat_sample(
    values: jnp.ndarray,
    t: jnp.ndarray,
    k0: int,
    k1: int,
    aux: Optional[jnp.ndarray] = None,
):
    """See module docstring. values/t: (H, W) f32; aux: (W,) f32 or None.

    Returns ``out`` or ``(out, aux_out)``. The two weights sum to 1 and
    their mean tap is ``clip(t, k0, k1)``, so callers needing ``field + t``
    terms can add the clipped ``t`` directly instead of folding ``k`` into
    ``aux``."""
    h, w = values.shape
    values = values.astype(jnp.float32)
    t = jnp.clip(t.astype(jnp.float32), float(k0), float(k1))
    k_lo = jnp.floor(t)
    frac = t - k_lo
    src = jnp.arange(w, dtype=jnp.int32)[None, :] - k_lo.astype(jnp.int32)
    i_lo = jnp.clip(src, 0, w - 1)  # tap k_lo
    i_hi = jnp.clip(src - 1, 0, w - 1)  # tap k_lo + 1 (weight 0 at t == k1)

    def sample(table):
        lo = jnp.take_along_axis(table, i_lo, axis=1)
        hi = jnp.take_along_axis(table, i_hi, axis=1)
        return lo + frac * (hi - lo)

    out = sample(values)
    if aux is None:
        return out
    aux_rows = jnp.broadcast_to(aux.astype(jnp.float32)[None, :], (h, w))
    return out, sample(aux_rows)


def hat_sample_reference(values, t, k0: int, k1: int, aux=None):
    """The hat-weighted sum over every tap ``k0..k1`` (plain jnp), with the
    same clamping and edge replication as :func:`hat_sample`."""
    h, w = values.shape
    values = jnp.asarray(values, jnp.float32)
    t = jnp.clip(jnp.asarray(t, jnp.float32), float(k0), float(k1))
    x = jnp.arange(w)
    out = jnp.zeros((h, w), jnp.float32)
    aout = jnp.zeros((h, w), jnp.float32)
    for k in range(k0, k1 + 1):
        cols = jnp.clip(x - k, 0, w - 1)
        wgt = jnp.maximum(0.0, 1.0 - jnp.abs(t - float(k)))
        out = out + wgt * values[:, cols]
        if aux is not None:
            aout = aout + wgt * jnp.asarray(aux, jnp.float32)[cols][None, :]
    return out if aux is None else (out, aout)
