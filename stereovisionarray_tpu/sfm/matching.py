"""Descriptor matching: mutual nearest neighbour + Lowe ratio test.

One (F_a x F_b) distance matrix per view pair — a single matmul on
L2-normalized descriptors (dist^2 = 2 - 2 a.b) — fixed shapes, vmappable
over the pair list from ``geometry.topology.camera_pairs``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp


class Matches(NamedTuple):
    idx_a: jnp.ndarray  # (F,) int32 index into view a's features (identity)
    idx_b: jnp.ndarray  # (F,) int32 best match in view b
    score: jnp.ndarray  # (F,) similarity (cosine) of the match
    valid: jnp.ndarray  # (F,) bool: passed mutual + ratio tests


@functools.partial(jax.jit, static_argnames=())
def match_descriptors(
    desc_a: jnp.ndarray,
    desc_b: jnp.ndarray,
    valid_a: jnp.ndarray,
    valid_b: jnp.ndarray,
    ratio: float = 0.9,
    min_score: float = 0.5,
) -> Matches:
    """Match normalized descriptors (F, K) a -> b.

    valid = mutual nearest neighbour AND second-best similarity < ratio *
    best (Lowe test on cosine similarity, guarding repetitive texture) AND
    best similarity >= min_score.
    """
    sim = jnp.einsum(
        "ak,bk->ab", desc_a, desc_b, precision=jax.lax.Precision.HIGHEST
    )
    neg = jnp.asarray(-2.0, sim.dtype)
    sim = jnp.where(valid_a[:, None] & valid_b[None, :], sim, neg)

    best_b = jnp.argmax(sim, axis=1).astype(jnp.int32)  # (Fa,)
    best_sim = jnp.max(sim, axis=1)
    # second best for the ratio test
    masked = jnp.where(
        jax.nn.one_hot(best_b, sim.shape[1], dtype=bool), neg, sim
    )
    second_sim = jnp.max(masked, axis=1)

    best_a_of_b = jnp.argmax(sim, axis=0).astype(jnp.int32)  # (Fb,)
    mutual = best_a_of_b[best_b] == jnp.arange(sim.shape[0], dtype=jnp.int32)

    # Lowe on distances: d^2 = 2 - 2s  =>  d1 < r * d2 <=> 1 - s1 < r^2 (1 - s2)
    r2 = ratio * ratio
    lowe = (1.0 - best_sim) < r2 * (1.0 - second_sim)

    valid = mutual & lowe & (best_sim >= min_score) & valid_a
    return Matches(
        idx_a=jnp.arange(sim.shape[0], dtype=jnp.int32),
        idx_b=best_b,
        score=best_sim,
        valid=valid,
    )
