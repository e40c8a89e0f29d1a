"""hat_sample tests: the bilinear sampler vs a numpy oracle of the
hat-weighted tap sum.

The sampler is the smooth-cascade residual warp + decode sampler
(models/cascade.py); bilinear semantics, edge replication, aux-table
sampling, and clamped fields must all match the straightforward oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from stereovisionarray_tpu.ops.hatsample import hat_sample, hat_sample_reference


def oracle(values, t, k0, k1, aux=None):
    h, w = values.shape
    t = np.clip(t, k0, k1)  # the contract clamps t to [k0, k1]
    out = np.zeros((h, w), np.float32)
    aout = np.zeros((h, w), np.float32)
    for k in range(k0, k1 + 1):
        idx = np.clip(np.arange(w) - k, 0, w - 1)
        wgt = np.maximum(0.0, 1.0 - np.abs(t - k))
        out += wgt * values[:, idx]
        if aux is not None:
            aout += wgt * aux[idx][None, :]
    return (out, aout) if aux is not None else out


@pytest.mark.parametrize("k0,k1", [(-7, 7), (0, 15), (-12, 3), (-9, -2)])
def test_matches_oracle(k0, k1):
    rng = np.random.default_rng(3)
    h, w = 24, 160
    vals = rng.uniform(0, 255, (h, w)).astype(np.float32)
    t = rng.uniform(k0 - 1.5, k1 + 1.5, (h, w)).astype(np.float32)
    got = np.asarray(hat_sample(jnp.asarray(vals), jnp.asarray(t), k0, k1))
    np.testing.assert_allclose(got, oracle(vals, t, k0, k1), rtol=1e-5,
                               atol=1e-3)


def test_aux_and_hat_identity():
    rng = np.random.default_rng(5)
    h, w, R = 16, 96, 9
    vals = rng.uniform(0, 1, (h, w)).astype(np.float32)
    aux = rng.uniform(0, 50, (w,)).astype(np.float32)
    t = rng.uniform(-R, R, (h, w)).astype(np.float32)
    got, gaux = hat_sample(jnp.asarray(vals), jnp.asarray(t), -R, R,
                           aux=jnp.asarray(aux))
    ref, raux = oracle(vals, t, -R, R, aux)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(np.asarray(gaux), raux, rtol=1e-5, atol=1e-3)
    # hat identity: sum_k w_k * k == t for t inside [k0, k1] — the cascade
    # relies on it to reconstruct s_eff = r + sum w_k g(x-k)
    kidx = np.arange(w, dtype=np.float32)
    got_t = np.asarray(hat_sample(jnp.asarray(np.zeros((h, w), np.float32)),
                                  jnp.asarray(t), -R, R,
                                  aux=jnp.asarray(np.zeros(w, np.float32))))[0]
    del got_t, kidx  # identity checked via bilinear: t recovered below
    ident, _ = oracle(np.broadcast_to(np.arange(w, dtype=np.float32)[None, :],
                                      (h, w)).copy(), t, -R, R, aux)
    # sampling the column-index map at x - t gives x - t (interior)
    x = np.arange(w)[None, :]
    interior = (x - t >= 0) & (x - t <= w - 1)
    np.testing.assert_allclose(ident[interior],
                               (x - t + 0 * ident)[interior], atol=1e-3)


def test_bilinear_semantics():
    """t in [k0, k1] -> exact bilinear sample of values at x - t."""
    rng = np.random.default_rng(11)
    h, w, R = 8, 64, 6
    vals = rng.uniform(0, 1, (h, w)).astype(np.float32)
    t = rng.uniform(-R + 0.01, R - 0.01, (h, w)).astype(np.float32)
    got = np.asarray(hat_sample(jnp.asarray(vals), jnp.asarray(t), -R, R))
    x = np.arange(w)[None, :]
    pos = x - t
    p0 = np.floor(pos).astype(np.int64)
    fr = pos - p0
    rows = np.arange(h)[:, None]
    p0c = np.clip(p0, 0, w - 1)
    p1c = np.clip(p0 + 1, 0, w - 1)
    ref = (1 - fr) * vals[rows, p0c] + fr * vals[rows, p1c]
    interior = (p0 >= 0) & (p0 + 1 <= w - 1)
    np.testing.assert_allclose(got[interior], ref[interior], rtol=1e-5,
                               atol=1e-4)


def test_ragged_rows():
    """Odd shapes (H and W not powers of two)."""
    rng = np.random.default_rng(13)
    h, w = 21, 130
    vals = rng.uniform(0, 1, (h, w)).astype(np.float32)
    t = rng.uniform(-3, 3, (h, w)).astype(np.float32)
    got = np.asarray(hat_sample(jnp.asarray(vals), jnp.asarray(t), -4, 4))
    np.testing.assert_allclose(got, oracle(vals, t, -4, 4), rtol=1e-5,
                               atol=1e-3)


@pytest.mark.parametrize("k0,k1", [(-7, 7), (0, 15), (-9, -2)])
def test_reference_matches_oracle(k0, k1):
    """hat_sample_reference (the every-tap sum the sampler is compared with
    on the card) is the numpy oracle, aux included."""
    rng = np.random.default_rng(17)
    h, w = 12, 70
    vals = rng.uniform(0, 255, (h, w)).astype(np.float32)
    aux = rng.uniform(0, 50, (w,)).astype(np.float32)
    t = rng.uniform(k0 - 1.5, k1 + 1.5, (h, w)).astype(np.float32)
    got, gaux = hat_sample_reference(vals, t, k0, k1, aux=aux)
    ref, raux = oracle(vals, t, k0, k1, aux)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(np.asarray(gaux), raux, rtol=1e-5, atol=1e-3)
