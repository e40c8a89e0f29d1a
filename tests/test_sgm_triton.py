"""Triton SGM path kernel (ops/sgm_triton.py) in the Pallas interpreter vs
the XLA scans (ops/sgm.py) and the numpy dynamic-program oracle.

Every path id, float32 and int16 volumes, constant and edge-adaptive P2,
odd widths and a disparity count that is not a power of two (the kernel
pads D): the kernel must reproduce the XLA scans bit for bit (same float32
operations in the same order; exact integer sums) and the oracle to float
tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stereovisionarray_tpu.ops.sgm import (
    ALL_PATH_IDS,
    sgm_aggregate,
    sgm_aggregate_paths,
    sgm_aggregate_reference,
)

P1, P2, P2_MIN = 3, 20, 6


def _inputs(dtype, w, h=7, d=5, seed=0):
    rng = np.random.default_rng(seed)
    vol = rng.integers(0, 40, (h, w, d)).astype(dtype)
    img = rng.uniform(0, 255, (h, w)).astype(np.float32)
    return vol, img


@pytest.mark.parametrize("w", [11, 13])
@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("pid", ALL_PATH_IDS)
def test_path_matches_xla_and_oracle(pid, dtype, adaptive, w):
    vol, img = _inputs(dtype, w)
    args = (jnp.asarray(vol), P1, P2, (pid,), jnp.asarray(img), adaptive, P2_MIN)
    got = np.asarray(sgm_aggregate_paths(*args, backend="pallas_interpret"))
    want = np.asarray(sgm_aggregate_paths(*args, backend="xla"))
    assert got.dtype == want.dtype == (np.int32 if dtype == "int16" else np.float32)
    np.testing.assert_array_equal(got, want)
    if not adaptive:  # the oracle takes a constant P2
        ref = sgm_aggregate_reference(vol, P1, P2, path_ids=(pid,))
        np.testing.assert_allclose(got, ref, rtol=1e-6)


@pytest.mark.parametrize("num_paths", [4, 8])
@pytest.mark.parametrize("dtype", ["float32", "int16", "int8"])
def test_all_paths_sum_matches_xla(dtype, num_paths):
    """The in-place accumulation across chained path calls keeps the XLA
    summation order: the full 4/8-path totals agree bit for bit."""
    vol, img = _inputs(dtype, 9, h=6, d=7, seed=1)
    args = (jnp.asarray(vol), P1, P2, num_paths, jnp.asarray(img), True, P2_MIN)
    got = np.asarray(sgm_aggregate(*args, backend="pallas_interpret"))
    want = np.asarray(sgm_aggregate(*args, backend="xla"))
    np.testing.assert_array_equal(got, want)


def test_batched_under_vmap():
    """The kernel's grid gains a batch axis under vmap (the sharded
    pipelines vmap over frames); each frame matches its own aggregate."""
    vols = np.stack([_inputs("int16", 11, seed=s)[0] for s in range(3)])
    f = lambda v: sgm_aggregate(v, P1, P2, 8, backend="pallas_interpret")
    got = np.asarray(jax.vmap(f)(jnp.asarray(vols)))
    for i in range(3):
        want = np.asarray(sgm_aggregate(jnp.asarray(vols[i]), P1, P2, 8,
                                        backend="xla"))
        np.testing.assert_array_equal(got[i], want)


def test_unknown_backend_raises():
    vol, _ = _inputs("float32", 11)
    with pytest.raises(ValueError, match="backend"):
        sgm_aggregate(jnp.asarray(vol), P1, P2, 8, backend="scan")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_compiled_kernel_matches_xla_on_gpu(gpu, dtype):
    """The kernel as compiled for the card, at a real width, against the
    XLA scans on the same card."""
    vol, img = _inputs(dtype, 768, h=540, d=64, seed=2)
    vol, img = jax.device_put(vol, gpu), jax.device_put(img, gpu)
    args = (vol, 8, 96, 8, img, True, 24)
    got = np.asarray(sgm_aggregate(*args, backend="pallas"))
    want = np.asarray(sgm_aggregate(*args, backend="xla"))
    np.testing.assert_array_equal(got, want)
