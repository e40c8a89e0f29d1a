"""Test harness setup: force an 8-device virtual CPU mesh BEFORE jax import
so sharding / collective tests run without accelerator hardware (SURVEY.md §4).

Tests that need a GPU carry the ``gpu`` marker and ask for the ``gpu``
fixture, which skips them when no card is present (decided at run time,
never at import, so every xdist worker collects the same tests). They run
on the card with ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``;
otherwise the platform defaults to the CPU.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

from stereovisionarray_tpu.compile_cache import enable_compile_cache  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", False)
# Persistent compilation cache for the CPU test programs: the suite is
# compile-dominated (hundreds of programs), and one process compiling them
# all back-to-back has hit an XLA-CPU-internal abort near the ~300-compile
# mark in full-suite order (reproducible at the same test, absent when the
# file runs alone). Cache hits cut both the runtime and the in-process
# compile count.
enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

assert jax.device_count("cpu") == 8, f"expected 8 virtual CPU devices, got {jax.devices('cpu')}"

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when the process has none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU (run on the card: python -m pytest -m gpu)")
