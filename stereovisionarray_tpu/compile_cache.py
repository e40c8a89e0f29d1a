"""Where compiled programs are cached between processes.

JAX's persistent compilation cache is keyed by the cache directory, so the
directory must not move between runs. ``JAX_COMPILATION_CACHE_DIR``, when
set, is JAX's own setting and is left alone; otherwise the cache goes to
``.jax_cache`` at the root of the checkout (listed in ``.gitignore``).
"""

from __future__ import annotations

import os

import jax

__all__ = ["DEFAULT_CACHE_DIR", "enable_compile_cache"]

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory.

    Sets nothing when ``JAX_COMPILATION_CACHE_DIR`` is set (JAX reads it)."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
