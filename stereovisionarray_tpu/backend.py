"""SGM backend resolution shared by the single-device models and the
sharded (shard_map) pipelines.

The backend chooses how SGM path aggregation runs (``ops/sgm.py``):

- ``"xla"``: one ``lax.scan`` per path;
- ``"pallas"``: the Triton kernel of ``ops/sgm_triton.py`` (GPU only);
- ``"pallas_interpret"``: that kernel in the Pallas interpreter, for CPU
  tests;
- ``"auto"``: ``"pallas"`` on a GPU, ``"xla"`` on the CPU.

One definition so single-device and sharded paths resolve alike.
"""

import jax

__all__ = ["BACKENDS", "resolve_backend"]

BACKENDS = ("auto", "xla", "pallas", "pallas_interpret")

_AUTO = {"gpu": "pallas", "cpu": "xla"}


def resolve_backend(backend: str, platform: str = None) -> str:
    """Resolve ``backend`` for ``platform`` (default: JAX's default
    backend). Raises on an unknown backend, on ``"auto"`` for a platform
    with no rule, and on ``"pallas"`` anywhere but a GPU (the kernel must
    never fall back to the interpreter silently)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    platform = platform or jax.default_backend()
    if backend == "auto":
        if platform not in _AUTO:
            raise ValueError(f"no SGM backend for platform {platform!r}")
        return _AUTO[platform]
    if backend == "pallas" and platform != "gpu":
        raise ValueError(
            f"backend 'pallas' compiles for a GPU; platform is {platform!r} "
            "(use 'xla', or 'pallas_interpret' to run the kernel interpreted)"
        )
    return backend
