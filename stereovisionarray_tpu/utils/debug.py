"""Numeric-safety + determinism harness (SURVEY.md §5 "race detection /
sanitizers").

The reference is single-threaded, so its hazards are uninitialized memory
and div-by-zero (§2.3) rather than races. The device-program analogues are:

* silent NaN/Inf propagation through fused kernels — :func:`checked` wraps a
  jittable fn with `checkify` so the first NaN/OOB fires a Python error with
  a location instead of poisoning downstream stages;
* nondeterministic reduction orders across shardings — :func:`assert_deterministic`
  runs a fn twice (optionally under different meshes) and demands bit-identical
  results, the property the golden tests rely on (SURVEY.md §7 "bit-determinism
  across shardings").
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import jax
import numpy as np
from jax.experimental import checkify

__all__ = ["checked", "assert_deterministic", "find_nonfinite"]


def checked(fn: Callable, errors=None) -> Callable:
    """Wrap a jittable `fn` so NaN/Inf (and index OOB) raise immediately.

    >>> safe = checked(two_view_disparity)        # doctest: +SKIP
    >>> out = safe(left, right)  # raises on internal NaN  # doctest: +SKIP
    """
    if errors is None:
        errors = checkify.float_checks | checkify.index_checks

    checked_fn = checkify.checkify(fn, errors=errors)

    def wrapper(*args, **kwargs):
        err, out = checked_fn(*args, **kwargs)
        checkify.check_error(err)
        return out

    wrapper.__name__ = f"checked_{getattr(fn, '__name__', 'fn')}"
    return wrapper


def assert_deterministic(
    fn: Callable,
    *args: Any,
    runs: int = 2,
    variants: Optional[Sequence[Callable[[], Any]]] = None,
) -> Any:
    """Run `fn(*args)` `runs` times (plus once per extra `variant` thunk) and
    assert every result is BIT-identical to the first. Returns the result.

    variants: zero-arg callables producing the same logical computation a
    different way (e.g. the same pipeline on a different mesh shape)."""
    ref = jax.tree_util.tree_map(np.asarray, fn(*args))

    def compare(result, label):
        got = jax.tree_util.tree_map(np.asarray, result)
        flat_a, _ = jax.tree_util.tree_flatten(ref)
        flat_b, _ = jax.tree_util.tree_flatten(got)
        for i, (a, b) in enumerate(zip(flat_a, flat_b)):
            if not np.array_equal(a, b, equal_nan=True):
                diff = int(np.sum(a != b))
                raise AssertionError(
                    f"nondeterministic result ({label}): leaf {i} differs in "
                    f"{diff} elements (max abs diff "
                    f"{np.max(np.abs(a.astype(np.float64) - b.astype(np.float64)))})"
                )

    for r in range(1, runs):
        compare(fn(*args), f"run {r}")
    for i, thunk in enumerate(variants or []):
        compare(thunk(), f"variant {i}")
    return ref


def find_nonfinite(tree: Any) -> dict:
    """Map leaf-path -> count of non-finite values, for post-mortem of a
    poisoned pipeline state (empty dict = all finite)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        arr = np.asarray(leaf)
        if np.issubdtype(arr.dtype, np.floating):
            bad = int((~np.isfinite(arr)).sum())
            if bad:
                out[jax.tree_util.keystr(path)] = bad
    return out
