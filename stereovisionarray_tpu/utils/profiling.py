"""Profiling / tracing harness (SURVEY.md §5: the reference has no timing
code at all — no chrono, no clocks; its performance story is "wait and
see"). Tools:

 - :func:`time_fn` / :func:`steady_times` — steady-state timing of a jitted
   callable with ``block_until_ready`` fencing (the bench scripts);
 - :func:`require_gpu` / :func:`card_label` — the device a measurement ran
   on: a measurement that finds no GPU stops, it never falls back to the
   CPU, and every number is printed beside the card's name and power limit;
 - :class:`StageTimer` — named-stage wall-clock accumulator for pipeline
   breakdowns;
 - :func:`trace` — context manager around ``jax.profiler`` emitting a
   TensorBoard-loadable device trace.
"""

from __future__ import annotations

import contextlib
import statistics
import subprocess
import sys
import time
from typing import Callable, Dict, List, Tuple

import jax


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2, **kwargs) -> float:
    """Mean steady-state seconds per call (device-fenced)."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args, **kwargs))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def steady_times(fn: Callable, *args, iters: int = 10,
                 warmup: int = 2) -> Tuple[float, List[float]]:
    """(seconds of the first call — compile included — and the per-call
    seconds of ``iters`` steady calls), each call ended by
    ``block_until_ready``."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    for _ in range(max(warmup - 1, 0)):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return first, times


def median_ms(times: List[float]) -> float:
    return statistics.median(times) * 1e3


def require_gpu() -> jax.Device:
    """The first JAX device, which must be a GPU; exits with status 2 (and
    prints nothing to stdout) otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX's first device is {dev.platform!r}; "
              "this measurement runs on the card only", file=sys.stderr)
        raise SystemExit(2)
    return dev


def card_label() -> str:
    """``name, power.limit`` of the card as nvidia-smi prints them (run as
    a child process that stays off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


class StageTimer:
    """Accumulates wall-clock per named stage.

    >>> t = StageTimer()
    >>> with t.stage("cost"):
    ...     vol = build(...)  # doctest: +SKIP
    >>> t.report()  # doctest: +SKIP
    """

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync: bool = True):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync:
                # fence pending device work so the stage owns its time
                jax.effects_barrier()
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> Dict[str, float]:
        return dict(self.totals)

    def __str__(self) -> str:
        return " | ".join(
            f"{k}: {v * 1000:.1f}ms/{self.counts[k]}" for k, v in self.totals.items()
        )


@contextlib.contextmanager
def trace(log_dir: str):
    """Device trace context: ``with trace('/tmp/trace'): run()`` then load
    the directory in TensorBoard / xprof."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
