"""Elastic execution: failure detection + re-shardable resume (SURVEY.md §5).

The reference has no failure story at all — it crashes on the first bad
input (``faces[0]`` with no detection, ``/root/reference/src/dlibFaceSelect.cpp:25``;
divide-by-zero depth, ``/root/reference/src/CameraStereoVision.cpp:100``).
A multi-host engine needs three pieces, built here:

:class:`Heartbeat`
    Liveness watchdog: workers `beat()` from their loop; a monitor thread
    flags any worker whose last beat is older than the timeout and invokes
    a callback (on a real slice this is where `jax.distributed` barrier
    failure / coordinator timeout surfaces; the detection logic is
    identical and testable locally).

:func:`reshard`
    Move an arbitrary state pytree onto a (new) mesh with given
    PartitionSpecs — the primitive that lets a checkpoint written on N
    devices resume on M (shrunk-slice recovery).

:class:`ElasticRunner`
    Checkpoint-every-k-steps driver around a step function: on any step
    exception it restores the last checkpoint onto the CURRENT device set
    (possibly fewer devices) and continues — fault injection = raising
    from the step fn, which is exactly what the tests do.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from stereovisionarray_tpu.utils.checkpoint import load_checkpoint, save_checkpoint

__all__ = ["Heartbeat", "reshard", "ElasticRunner"]


class Heartbeat:
    """Worker-liveness monitor.

    >>> hb = Heartbeat(timeout=5.0, on_dead=handle)     # doctest: +SKIP
    >>> hb.beat("host0")  # from each worker's loop      # doctest: +SKIP
    """

    def __init__(
        self,
        timeout: float,
        on_dead: Optional[Callable[[str, float], None]] = None,
        poll_interval: Optional[float] = None,
    ) -> None:
        self.timeout = timeout
        self.on_dead = on_dead
        self.poll_interval = poll_interval if poll_interval is not None else timeout / 4
        self._last: Dict[str, float] = {}
        self._dead: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def beat(self, worker: str) -> None:
        with self._lock:
            self._last[worker] = time.monotonic()
            self._dead.pop(worker, None)

    def dead_workers(self) -> Dict[str, float]:
        """worker -> seconds since last beat, for workers past the timeout."""
        now = time.monotonic()
        with self._lock:
            return {
                w: now - t for w, t in self._last.items() if now - t > self.timeout
            }

    def _monitor(self) -> None:
        while not self._stop.wait(self.poll_interval):
            for w, age in self.dead_workers().items():
                with self._lock:
                    already = w in self._dead
                    self._dead[w] = age
                if not already and self.on_dead is not None:
                    self.on_dead(w, age)

    def start(self) -> "Heartbeat":
        self._thread = threading.Thread(target=self._monitor, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()

    def __enter__(self) -> "Heartbeat":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def reshard(state: Any, mesh: Mesh, specs: Any = None) -> Any:
    """Place every array of `state` onto `mesh`.

    specs: a pytree of PartitionSpecs matching `state`'s structure (a single
    PartitionSpec broadcasts to all leaves; None replicates everything).
    This is the elastic-resume primitive: restore a checkpoint host-side,
    then `reshard` it onto whatever devices survived.
    """
    if specs is None:
        specs = PartitionSpec()

    def place(leaf, spec):
        return jax.device_put(leaf, NamedSharding(mesh, spec))

    if isinstance(specs, PartitionSpec):
        return jax.tree_util.tree_map(lambda leaf: place(leaf, specs), state)
    return jax.tree_util.tree_map(place, state, specs)


class ElasticRunner:
    """Run `step_fn(state, step_idx) -> state` for `num_steps`, checkpointing
    every `checkpoint_every` steps; on an exception, restore the latest
    checkpoint, re-place it via `placement_fn(state)` (which should target
    the CURRENT mesh — possibly smaller after a failure) and continue from
    the checkpointed step.

    `max_restarts` bounds recovery attempts; exceeding it re-raises.
    """

    def __init__(
        self,
        step_fn: Callable[[Any, int], Any],
        checkpoint_dir: str,
        checkpoint_every: int = 1,
        placement_fn: Optional[Callable[[Any], Any]] = None,
        max_restarts: int = 3,
    ) -> None:
        self.step_fn = step_fn
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = max(1, checkpoint_every)
        self.placement_fn = placement_fn
        self.max_restarts = max_restarts
        self.restarts = 0

    def _save(self, state: Any, step: int) -> None:
        save_checkpoint(self.checkpoint_dir, {"state": state, "step": step})

    def _restore(self) -> tuple:
        payload, _ = load_checkpoint(self.checkpoint_dir)
        state = payload["state"]
        if self.placement_fn is not None:
            state = self.placement_fn(state)
        return state, int(payload["step"])

    def run(self, state: Any, num_steps: int, start_step: int = 0) -> Any:
        self._save(state, start_step)
        step = start_step
        while step < num_steps:
            try:
                state = self.step_fn(state, step)
                step += 1
                if step % self.checkpoint_every == 0 or step == num_steps:
                    self._save(state, step)
            except Exception:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                state, step = self._restore()
        return state
