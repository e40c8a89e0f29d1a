"""Streaming multi-frame serving: decode → transfer → compute overlap.

The production loop the reference cannot express (one blocking run per
invocation, GUI waits in the middle of compute,
``/root/reference/src/functions.cpp:42-43``): a sequence of camera-array
frame sets streams through

  C++ prefetch decode (datasets/native_loader, worker threads)
    → host→device transfer (bounded look-ahead)
      → jitted array pipeline (one compiled program per frame set)
        → in-order results,

with every stage overlapped via :class:`~stereovisionarray_tpu.parallel.streaming.StreamExecutor`'s
bounded in-flight queue. Throughput scales with the slowest stage instead of
the sum of stages — the frames/s serving metric of BASELINE.json.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from stereovisionarray_tpu.config import EngineConfig
from stereovisionarray_tpu.geometry.camera import CameraArray
from stereovisionarray_tpu.models.array_pipeline import (
    ArrayPipelineOutput,
    array_depth_pipeline,
)
from stereovisionarray_tpu.parallel.streaming import StreamExecutor

__all__ = [
    "FrameResult",
    "TemporalFrameResult",
    "TemporalParams",
    "stream_depth_maps",
    "stream_depth_maps_chunked",
    "stream_temporal",
    "frame_sets_from_dirs",
]


class FrameResult(NamedTuple):
    index: int
    output: ArrayPipelineOutput
    decode_s: float  # host decode wall time for this frame set


def frame_sets_from_dirs(dirs: Sequence[str], half_res: bool = False,
                         threads: int = 4) -> Iterator[np.ndarray]:
    """Decode each directory of array views into an (N, H, W) stack, using
    the native prefetch loader when available."""
    from stereovisionarray_tpu.datasets import list_images_sorted, load_image_stack

    for d in dirs:
        paths = list_images_sorted(d)
        if not paths:
            raise ValueError(f"no images in {d!r}")
        yield load_image_stack(paths, half_res=half_res, threads=threads)


def stream_depth_maps(
    frame_sets: Iterable[np.ndarray],
    cameras: CameraArray,
    cfg: EngineConfig = EngineConfig(),
    ref_index: Optional[int] = None,
    use_roi: bool = False,
    depth: int = 2,
    transfer_dtype: Optional[np.dtype] = None,
) -> Iterator[FrameResult]:
    """Run the full array pipeline over a stream of (N, H, W) frame sets.

    Results arrive in order; up to `depth` frame sets are in flight
    (decoded + transferred + dispatched) ahead of the consumer. The
    pipeline compiles once (static config/shapes) and each call is one
    device program — with JAX async dispatch, frame t+1's decode and H2D
    overlap frame t's compute.

    transfer_dtype: dtype for the host->device copy (e.g. ``np.uint8`` for
    8-bit sources — 4x less transfer than float32, the bottleneck stage
    when the link is thin); the jitted step casts to float32 on-device.
    """

    def step(images_dev):
        return array_depth_pipeline(
            images_dev.astype(jnp.float32),  # on-device upcast, fused
            cameras, cfg, ref_index=ref_index, use_roi=use_roi
        )

    executor = StreamExecutor(step, depth=depth)

    def timed_frames():
        for frames in frame_sets:
            t0 = time.perf_counter()
            host = np.ascontiguousarray(frames)
            if transfer_dtype is not None:
                host = host.astype(transfer_dtype, copy=False)
            arr = jnp.asarray(host)
            yield arr, time.perf_counter() - t0

    decode_times: List[float] = []

    def frames_only():
        for arr, dt in timed_frames():
            decode_times.append(dt)
            yield arr

    for i, out in enumerate(executor.run(frames_only())):
        yield FrameResult(index=i, output=out, decode_s=decode_times[i])


class TemporalFrameResult(NamedTuple):
    index: int
    output: ArrayPipelineOutput  # the raw per-frame pipeline result
    temporal: "TemporalOutput"  # filtered disparity/valid/stability maps
    depth: jnp.ndarray  # (H, W) depth of the FILTERED disparity
    decode_s: float


class TemporalParams(NamedTuple):
    """Temporal-filter settings for the serving loop (``models/temporal.py``)."""

    baseline: float  # metric baseline B0 (``array_baselines``) for depth
    focal_px: float  # reference view's fx
    max_diff: float = 1.0
    max_weight: float = 8.0
    max_hole_age: int = 3


def stream_temporal(
    results: Iterable[FrameResult],
    baseline: float,
    focal_px: float,
    *,
    max_diff: float = 1.0,
    max_weight: float = 8.0,
    max_hole_age: int = 3,
) -> Iterator[TemporalFrameResult]:
    """Wrap a :func:`stream_depth_maps`/``_chunked`` result stream with the
    recursive temporal filter (``models/temporal.py``): disparity noise
    averages down across frames of a static scene, moving content resets in
    one frame, and short measurement holes coast. Confidence-weighted via
    the plane sweep's PKRN map. ``baseline``/``focal_px`` convert the
    filtered disparity back to depth (``array_baselines`` B0 and the rig's
    fx).

    DISPATCH COST: this wrapper issues one extra ``temporal_update``
    dispatch per frame on the host side — prefer
    ``stream_depth_maps_chunked(temporal=TemporalParams(...))``, which scans
    the filter INSIDE the chunked device program (zero extra dispatches)."""
    from stereovisionarray_tpu.models.temporal import temporal_init, temporal_update
    from stereovisionarray_tpu.models.two_view import disparity_to_depth

    state = None
    for fr in results:
        out = fr.output
        disp = out.refined_disparity
        if state is None:
            state = temporal_init(disp.shape)
        state, tout = temporal_update(
            state, disp, out.valid, out.sweep.confidence,
            max_diff=max_diff, max_weight=max_weight,
            max_hole_age=max_hole_age,
        )
        depth = jnp.where(
            tout.valid,
            disparity_to_depth(tout.disparity, baseline, focal_px),
            0.0,
        )
        yield TemporalFrameResult(
            index=fr.index, output=out, temporal=tout, depth=depth,
            decode_s=fr.decode_s,
        )


def stream_depth_maps_chunked(
    frame_sets: Iterable[np.ndarray],
    cameras: CameraArray,
    cfg: EngineConfig = EngineConfig(),
    ref_index: Optional[int] = None,
    use_roi: bool = False,
    depth: int = 2,
    chunk: int = 8,
    transfer_dtype: Optional[np.dtype] = None,
    temporal: Optional[TemporalParams] = None,
) -> Iterator[FrameResult]:
    """:func:`stream_depth_maps` with K frame sets per device program.

    temporal: when given, the recursive temporal filter runs as a
    ``lax.scan`` over the K sets INSIDE the chunked device program (state
    carried across chunks host-side as an async JAX value — no extra
    dispatches, no pipeline stall), yielding
    :class:`TemporalFrameResult` instead of :class:`FrameResult`.

    One jitted dispatch runs ``lax.map`` over a (K, N, H, W) chunk, so
    per-dispatch host overhead is paid once per K sets instead of once per
    set (whether that still pays on a directly attached GPU is not
    measured yet). Results still arrive
    strictly in order, one :class:`FrameResult` per input set; a ragged
    final chunk is padded with its last set (single compiled shape) and
    the padding is dropped before yielding. ``chunk=1`` falls back to the
    per-set path unchanged.

    The reference's anti-pattern being replaced: one blocking pipeline run
    per invocation with GUI waits inside the loop
    (``/root/reference/src/functions.cpp:42-43``)."""
    if chunk <= 1:
        base = stream_depth_maps(
            frame_sets, cameras, cfg, ref_index=ref_index, use_roi=use_roi,
            depth=depth, transfer_dtype=transfer_dtype,
        )
        if temporal is None:
            yield from base
        else:
            yield from stream_temporal(
                base, temporal.baseline, temporal.focal_px,
                max_diff=temporal.max_diff, max_weight=temporal.max_weight,
                max_hole_age=temporal.max_hole_age,
            )
        return

    def one(images):
        return array_depth_pipeline(
            images.astype(jnp.float32), cameras, cfg,
            ref_index=ref_index, use_roi=use_roi,
        )

    if temporal is None:
        @jax.jit
        def step(stack_dev):
            return jax.lax.map(one, stack_dev)
    else:
        from stereovisionarray_tpu.models.temporal import (
            temporal_init,
            temporal_update,
        )
        from stereovisionarray_tpu.models.two_view import disparity_to_depth

        @jax.jit
        def step_t(stack_dev, state):
            outs = jax.lax.map(one, stack_dev)

            def scan_step(st, kout):
                st2, tout = temporal_update(
                    st, kout.refined_disparity, kout.valid,
                    kout.sweep.confidence,
                    max_diff=temporal.max_diff,
                    max_weight=temporal.max_weight,
                    max_hole_age=temporal.max_hole_age,
                )
                depth_k = jnp.where(
                    tout.valid,
                    disparity_to_depth(tout.disparity, temporal.baseline,
                                       temporal.focal_px),
                    0.0,
                )
                return st2, (tout, depth_k)

            state2, (touts, depths) = jax.lax.scan(scan_step, state, outs)
            return outs, touts, depths, state2

        # the carry threads across chunks through this box; step() is only
        # ever called from StreamExecutor.run's single loop (serial,
        # submission order) and the state is an async JAX value, so the
        # chunk-to-chunk dependency costs no host sync
        state_box = {}

        def step(stack_dev):
            if "s" not in state_box:
                state_box["s"] = temporal_init(stack_dev.shape[-2:])
            outs, touts, depths, state_box["s"] = step_t(
                stack_dev, state_box["s"]
            )
            return outs, touts, depths

    executor = StreamExecutor(step, depth=depth)
    meta: List[Tuple[int, List[float]]] = []  # (real sets, decode times)

    def chunks() -> Iterator[np.ndarray]:
        buf: List[np.ndarray] = []
        times: List[float] = []
        for frames in frame_sets:
            t0 = time.perf_counter()
            host = np.ascontiguousarray(frames)
            if transfer_dtype is not None:
                host = host.astype(transfer_dtype, copy=False)
            buf.append(host)
            times.append(time.perf_counter() - t0)
            if len(buf) == chunk:
                meta.append((chunk, times))
                yield np.stack(buf)
                buf, times = [], []
        if buf:
            meta.append((len(buf), times))
            yield np.stack(buf + [buf[-1]] * (chunk - len(buf)))

    idx = 0
    for ci, out in enumerate(executor.run(chunks())):
        n_real, times = meta[ci]
        for k in range(n_real):
            if temporal is None:
                res = jax.tree_util.tree_map(lambda x, k=k: x[k], out)
                yield FrameResult(index=idx, output=res, decode_s=times[k])
            else:
                outs, touts, depths = out
                pick = lambda x, k=k: x[k]
                yield TemporalFrameResult(
                    index=idx,
                    output=jax.tree_util.tree_map(pick, outs),
                    temporal=jax.tree_util.tree_map(pick, touts),
                    depth=depths[k],
                    decode_s=times[k],
                )
            idx += 1
