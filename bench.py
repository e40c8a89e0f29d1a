"""Two-view benchmark on the GPU — prints ONE JSON line.

Full pipeline per frame at 540x768, D=64: census+BT int8 cost volume,
8-path SGM (the Triton path kernel, ``backend="auto"``), WTA + subpixel +
uniqueness + LR extraction. The program is warmed up, then each of
``ITERS`` calls is timed on the host clock up to ``block_until_ready``;
the line reports the median, the card's name and power limit, and the
device JAX ran on. Exits non-zero without a GPU.

``vs_baseline``: the reference publishes no numbers (BASELINE.md), so the
baseline is an operation-count model of its hot loop
(``/root/reference/src/CameraStereoVision.cpp:49-95``): per pixel it scans
~64 Bresenham candidates x 41x41-patch SAD (~2 ops/element) single-threaded
=> ~2.2e5 ops/pixel; at an optimistic 15 Gop/s scalar CPU that is
~0.07 MP/s. vs_baseline = measured / 0.07.

Usage: python bench.py
"""

import json

import numpy as np

REF_EST_MPS = 0.07  # op-count model of the reference hot loop (docstring)

H, W, D = 540, 768, 64  # reference working resolution class (0.5x renders)
ITERS = 20


def main():
    import jax
    import jax.numpy as jnp

    from stereovisionarray_tpu.compile_cache import enable_compile_cache
    from stereovisionarray_tpu.config import CostConfig, SGMConfig
    from stereovisionarray_tpu.models.two_view import two_view_disparity
    from stereovisionarray_tpu.utils.profiling import (
        card_label, median_ms, require_gpu, steady_times,
    )

    enable_compile_cache()
    dev = require_gpu()
    cost_cfg = CostConfig(num_disparities=D, census_window=(7, 9), dtype="int8")
    sgm_cfg = SGMConfig(p1=8.0, p2=96.0, num_paths=8, adaptive_p2=True)
    fn = jax.jit(lambda l, r: two_view_disparity(l, r, cost_cfg, sgm_cfg).disparity)

    base = np.random.default_rng(0).uniform(0.0, 255.0, (H, W + 32)).astype(np.float32)
    left = jax.device_put(jnp.asarray(base[:, :W]))
    right = jax.device_put(jnp.asarray(base[:, 32:]))
    first_s, times = steady_times(fn, left, right, iters=ITERS)
    ms = median_ms(times)
    mps = H * W / (ms * 1e-3) / 1e6
    print(json.dumps({
        "metric": "two_view_sgm_throughput",
        "value": mps,
        "unit": "MP/s",
        "vs_baseline": mps / REF_EST_MPS,
        "ms_per_frame_median": ms,
        "ms_per_frame_max": max(times) * 1e3,
        "samples": len(times),
        "first_call_s": first_s,
        "shape": [H, W, D],
        "card": card_label(),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
