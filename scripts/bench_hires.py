"""High-resolution two-view benchmark on the GPU — prints ONE JSON line.

The reference's working class is 540x768 (0.5x downscaled renders,
``/root/reference/src/CameraStereoVision.cpp:18``); production arrays ship
full sensor readouts. This times the two-view pipeline at 1080x1536:

  - flat 8-path SGM at D=128 and D=256;
  - the cascade (models/cascade.py) at D=256 — the large-range regime
    where the reference brackets rays per pixel.

Each program is warmed up, then ``ITERS`` calls are timed up to
``block_until_ready``; medians are reported with the card's name and
power limit. Exits non-zero without a GPU.

Usage: python scripts/bench_hires.py
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

H, W = 1080, 1536
ITERS = 7


def main():
    import jax
    import jax.numpy as jnp

    from stereovisionarray_tpu.compile_cache import enable_compile_cache
    from stereovisionarray_tpu.config import CostConfig, SGMConfig
    from stereovisionarray_tpu.models.cascade import cascade_two_view_disparity
    from stereovisionarray_tpu.models.two_view import two_view_disparity
    from stereovisionarray_tpu.utils.profiling import (
        card_label, median_ms, require_gpu, steady_times,
    )

    enable_compile_cache()
    dev = require_gpu()
    sgm = SGMConfig(p1=8.0, p2=96.0, num_paths=8, adaptive_p2=True)

    def cost(d):
        return CostConfig(num_disparities=d, census_window=(7, 9), dtype="int8")

    programs = {
        "flat_d128": lambda l, r: two_view_disparity(l, r, cost(128), sgm).disparity,
        "flat_d256": lambda l, r: two_view_disparity(l, r, cost(256), sgm).disparity,
        "cascade_d256": lambda l, r: cascade_two_view_disparity(
            l, r, cost(256), sgm, coarse_factor=4, fine_disparities=32,
            band_step=8).disparity,
    }
    base = np.random.default_rng(0).uniform(0.0, 255.0, (H, W + 64)).astype(np.float32)
    left = jax.device_put(jnp.asarray(base[:, :W]))
    right = jax.device_put(jnp.asarray(base[:, 64:]))
    report = {"shape_hw": [H, W], "samples": ITERS}
    for name, fn in programs.items():
        first_s, times = steady_times(jax.jit(fn), left, right, iters=ITERS)
        ms = median_ms(times)
        report[f"{name}_ms_per_frame_median"] = ms
        report[f"{name}_first_call_s"] = first_s
        report[f"{name}_mps"] = H * W / (ms * 1e-3) / 1e6
    report["card"] = card_label()
    report["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                        "count": len(jax.devices())}
    print(json.dumps(report, sort_keys=True))


if __name__ == "__main__":
    main()
