"""Array-pipeline benchmark on the GPU — prints ONE JSON line.

The full camera-array pipeline of BASELINE.json config 3 at the
reference's working class: 5x5 views, 270x360, 128 sweep planes, CROSS
topology (``--topology TO_CENTER`` for the reference's 24-view default),
plane-sweep fusion + SGM + multi-view refinement — the reference's whole
`main()` (reference ``src/CameraStereoVision.cpp:10-123``) as one
program; ``--cascade`` runs the coarse-to-fine sweep. Warm-up, then
``ITERS`` calls timed up to ``block_until_ready``; median frame-sets/s,
the card's name and power limit. Exits non-zero without a GPU.

``vs_baseline``: the reference processes ONE frame-set per run,
single-threaded, at an estimated >= 60 s/frame-set (25 views x the
two-view hot-loop model in bench.py, ~0.07 MP/s over 0.097 MP per pair +
refine) => ~0.016 set/s. vs_baseline = measured/0.016.

Usage: python bench_array.py [--cascade] [--topology CROSS|TO_CENTER]
"""

import argparse
import json

REF_EST_SETS_PER_S = 0.016

ROWS = COLS = 5
H, W = 270, 360
PLANES = 128
ITERS = 10


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cascade", action="store_true")
    parser.add_argument("--topology", default="CROSS")
    args = parser.parse_args()
    topology = args.topology.upper()

    import jax
    import jax.numpy as jnp

    from stereovisionarray_tpu.compile_cache import enable_compile_cache
    from stereovisionarray_tpu.config import EngineConfig
    from stereovisionarray_tpu.datasets import SceneSpec, reference_rig, render_camera_array
    from stereovisionarray_tpu.models import array_depth_pipeline
    from stereovisionarray_tpu.utils.profiling import (
        card_label, median_ms, require_gpu, steady_times,
    )

    enable_compile_cache()
    dev = require_gpu()
    cams = reference_rig(rows=ROWS, cols=COLS, spacing=0.05, resolution=(H, W))
    images, _ = render_camera_array(cams, (H, W), SceneSpec())
    overrides = {
        "camera.rows": ROWS,
        "camera.cols": COLS,
        "plane_sweep.num_planes": PLANES,
        "plane_sweep.topology": topology,
    }
    if args.cascade:
        overrides["plane_sweep.cascade"] = True
        overrides["plane_sweep.cascade_fine_planes"] = 48
    cfg = EngineConfig().override(**overrides)
    fn = jax.jit(lambda imgs: array_depth_pipeline(imgs, cams, cfg).refined_depth)
    x = jax.device_put(jnp.asarray(images))
    first_s, times = steady_times(fn, x, iters=ITERS)
    ms = median_ms(times)
    sets_per_s = 1e3 / ms
    print(json.dumps({
        "metric": "array_pipeline_throughput"
        + ("_cascade" if args.cascade else "")
        + ("_" + topology.lower() if topology != "CROSS" else ""),
        "value": sets_per_s,
        "unit": "frame_sets/s",
        "vs_baseline": sets_per_s / REF_EST_SETS_PER_S,
        "ms_per_frame_set_median": ms,
        "ms_per_frame_set_max": max(times) * 1e3,
        "samples": len(times),
        "first_call_s": first_s,
        "shape": [ROWS * COLS, H, W, PLANES],
        "topology": topology,
        "card": card_label(),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
