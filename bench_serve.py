"""Serving benchmark on the GPU — ONE JSON line: sustained streaming
frame-sets/s.

End-to-end serving loop (models/serving.stream_depth_maps_chunked): C++
prefetch PNG decode -> host->device transfer -> jitted 5x5 array pipeline,
all overlapped by StreamExecutor's bounded in-flight queue. Unlike
bench.py / bench_array.py, this measures the WHOLE serving path including
decode and transport — the frames/s serving metric of BASELINE.json. Names
the card and its power limit; exits non-zero without a GPU.

``vs_baseline``: the reference runs ONE frame-set per process, blocking on
GUI windows mid-compute (``/root/reference/src/functions.cpp:42-43``);
~0.016 set/s by the op-count model in bench_array.py.
"""

import json
import os
import tempfile
import time

import numpy as np

REF_EST_SETS_PER_S = 0.016

ROWS = COLS = 5
H, W = 270, 360
PLANES = 128
N_SETS = 24
WARM_SETS = 8
CHUNK = 8


def main():
    import jax

    from stereovisionarray_tpu.compile_cache import enable_compile_cache
    from stereovisionarray_tpu.utils.profiling import card_label, require_gpu

    enable_compile_cache()
    dev = require_gpu()

    from stereovisionarray_tpu.config import EngineConfig
    from stereovisionarray_tpu.datasets import (
        SceneSpec,
        reference_rig,
        render_camera_array,
        save_png,
    )
    from stereovisionarray_tpu.models.serving import (
        frame_sets_from_dirs,
        stream_depth_maps_chunked,
    )

    from stereovisionarray_tpu.models.serving import TemporalParams

    cams = reference_rig(rows=ROWS, cols=COLS, spacing=0.05, resolution=(H, W))
    base_over = {
        "camera.rows": ROWS,
        "camera.cols": COLS,
        "plane_sweep.num_planes": PLANES,
        "plane_sweep.topology": "CROSS",
    }
    cfg = EngineConfig().override(**base_over)
    # the COMPOSED production path (VERDICT r4 item 8): coarse-to-fine
    # cascade + in-program temporal scan, same protocol
    cfg_composed = EngineConfig().override(**{
        **base_over,
        "plane_sweep.cascade": True,
        "plane_sweep.cascade_fine_planes": 48,
    })
    tparams = TemporalParams(baseline=0.05,
                             focal_px=float(np.asarray(cams.fx)[12]))

    with tempfile.TemporaryDirectory(prefix="svt_serve_") as root:
        # materialize distinct frame sets as PNG directories (decode must be
        # part of the measured path; frames vary so nothing caches)
        rng = np.random.default_rng(0)
        dirs = []
        base, _ = render_camera_array(cams, (H, W), SceneSpec())
        base = np.asarray(base)
        for i in range(N_SETS + WARM_SETS):
            d = os.path.join(root, f"set_{i:03d}")
            os.makedirs(d)
            jitter = rng.normal(0.0, 2.0, size=base.shape[1:]).astype(np.float32)
            stack = np.clip(base + jitter[None], 0.0, 255.0)
            for v in range(base.shape[0]):
                save_png(os.path.join(d, f"view_{v:02d}.png"),
                         stack[v].astype(np.uint8))
            dirs.append(d)

        def run(dset, cfg_run, temporal):
            n = 0
            for res in stream_depth_maps_chunked(
                frame_sets_from_dirs(dset), cams, cfg_run, depth=3,
                chunk=CHUNK,  # K sets per device program
                transfer_dtype=np.uint8,  # 8-bit sources: 4x less H2D
                temporal=temporal,
            ):
                # touch the result so device->host completion is included
                out = res.depth if temporal is not None else (
                    res.output.refined_depth)
                float(np.asarray(out).sum())
                n += 1
            return n

        rows = {}
        for name, cfg_run, temporal in (
            ("flat", cfg, None),
            ("composed_cascade_temporal", cfg_composed, tparams),
        ):
            run(dirs[:WARM_SETS], cfg_run, temporal)  # compile + warm
            t0 = time.perf_counter()
            n = run(dirs[WARM_SETS:], cfg_run, temporal)
            dt = time.perf_counter() - t0
            sets_per_s = n / dt
            rows[name] = {
                "value": sets_per_s,
                "unit": "frame_sets/s",
                "vs_baseline": sets_per_s / REF_EST_SETS_PER_S,
                "ms_per_frame_set": dt / n * 1e3,
                "sets": n,
            }

    flat = rows["flat"]
    print(
        json.dumps(
            {
                "metric": "serving_throughput",
                **flat,
                "includes": "PNG decode + H2D + compute + D2H, overlapped",
                "chunk": CHUNK,
                "shape": [ROWS * COLS, H, W, PLANES],
                "composed_cascade_temporal":
                    rows["composed_cascade_temporal"],
                "card": card_label(),
                "device": {"platform": dev.platform, "kind": dev.device_kind,
                           "count": len(jax.devices())},
            }
        )
    )


if __name__ == "__main__":
    main()
