"""Chip smoke test: drive the engine's main path once on one NVIDIA GPU.

Every phase is a real run through the entry points a user calls, at the
sizes users run, on inputs rendered from ``--seed`` by
``datasets/synthetic.py``; every hand-written kernel runs compiled for the
card and is compared with the plain XLA reference at a real width:

1. two-view 540x768, D=64, census (7,9), 8 paths, adaptive P2
   (``two_view_disparity``, backend "auto"); the Triton SGM kernel against
   the XLA scans on the same int16 and float32 volumes; bad-2 against the
   rendered ground truth;
2. two-view 1080x1536: flat at D=128, cascade at D=256; the bilinear
   sampler against the hat-sum formula; cascade against flat D=256;
3. the 5x5 array at 270x360, 128 planes (``array_depth_pipeline``): CROSS
   flat, CROSS cascade, TO_CENTER with 24 views and top-k fusion; median
   relative depth error against ground truth; kernel against XLA on the
   plane volume;
4. serving: ``stream_depth_maps_chunked`` over 16 seeded 5x5 frame sets;
5. calibration: ``calibrate_array`` on a perturbed 5x5 270x360 rig;
6. CLI: ``render`` then ``depth`` through ``cli.main`` in this process.

For each program it prints compile time, the median of a few steady calls
(each ended by ``block_until_ready``) with the card's name and power limit,
``compiled.memory_analysis()``, the device's ``peak_bytes_in_use``, and
every comparison with its tolerance. Any failed check or error ends the run
with a non-zero status; there is no fallback to the CPU.

``--chips 4`` runs only the multi-card paths, each against its one-card
run: ``sharded_two_view_disparity`` at 1080x1536x128 on a (1,4,1) halo mesh
and a (1,1,4) disparity mesh, ``sharded_plane_sweep_depth`` and
``sharded_cascade_sweep_depth`` over 4 plane shards, and
``distributed_bundle_adjust`` against ``sfm/ba.py``.

The last line of standard output is the JSON contract line
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.

Usage: python chip_smoke.py [--seed N] [--chips 1|4]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time

import numpy as np

BASELINE_M = 0.045  # two-view baseline: d = fx * B / z stays inside D


class Reporter:
    """Compiles, times and checks programs, printing one block per program."""

    def __init__(self, card: str, device):
        self.card = card
        self.device = device

    def program(self, label, fn, *args, iters=3):
        import jax

        t0 = time.perf_counter()
        compiled = jax.jit(fn).lower(*args).compile()
        compile_s = time.perf_counter() - t0
        out = jax.block_until_ready(compiled(*args))
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            out = jax.block_until_ready(compiled(*args))
            times.append(time.perf_counter() - t0)
        steady = float(np.median(times))
        print(f"  [{label}] compile {compile_s:.2f} s | steady {steady * 1e3:.3f} ms "
              f"(median of {iters}) on {self.card}", flush=True)
        print(f"  [{label}] memory_analysis: {_memory(compiled)} | "
              f"peak_bytes_in_use {self.peak()}", flush=True)
        return out, steady

    def timed(self, label, fn, iters=1):
        """A host-driven entry point (not one jitted program): first call
        (compile included) and the median of ``iters`` further calls."""
        t0 = time.perf_counter()
        out = fn()
        first = time.perf_counter() - t0
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            out = fn()
            times.append(time.perf_counter() - t0)
        steady = float(np.median(times)) if times else None
        shown = f"{steady * 1e3:.3f} ms" if times else "not measured (one call)"
        print(f"  [{label}] first call (compiles) {first:.2f} s | steady {shown} "
              f"on {self.card} | memory_analysis: n/a (several programs) | "
              f"peak_bytes_in_use {self.peak()}", flush=True)
        return out, steady

    def peak(self):
        stats = self.device.memory_stats() or {}
        return stats.get("peak_bytes_in_use")

    @staticmethod
    def check(label, value, op, bound):
        ok = {"<": value < bound, "<=": value <= bound, ">": value > bound,
              "==": value == bound}[op]
        print(f"  check {label}: {value!r} {op} {bound!r} -> {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            raise SystemExit(f"check failed: {label}: {value!r} {op} {bound!r}")


def _memory(compiled):
    m = compiled.memory_analysis()
    if m is None:
        return "None"
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "alias_size_in_bytes",
              "generated_code_size_in_bytes")
    return ", ".join(f"{f}={getattr(m, f, None)}" for f in fields)


def stereo_pair(seed, h, w):
    """Rectified pair from a 1x2 rig: (left, right, gt disparity, mask of
    in-view, non-occluded pixels away from the census border)."""
    from stereovisionarray_tpu.datasets import SceneSpec, reference_rig, render_camera_array

    cams = reference_rig(rows=1, cols=2, spacing=BASELINE_M,
                         origin=(-BASELINE_M / 2, 0.0), resolution=(h, w))
    imgs, depths = render_camera_array(cams, (h, w), SceneSpec(texture_seed=seed))
    fx = float(np.asarray(cams.fx)[0])
    d_left = fx * BASELINE_M / depths[0]
    d_right = fx * BASELINE_M / depths[1]
    x = np.arange(w)[None, :]
    xr = np.round(x - d_left).astype(np.int64)
    in_view = xr >= 0
    d_at = np.take_along_axis(d_right, np.clip(xr, 0, w - 1), axis=1)
    mask = in_view & (np.abs(d_at - d_left) < 1.0)
    mask[:8], mask[-8:], mask[:, :8], mask[:, -8:] = False, False, False, False
    return imgs[0], imgs[1], d_left.astype(np.float32), mask


def bad_fraction(disp, gt, mask, tau=2.0):
    """Share of masked pixels that are invalid or off by more than tau."""
    d = np.asarray(disp)
    bad = (d < 0) | (np.abs(d - gt) > tau)
    return float(bad[mask].mean())


def compare_sgm(rep, vol, image, sgm, backend, tol):
    """The Triton kernel against the XLA scans on one volume."""
    from stereovisionarray_tpu.models.two_view import sgm_penalties
    from stereovisionarray_tpu.ops.sgm import sgm_aggregate

    pens = sgm_penalties(sgm, vol.dtype)
    kw = dict(num_paths=sgm.num_paths, image=image, adaptive_p2=sgm.adaptive_p2)
    shape = "x".join(map(str, vol.shape))
    agg_k, t_k = rep.program(
        f"SGM {shape} {vol.dtype} Triton kernel",
        lambda v, im: sgm_aggregate(v, **{**kw, "image": im}, backend=backend, **pens),
        vol, image)
    agg_x, t_x = rep.program(
        f"SGM {shape} {vol.dtype} XLA scans",
        lambda v, im: sgm_aggregate(v, **{**kw, "image": im}, backend="xla", **pens),
        vol, image)
    diff = float(np.max(np.abs(np.asarray(agg_k, np.float64) - np.asarray(agg_x, np.float64))))
    rep.check(f"SGM kernel vs XLA max|d| {shape} {vol.dtype}", diff, "<=", tol)
    print(f"  SGM aggregation {shape} {vol.dtype}: kernel {t_k * 1e3:.3f} ms, "
          f"XLA {t_x * 1e3:.3f} ms on {rep.card}", flush=True)
    return t_k, t_x


def phase_two_view(rep, seed, h=540, w=768, d=64, backend="pallas"):
    import jax.numpy as jnp

    from stereovisionarray_tpu.config import CostConfig, SGMConfig
    from stereovisionarray_tpu.models.two_view import two_view_disparity
    from stereovisionarray_tpu.ops.cost_volume import fused_cost_volume

    print(f"phase 1: two-view {h}x{w}, D={d}", flush=True)
    left, right, gt, mask = stereo_pair(seed, h, w)
    left, right = jnp.asarray(left), jnp.asarray(right)
    cost = CostConfig(num_disparities=d, census_window=(7, 9))  # int16
    sgm = SGMConfig()  # 8 paths, adaptive P2
    out, t_auto = rep.program(
        "two_view_disparity auto",
        lambda l, r: two_view_disparity(l, r, cost, sgm, backend="auto"), left, right)
    _, t_xla = rep.program(
        "two_view_disparity xla",
        lambda l, r: two_view_disparity(l, r, cost, sgm, backend="xla"), left, right)
    print(f"  whole frame {h}x{w}x{d}: auto {t_auto * 1e3:.3f} ms, xla "
          f"{t_xla * 1e3:.3f} ms on {rep.card}", flush=True)
    rep.check("bad-2 vs ground truth, non-occluded (drive_two_view bound)",
              bad_fraction(out.disparity, gt, mask), "<", 0.03)
    for dtype, tol in (("int16", 0.0), ("float32", 1e-3 * sgm.p2)):
        vol, _ = rep.program(
            f"fused_cost_volume {dtype}",
            lambda l, r: fused_cost_volume(l, r, d, cost.census_window, dtype=dtype),
            left, right)
        compare_sgm(rep, vol, left, sgm, backend, tol)


def phase_hires(rep, seed, h=1080, w=1536, backend="pallas"):
    import jax
    import jax.numpy as jnp

    from stereovisionarray_tpu.config import CostConfig, SGMConfig
    from stereovisionarray_tpu.models.cascade import SMOOTH_R, cascade_two_view_disparity
    from stereovisionarray_tpu.models.two_view import two_view_disparity
    from stereovisionarray_tpu.ops.cost_volume import fused_cost_volume
    from stereovisionarray_tpu.ops.hatsample import hat_sample, hat_sample_reference

    print(f"phase 2: two-view {h}x{w}, flat D=128, cascade D=256", flush=True)
    left, right, gt, mask = stereo_pair(seed + 1, h, w)
    left, right = jnp.asarray(left), jnp.asarray(right)
    sgm = SGMConfig()
    c128 = CostConfig(num_disparities=128, census_window=(7, 9))
    c256 = CostConfig(num_disparities=256, census_window=(7, 9))
    flat128, t_auto = rep.program(
        "two_view_disparity D=128 auto",
        lambda l, r: two_view_disparity(l, r, c128, sgm, backend="auto"), left, right)
    _, t_xla = rep.program(
        "two_view_disparity D=128 xla",
        lambda l, r: two_view_disparity(l, r, c128, sgm, backend="xla"), left, right)
    print(f"  whole frame {h}x{w}x128: auto {t_auto * 1e3:.3f} ms, xla "
          f"{t_xla * 1e3:.3f} ms on {rep.card}", flush=True)
    print(f"  flat D=128 bad-2 vs ground truth: {bad_fraction(flat128.disparity, gt, mask)}",
          flush=True)
    vol, _ = rep.program(
        "fused_cost_volume int16 D=128",
        lambda l, r: fused_cost_volume(l, r, 128, c128.census_window, dtype="int16"),
        left, right)
    compare_sgm(rep, vol, left, sgm, backend, 0.0)
    del vol

    # the bilinear sampler against the every-tap hat sum, at these widths
    key = jax.random.PRNGKey(seed)
    t = jax.random.uniform(key, (h, w), minval=-SMOOTH_R - 2.0, maxval=SMOOTH_R + 2.0)
    aux = jax.random.uniform(jax.random.fold_in(key, 1), (w,), maxval=255.0)
    new, _ = rep.program("hat_sample (gather)",
                         lambda v, tt, a: hat_sample(v, tt, -SMOOTH_R, SMOOTH_R, aux=a),
                         left, t, aux)
    old, _ = rep.program("hat_sample_reference (hat sum)",
                         lambda v, tt, a: hat_sample_reference(v, tt, -SMOOTH_R, SMOOTH_R, aux=a),
                         left, t, aux)
    for i, name in enumerate(("values", "aux")):
        diff = float(jnp.max(jnp.abs(new[i] - old[i])))
        rep.check(f"bilinear sampler vs hat sum max|d| ({name}, [0, 255])", diff, "<=", 1e-4)

    flat256, _ = rep.program(
        "two_view_disparity D=256 auto",
        lambda l, r: two_view_disparity(l, r, c256, sgm, backend="auto"), left, right)
    casc, _ = rep.program(
        "cascade_two_view_disparity D=256 auto",
        lambda l, r: cascade_two_view_disparity(
            l, r, c256, sgm, coarse_factor=4, fine_disparities=32, band_step=8,
            backend="auto"), left, right)
    fd, cd = np.asarray(flat256.disparity), np.asarray(casc.disparity)
    both = mask & (fd >= 0) & (cd >= 0)
    rep.check("cascade/flat both-valid share of non-occluded", float(both.mean() / mask.mean()),
              ">", 0.5)
    agree = float((np.abs(cd - fd)[both] <= 1.0).mean())
    rep.check("cascade vs flat D=256, |d| <= 1 px share (test_cascade bound)",
              agree, ">", 0.95)
    print(f"  bad-2 vs ground truth: flat D=256 {bad_fraction(fd, gt, mask)}, cascade "
          f"{bad_fraction(cd, gt, mask)}", flush=True)


def _array_cfg(overrides):
    from stereovisionarray_tpu.config import EngineConfig

    return EngineConfig().override(**{"camera.rows": 5, "camera.cols": 5,
                                      "plane_sweep.num_planes": 128, **overrides})


def array_scene(seed, res):
    from stereovisionarray_tpu.datasets import SceneSpec, reference_rig, render_camera_array

    cams = reference_rig(rows=5, cols=5, spacing=0.05, resolution=res)
    images, depths = render_camera_array(cams, res, SceneSpec(texture_seed=seed))
    return cams, images, depths


def depth_errors(out, gt):
    valid = np.asarray(out.valid)
    inner = np.zeros_like(valid)
    inner[8:-8, 8:-8] = True
    sel = valid & inner
    rel = lambda d: np.abs(np.asarray(d) - gt)[sel] / gt[sel]
    return float(sel.sum() / inner.sum()), float(np.median(rel(out.depth))), float(
        np.median(rel(out.refined_depth)))


def phase_array(rep, seed, res=(270, 360), backend="pallas"):
    import jax.numpy as jnp

    from stereovisionarray_tpu.models import array_depth_pipeline
    from stereovisionarray_tpu.models.plane_sweep import plane_sweep_volume
    from stereovisionarray_tpu.models.array_pipeline import reference_and_sources

    print(f"phase 3: 5x5 array {res[0]}x{res[1]}, 128 planes", flush=True)
    cams, images, depths = array_scene(seed + 2, res)
    imgs = jnp.asarray(images)
    forms = (
        ("CROSS flat", {"plane_sweep.topology": "CROSS"}),
        ("CROSS cascade", {"plane_sweep.topology": "CROSS", "plane_sweep.cascade": True,
                           "plane_sweep.cascade_fine_planes": 48}),
        ("TO_CENTER 24 views top-k", {"plane_sweep.topology": "TO_CENTER",
                                      "plane_sweep.fusion": "topk_mean"}),
    )
    for name, over in forms:
        cfg = _array_cfg(over)
        ref, src = reference_and_sources(cfg, len(images))
        out, t_auto = rep.program(f"array_depth_pipeline {name}",
                                  lambda x: array_depth_pipeline(x, cams, cfg), imgs)
        cover, med, med_ref = depth_errors(out, depths[ref])
        print(f"  {name}: {len(src)} source views, coverage {cover}", flush=True)
        rep.check(f"{name} valid share of interior", cover, ">", 0.9)
        rep.check(f"{name} median rel depth err (test_array_pipeline bound)", med, "<", 0.02)
        rep.check(f"{name} refined median rel depth err", med_ref, "<", 0.03)
        if name == "CROSS flat":
            _, t_xla = rep.program(
                f"array_depth_pipeline {name} xla",
                lambda x: array_depth_pipeline(x, cams, cfg, backend="xla"), imgs)
            print(f"  whole frame set 5x5x{res[0]}x{res[1]}x128: auto {t_auto * 1e3:.3f} ms,"
                  f" xla {t_xla * 1e3:.3f} ms on {rep.card}", flush=True)
            vol, _ = rep.program(
                "plane_sweep_volume CROSS",
                lambda x: plane_sweep_volume(x, cams, ref, src, cfg.plane_sweep)[0], imgs)
            compare_sgm(rep, vol, imgs[ref], cfg.sgm, backend, 1e-3 * cfg.sgm.p2)


def phase_serving(rep, seed, res=(270, 360), n_sets=16):
    from stereovisionarray_tpu.models.serving import stream_depth_maps_chunked

    print(f"phase 4: serving {n_sets} frame sets 5x5x{res[0]}x{res[1]}", flush=True)
    cams, images, _ = array_scene(seed + 3, res)
    rng = np.random.default_rng(seed)
    sets = [np.clip(images + rng.normal(0.0, 2.0, images.shape), 0.0, 255.0).astype(np.float32)
            for _ in range(n_sets)]
    cfg = _array_cfg({"plane_sweep.topology": "CROSS"})

    def serve():
        return [(r.index, np.asarray(r.output.refined_depth))
                for r in stream_depth_maps_chunked(iter(sets), cams, cfg, chunk=8)]

    results, steady = rep.timed(f"stream_depth_maps_chunked x{n_sets}", serve)
    rep.check("results arrive in order", [i for i, _ in results], "==", list(range(n_sets)))
    rep.check("every depth map finite", all(np.isfinite(d).all() for _, d in results),
              "==", True)
    print(f"  serving: {n_sets / steady:.3f} frame sets/s on {rep.card}", flush=True)


def phase_calibration(rep, seed, res=(270, 360)):
    import jax.numpy as jnp

    from stereovisionarray_tpu.config import SfMConfig
    from stereovisionarray_tpu.evaluation.metrics import absolute_trajectory_error
    from stereovisionarray_tpu.geometry.camera import make_camera_array
    from stereovisionarray_tpu.models.calibration import calibrate_array

    print(f"phase 5: calibration 5x5 {res[0]}x{res[1]}", flush=True)
    cams, images, _ = array_scene(seed + 4, res)
    t_bad = np.asarray(cams.t).copy()
    t_bad[1:] += np.random.default_rng(seed).normal(0, 0.01, t_bad[1:].shape).astype(np.float32)
    init = make_camera_array(cams.fx, cams.fy, cams.cx, cams.cy, np.asarray(cams.R), t_bad)
    cfg = SfMConfig(max_features=512, ba_iterations=30, ba_damping=1e-3)
    imgs = jnp.asarray(images)
    out, _ = rep.timed("calibrate_array",
                       lambda: calibrate_array(imgs, init, 12, cfg, rounds=2))
    ate = lambda c: float(absolute_trajectory_error(c.centers, cams.centers, align_scale=True))
    ate0, ate1 = ate(init), ate(out.cameras)
    print(f"  ATE initial {ate0 * 1e3:.4f} mm, calibrated {ate1 * 1e3:.4f} mm; "
          f"{int(out.num_obs)} observations", flush=True)
    rep.check("calibrated ATE (m, test_sfm bound)", ate1, "<", 0.0015)
    rep.check("ATE reduction factor", ate0 / max(ate1, 1e-12), ">", 4.0)


def phase_cli(rep, seed):
    from stereovisionarray_tpu import cli

    print("phase 6: CLI render + depth (in process)", flush=True)
    with tempfile.TemporaryDirectory(prefix="svt_smoke_") as tmp:
        data, out = os.path.join(tmp, "data"), os.path.join(tmp, "out")

        def run(argv):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(argv)
            rep.check(f"cli {argv[0]} exit status", rc, "==", 0)
            return json.loads(buf.getvalue().strip().splitlines()[-1])

        rendered, _ = rep.timed("cli render", lambda: run(
            ["render", "--output", data, "--set", f"seed={seed}"]), iters=0)
        print(f"  render: {rendered}", flush=True)
        result, _ = rep.timed("cli depth", lambda: run(
            ["depth", "--input", data, "--output", out]), iters=0)
        print(f"  depth: {result}", flush=True)
        rep.check("cli depth median rel err vs ground truth", result["median_rel_err"], "<", 0.03)
        rep.check("cli depth valid share", result["valid_fraction"], ">", 0.5)


def four_card_phases(rep, seed, hires=(1080, 1536), res=(270, 360)):
    """The multi-card paths, each against its one-card run."""
    import jax
    import jax.numpy as jnp

    from stereovisionarray_tpu.config import CostConfig, SGMConfig
    from stereovisionarray_tpu.models.array_pipeline import _shift_warp_pad, reference_and_sources
    from stereovisionarray_tpu.models.cascade_sweep import (
        cascade_plane_sweep_depth, cascade_static_params,
    )
    from stereovisionarray_tpu.models.plane_sweep import plane_sweep_depth
    from stereovisionarray_tpu.models.two_view import two_view_disparity
    from stereovisionarray_tpu.parallel import (
        make_mesh, sharded_cascade_sweep_depth, sharded_plane_sweep_depth,
        sharded_two_view_disparity,
    )

    def spread(label, arr):
        devs = arr.sharding.device_set
        print(f"  {label}: sharding {arr.sharding}", flush=True)
        rep.check(f"{label} spans devices", len(devs), "==", 4)

    print(f"four cards: sharded two-view {hires[0]}x{hires[1]}, D=128", flush=True)
    left, right, _, mask = stereo_pair(seed + 1, *hires)
    left, right = jnp.asarray(left), jnp.asarray(right)
    cost = CostConfig(num_disparities=128, census_window=(7, 9))
    sgm = SGMConfig()
    ref, _ = rep.program("two_view_disparity one card",
                         lambda l, r: two_view_disparity(l, r, cost, sgm), left, right)
    d_ref = np.asarray(ref.disparity)
    for shape, exact in (((1, 4, 1), False), ((1, 1, 4), True)):
        mesh = make_mesh(*shape)
        out, _ = rep.timed(f"sharded_two_view_disparity mesh {shape}", lambda: jax.block_until_ready(
            sharded_two_view_disparity(left[None], right[None], mesh, cost, sgm)), iters=2)
        spread(f"two-view disparity on {shape}", out.disparity)
        d = np.asarray(out.disparity)[0]
        same = (d == d_ref) | ((d < 0) & (d_ref < 0))
        if exact:
            rep.check(f"mesh {shape} equal to one card (share)", float(same.mean()), "==", 1.0)
        else:  # halo mode truncates path history at the tile seams
            close = float((np.abs(d - d_ref) < 0.5)[mask].mean())
            rep.check(f"mesh {shape} within 0.5 px of one card (test_parallel bound)",
                      close, ">", 0.97)

    print(f"four cards: plane-sharded sweeps 5x5x{res[0]}x{res[1]}x128", flush=True)
    cams, images, _ = array_scene(seed + 2, res)
    imgs = jnp.asarray(images)
    mesh = make_mesh(1, 1, 4)
    from stereovisionarray_tpu.config import EngineConfig

    cfg = EngineConfig().override(**{"camera.rows": 5, "camera.cols": 5,
                                     "plane_sweep.num_planes": 128,
                                     "plane_sweep.topology": "CROSS"})
    ref_i, src = reference_and_sources(cfg, len(images))
    pad = _shift_warp_pad(cams, ref_i, src, cfg)
    ps, sgm_ps = cfg.plane_sweep, SGMConfig(lr_max_diff=0.0)
    one, _ = rep.program("plane_sweep_depth one card",
                         lambda x: plane_sweep_depth(x, cams, ref_i, src, ps, sgm_ps,
                                                     shift_pad=pad), imgs)
    sh, _ = rep.timed("sharded_plane_sweep_depth 4 plane shards", lambda: jax.block_until_ready(
        sharded_plane_sweep_depth(imgs[None], cams, ref_i, src, mesh, ps, sgm_ps,
                                  shift_pad=pad)), iters=2)
    spread("plane sweep depth", sh.depth)
    _sweep_agree(rep, "plane sweep", sh, one)
    bo, _ = cascade_static_params(cams, ref_i, src, ps, 48)
    ckw = dict(shift_pad=pad, coarse_factor=4, fine_planes=48, band_step=8, band_offsets=bo)
    one_c, _ = rep.program("cascade_plane_sweep_depth one card",
                           lambda x: cascade_plane_sweep_depth(x, cams, ref_i, src, ps, sgm_ps,
                                                               **ckw), imgs)
    sh_c, _ = rep.timed("sharded_cascade_sweep_depth 4 plane shards", lambda: jax.block_until_ready(
        sharded_cascade_sweep_depth(imgs[None], cams, ref_i, src, mesh, ps, sgm_ps, **ckw)),
        iters=2)
    spread("cascade sweep depth", sh_c.depth)
    _sweep_agree(rep, "cascade sweep", sh_c, one_c)

    print("four cards: observation-sharded bundle adjustment", flush=True)
    _four_card_ba(rep, seed)


def _sweep_agree(rep, label, sharded, one):
    d_sh, d_one = np.asarray(sharded.depth)[0], np.asarray(one.depth)
    both = np.asarray(sharded.valid)[0] & np.asarray(one.valid)
    rel = np.abs(d_sh - d_one)[both] / np.maximum(d_one[both], 1e-6)
    # psum adds path subsets in another float32 order than one card
    rep.check(f"{label} median rel depth diff (test_parallel bound)",
              float(np.median(rel)), "<", 1e-3)
    rep.check(f"{label} share within 2% (test_parallel bound)",
              float((rel < 0.02).mean()), ">", 0.97)


def _four_card_ba(rep, seed):
    import jax
    import jax.numpy as jnp

    from stereovisionarray_tpu.datasets import reference_rig
    from stereovisionarray_tpu.parallel import make_mesh
    from stereovisionarray_tpu.parallel.ba import distributed_bundle_adjust
    from stereovisionarray_tpu.sfm.ba import BAProblem, bundle_adjust

    rng = np.random.default_rng(seed)
    cams = reference_rig(rows=5, cols=5, spacing=0.05, resolution=(270, 360))
    n_pts = 512
    X = np.stack([rng.uniform(-0.08, 0.08, n_pts), rng.uniform(-0.08, 0.08, n_pts),
                  rng.uniform(0.1, 0.3, n_pts)], axis=-1).astype(np.float32)
    ci = np.repeat(np.arange(len(cams)), n_pts).astype(np.int32)
    pi = np.tile(np.arange(n_pts), len(cams)).astype(np.int32)
    uv, _ = cams[jnp.asarray(ci)].project_each(jnp.asarray(X)[jnp.asarray(pi)])
    uv_c = np.asarray(uv) - np.stack([np.asarray(cams.cx)[ci], np.asarray(cams.cy)[ci]], -1)
    X_bad = jnp.asarray(X + rng.normal(0, 0.005, X.shape).astype(np.float32))
    prob = BAProblem(cam_idx=jnp.asarray(ci), pt_idx=jnp.asarray(pi),
                     uv=jnp.asarray(uv_c), valid=jnp.ones(len(ci), dtype=bool))
    one, _ = rep.timed("bundle_adjust one card",
                       lambda: jax.block_until_ready(bundle_adjust(cams, X_bad, prob, iterations=8)),
                       iters=2)
    mesh = make_mesh(1, 1, 4)
    dist, _ = rep.timed("distributed_bundle_adjust 4 cards", lambda: jax.block_until_ready(
        distributed_bundle_adjust(cams, X_bad, prob, mesh, iterations=8)), iters=2)
    dc = float(np.max(np.abs(np.asarray(dist.cameras.centers) - np.asarray(one.cameras.centers))))
    dp = float(np.max(np.abs(np.asarray(dist.points) - np.asarray(one.points))))
    rep.check("BA final cost", float(np.asarray(dist.cost)[-1]), "<", 1e-6)
    rep.check("BA centers max|d| vs one card (test_parallel tolerance)", dc, "<", 1e-5)
    rep.check("BA points max|d| vs one card (test_parallel tolerance)", dp, "<", 1e-4)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Chip smoke test (see module docstring)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--chips", type=int, choices=(1, 4), default=1)
    args = parser.parse_args(argv)

    import jax

    from stereovisionarray_tpu.compile_cache import enable_compile_cache
    from stereovisionarray_tpu.utils.profiling import card_label

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX's first device is {dev.platform!r}",
              file=sys.stderr)
        return 2
    if len(jax.devices()) < args.chips:
        print(f"chip_smoke: --chips {args.chips} but JAX sees {len(jax.devices())} device(s)",
              file=sys.stderr)
        return 2
    cache = enable_compile_cache()
    card = card_label()
    print(f"card: {card}", flush=True)
    print(f"jax {jax.__version__}; devices: {jax.devices()}; compile cache: {cache}", flush=True)
    rep = Reporter(card, dev)
    t0 = time.perf_counter()
    if args.chips == 4:
        four_card_phases(rep, args.seed)
    else:
        phase_two_view(rep, args.seed)
        phase_hires(rep, args.seed)
        phase_array(rep, args.seed)
        phase_serving(rep, args.seed)
        phase_calibration(rep, args.seed)
        phase_cli(rep, args.seed)
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s; card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": dev.platform, "kind": dev.device_kind,
                                             "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
