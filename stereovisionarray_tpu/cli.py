"""Command-line driver — the configurable replacement for the reference's
hard-coded ``main()`` (``/root/reference/src/CameraStereoVision.cpp:10-123``,
where every parameter is a literal: folder "Renders2", f=0.05, kernel 20,
topology MID_LEFT, ...).

Subcommands::

    python -m stereovisionarray_tpu render    --output data/        # synth dataset
    python -m stereovisionarray_tpu depth     --input data/ --output out/
    python -m stereovisionarray_tpu two-view  --left L.png --right R.png
    python -m stereovisionarray_tpu calibrate --input data/
    python -m stereovisionarray_tpu config                          # dump defaults

Every subcommand accepts ``--config cfg.json`` and repeated
``--set dotted.key=value`` overrides (``EngineConfig.override``). JAX platform
selection: ``--platform cpu`` forces the host backend, ``--platform gpu`` the
card. Compiled programs are cached as ``compile_cache.py`` says.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

import numpy as np

from stereovisionarray_tpu.config import EngineConfig


# --------------------------------------------------------------------- #
# plumbing
# --------------------------------------------------------------------- #
def _parse_value(text: str):
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        return text  # bare string (e.g. topology names)


def load_config(args) -> EngineConfig:
    cfg = EngineConfig()
    if getattr(args, "config", None):
        with open(args.config) as f:
            cfg = EngineConfig.from_json(f.read())
    overrides = {}
    for item in getattr(args, "set", None) or []:
        if "=" not in item:
            raise SystemExit(f"--set expects key=value, got {item!r}")
        k, v = item.split("=", 1)
        overrides[k] = _parse_value(v)
    if overrides:
        cfg = cfg.override(**overrides)
    return cfg


def _setup_platform(platform: Optional[str]) -> None:
    from stereovisionarray_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    if platform:
        os.environ["JAX_PLATFORMS"] = platform
        import jax

        jax.config.update("jax_platforms", platform)


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", help="EngineConfig JSON file")
    p.add_argument("--set", action="append", metavar="KEY=VALUE",
                   help="dotted config override, repeatable")
    p.add_argument("--platform", choices=("cpu", "gpu"),
                   help="force a JAX platform")
    p.add_argument("--output", default="out", help="artifact directory")


def _probe_report(maps: dict, probes) -> list:
    """Pixel probes on LIVE pipeline output — the reference's click-to-print
    mouse callback on its result windows
    (``/root/reference/src/functions.cpp:220-239``), scriptable: each (u, v)
    prints every output map's value at that pixel."""
    out = []
    for (u, v) in probes or ():
        row = {"u": int(u), "v": int(v)}
        for name, arr in maps.items():
            a = np.asarray(arr)
            if not (0 <= int(v) < a.shape[0] and 0 <= int(u) < a.shape[1]):
                row[name] = None
            else:
                row[name] = a[int(v), int(u)].item()
        out.append(row)
    return out


def _add_probe(p: argparse.ArgumentParser) -> None:
    p.add_argument("--probe", type=int, nargs=2, action="append",
                   metavar=("U", "V"),
                   help="print live output values at pixel (u, v); repeatable")


def _rig_from_config(cfg: EngineConfig, resolution):
    from stereovisionarray_tpu.datasets import reference_rig

    cam = cfg.camera
    return reference_rig(
        rows=cam.rows, cols=cam.cols, spacing=cam.spacing, origin=cam.origin,
        z=cam.z, focal_length=cam.focal_length, sensor_width=cam.sensor_width,
        resolution=resolution,
    )


def _load_array_images(folder: str, half_res: bool):
    from stereovisionarray_tpu.datasets import list_images_sorted, load_image_stack

    paths = list_images_sorted(folder)
    if not paths:
        raise SystemExit(f"no images found in {folder!r}")
    imgs = load_image_stack(paths, half_res=half_res)
    return imgs, paths


# --------------------------------------------------------------------- #
# subcommands
# --------------------------------------------------------------------- #
def cmd_config(args) -> int:
    print(load_config(args).to_json())
    return 0


def cmd_render(args) -> int:
    """Synthesize the camera-array dataset (the `Renders2` role) + exact GT
    (the `idealRef.yml` role, ``/root/reference/src/functions.cpp:323``)."""
    _setup_platform(args.platform)
    from stereovisionarray_tpu.datasets import (
        SceneSpec, render_camera_array, save_array, save_png,
    )

    cfg = load_config(args)
    res = tuple(args.resolution)
    cams = _rig_from_config(cfg, res)
    scene = SceneSpec(texture_seed=cfg.seed)
    images, depths = render_camera_array(cams, res, scene)
    os.makedirs(args.output, exist_ok=True)
    for i, img in enumerate(images):
        save_png(os.path.join(args.output, f"view_{i:03d}.png"), img, vmin=0.0, vmax=255.0)
    save_array(os.path.join(args.output, "ground_truth.npz"),
               {"depths": depths},
               metadata={"config": cfg.to_dict(), "resolution": list(res)})
    print(json.dumps({"rendered": int(len(images)), "output": args.output,
                      "resolution": list(res)}))
    return 0


def cmd_depth(args) -> int:
    """Full array pipeline: images -> ROI -> plane-sweep depth -> multi-view
    refinement -> artifacts (+ metrics vs GT when available)."""
    _setup_platform(args.platform)
    import jax.numpy as jnp

    from stereovisionarray_tpu.datasets import load_array, save_array, save_png, save_ply
    from stereovisionarray_tpu.evaluation import bad_pixel_ratio, masked_mean_error
    from stereovisionarray_tpu.geometry import depth_map_to_points, point_cloud_colors
    from stereovisionarray_tpu.models import array_depth_pipeline
    from stereovisionarray_tpu.utils.obslog import MetricsLogger

    cfg = load_config(args)
    if getattr(args, "cascade", False):
        cfg = cfg.override(**{"plane_sweep.cascade": True})
    images, _paths = _load_array_images(args.input, args.half_res)
    n, h, w = images.shape
    if n != cfg.camera.rows * cfg.camera.cols:
        raise SystemExit(
            f"{n} images but config rig is {cfg.camera.rows}x{cfg.camera.cols}; "
            f"fix with --set camera.rows=R --set camera.cols=C"
        )
    cams = _rig_from_config(cfg, (h, w))
    images = jnp.asarray(images)
    if args.undistort:
        from stereovisionarray_tpu.geometry import Distortion, undistort_image

        dist = Distortion(*args.undistort)
        images = jnp.stack([
            undistort_image(images[i], cams[i], dist)[0] for i in range(n)
        ])
    out = array_depth_pipeline(
        images, cams, cfg, ref_index=args.ref_index,
        use_roi=args.roi,
    )

    os.makedirs(args.output, exist_ok=True)
    log = MetricsLogger(os.path.join(args.output, "metrics.jsonl"))
    save_png(os.path.join(args.output, "depth.png"), np.asarray(out.refined_depth))
    save_png(os.path.join(args.output, "disparity.png"), np.asarray(out.refined_disparity))
    payload = {"depth": np.asarray(out.refined_depth),
               "disparity": np.asarray(out.refined_disparity),
               "valid": np.asarray(out.valid)}
    if out.sweep.confidence is not None:
        payload["confidence"] = np.asarray(out.sweep.confidence)
    save_array(os.path.join(args.output, "depth.npz"), payload,
               metadata={"config": cfg.to_dict()})
    ref_index = args.ref_index
    if ref_index is None:
        ref_index = (cfg.camera.rows // 2) * cfg.camera.cols + cfg.camera.cols // 2
    pts, pvalid = depth_map_to_points(cams[ref_index], out.refined_depth, mask=out.valid)
    col = point_cloud_colors(jnp.asarray(images[ref_index]), pvalid)
    n_pts = save_ply(os.path.join(args.output, "cloud.ply"),
                     np.asarray(pts).reshape(-1, 3), colors=np.asarray(col),
                     valid=np.asarray(pvalid).reshape(-1))

    result = {"valid_fraction": float(np.asarray(out.valid).mean()),
              "points": int(n_pts), "output": args.output}
    if args.probe:
        result["probes"] = _probe_report(
            {"depth": out.refined_depth, "disparity": out.refined_disparity,
             "valid": out.valid}, args.probe,
        )
    gt_path = args.ground_truth or os.path.join(args.input, "ground_truth.npz")
    if os.path.exists(gt_path):
        arrays, _meta = load_array(gt_path)
        gt = arrays["depths"][ref_index]
        err_mask = np.asarray(out.valid) & (gt > 0)
        depth_np = np.asarray(out.refined_depth)
        result["mean_abs_err"] = float(
            masked_mean_error(jnp.asarray(depth_np), jnp.asarray(gt), jnp.asarray(err_mask))
        )
        rel = np.abs(depth_np - gt)[err_mask] / gt[err_mask]
        result["median_rel_err"] = float(np.median(rel))
        # bad-τ on the GT-equivalent disparity scale
        result["bad_2pct_depth"] = float((rel > 0.02).mean())
        save_png(os.path.join(args.output, "error.png"), np.abs(depth_np - gt) * err_mask)
    log.log("depth", **result)
    print(json.dumps(result, sort_keys=True))
    return 0


def cmd_reconstruct(args) -> int:
    """Full-array reconstruction: every selected view gets its own
    plane-sweep depth; geometric-consistency fusion merges them into one
    deduplicated point cloud (models/fusion.py)."""
    _setup_platform(args.platform)
    import jax.numpy as jnp

    from stereovisionarray_tpu.datasets import load_array, save_array, save_ply
    from stereovisionarray_tpu.models.fusion import (
        fused_point_cloud,
        reconstruct_array,
    )
    from stereovisionarray_tpu.utils.obslog import MetricsLogger

    cfg = load_config(args)
    images, _paths = _load_array_images(args.input, args.half_res)
    n, h, w = images.shape
    if n != cfg.camera.rows * cfg.camera.cols:
        raise SystemExit(
            f"{n} images but config rig is {cfg.camera.rows}x{cfg.camera.cols}; "
            f"fix with --set camera.rows=R --set camera.cols=C"
        )
    cams = _rig_from_config(cfg, (h, w))
    views = tuple(args.views) if args.views else tuple(range(n))
    result, depths = reconstruct_array(
        jnp.asarray(images), cams, cfg, view_indices=views,
        use_roi=args.roi, rel_thresh=args.rel_thresh,
        min_support=args.min_support, min_confidence=args.min_confidence,
    )
    os.makedirs(args.output, exist_ok=True)
    # colors: each kept point takes its source view's intensity
    colors = jnp.stack([jnp.asarray(images[v]) for v in views])
    pts, conf, col = fused_point_cloud(result, colors)
    raw_points = int(pts.shape[0])
    if args.remove_outliers and pts.shape[0]:
        from stereovisionarray_tpu.geometry import remove_outliers

        keep = remove_outliers(pts, voxel=args.outlier_voxel,
                               min_neighbors=args.outlier_min_neighbors)
        pts, conf = pts[keep], conf[keep]
        col = col[keep] if col is not None else None
    if args.voxel and pts.shape[0]:
        from stereovisionarray_tpu.geometry import voxel_downsample

        pts, conf, col = voxel_downsample(pts, args.voxel, weights=conf,
                                          attributes=col)
    col3 = None
    if col is not None and col.size:
        c8 = np.clip(np.asarray(col), 0, 255).astype(np.uint8)
        col3 = np.stack([c8, c8, c8], axis=-1)
    normals = None
    if args.voxel == 0.0 and not args.remove_outliers:
        # per-point world normals (depth_normals per view), compacted with
        # the same mask as the cloud; post-processing reorders/merges
        # points, so normals are exported only for the raw fused cloud
        from stereovisionarray_tpu.models.fusion import depth_normals

        cams_sel = cams[jnp.asarray(list(views))]
        nrm_all = np.stack([
            np.asarray(depth_normals(cams_sel[k], result.depth[k],
                                     result.valid[k])[0])
            for k in range(len(views))
        ])
        normals = nrm_all.reshape(-1, 3)[np.asarray(result.valid).reshape(-1)]
    n_pts = save_ply(os.path.join(args.output, "fused_cloud.ply"),
                     pts, colors=col3, normals=normals, quality=conf)
    save_array(os.path.join(args.output, "fused.npz"),
               {"depths": np.asarray(result.depth),
                "valid": np.asarray(result.valid),
                "support": np.asarray(result.support),
                "confidence": np.asarray(result.confidence),
                "views": np.asarray(views)},
               metadata={"config": cfg.to_dict()})
    out = {"points": int(n_pts), "raw_points": raw_points,
           "views": list(map(int, views)),
           "mean_support": float(np.asarray(result.support)[np.asarray(result.valid)].mean())
           if n_pts else 0.0,
           "output": args.output}
    gt_path = args.ground_truth or os.path.join(args.input, "ground_truth.npz")
    if os.path.exists(gt_path):
        arrays, _meta = load_array(gt_path)
        gt = np.stack([arrays["depths"][v] for v in views])
        kept = np.asarray(result.valid) & (gt > 0)
        if kept.any():
            rel = np.abs(np.asarray(result.depth) - gt)[kept] / gt[kept]
            out["median_rel_err"] = float(np.median(rel))
            out["bad_2pct_depth"] = float((rel > 0.02).mean())
    MetricsLogger(os.path.join(args.output, "metrics.jsonl")).log(
        "reconstruct", **out)
    print(json.dumps(out, sort_keys=True))
    return 0


def cmd_two_view(args) -> int:
    """Rectified two-view SGM disparity (BASELINE.json configs 1+2)."""
    _setup_platform(args.platform)
    import jax.numpy as jnp

    from stereovisionarray_tpu.datasets import load_image_gray, save_array, save_png
    from stereovisionarray_tpu.models import two_view_disparity

    cfg = load_config(args)
    left = load_image_gray(args.left, half_res=args.half_res)
    right = load_image_gray(args.right, half_res=args.half_res)
    kwargs = {}
    if args.baseline is not None and args.focal_px is not None:
        kwargs = {"baseline": args.baseline, "focal_px": args.focal_px}
    if getattr(args, "cascade", False):
        from stereovisionarray_tpu.models import cascade_two_view_disparity

        out = cascade_two_view_disparity(
            jnp.asarray(left), jnp.asarray(right), cfg.cost, cfg.sgm,
            coarse_factor=args.coarse_factor,
            fine_disparities=args.fine_disparities,
            band_step=args.band_step,
            mode=getattr(args, "cascade_mode", "smooth"), **kwargs)
    else:
        out = two_view_disparity(jnp.asarray(left), jnp.asarray(right),
                                 cfg.cost, cfg.sgm, **kwargs)
    os.makedirs(args.output, exist_ok=True)
    save_png(os.path.join(args.output, "disparity.png"), np.asarray(out.disparity))
    payload = {"disparity": np.asarray(out.disparity), "valid": np.asarray(out.valid)}
    if out.depth is not None:
        payload["depth"] = np.asarray(out.depth)
        save_png(os.path.join(args.output, "depth.png"), np.asarray(out.depth))
    if out.confidence is not None:
        payload["confidence"] = np.asarray(out.confidence)
        # absolute [0, 1] scale so confidence PNGs compare across runs
        save_png(os.path.join(args.output, "confidence.png"),
                 np.asarray(out.confidence), vmin=0.0, vmax=1.0)
    save_array(os.path.join(args.output, "two_view.npz"), payload,
               metadata={"config": cfg.to_dict()})
    report = {"valid_fraction": float(np.asarray(out.valid).mean()),
              "output": args.output}
    if out.confidence is not None:
        v = np.asarray(out.valid)
        report["mean_confidence"] = (
            float(np.asarray(out.confidence)[v].mean()) if v.any() else 0.0
        )
    if args.probe:
        report["probes"] = _probe_report(payload, args.probe)
    print(json.dumps(report, sort_keys=True))
    return 0


def cmd_calibrate(args) -> int:
    """Feature-based array calibration + bundle adjustment (replaces the
    reference's hard-coded poses, ``/root/reference/src/CameraStereoVision.cpp:33-39``)."""
    _setup_platform(args.platform)
    import jax.numpy as jnp

    from stereovisionarray_tpu.datasets import save_array
    from stereovisionarray_tpu.models import calibrate_array

    cfg = load_config(args)
    images, _paths = _load_array_images(args.input, args.half_res)
    n, h, w = images.shape
    cams = _rig_from_config(cfg, (h, w))
    ref_index = args.ref_index
    if ref_index is None:
        ref_index = (cfg.camera.rows // 2) * cfg.camera.cols + cfg.camera.cols // 2
    result = calibrate_array(jnp.asarray(images), cams, ref_index, cfg.sfm,
                             estimate_distortion=args.estimate_distortion)
    os.makedirs(args.output, exist_ok=True)
    save_array(os.path.join(args.output, "calibration.npz"),
               {"R": np.asarray(result.cameras.R), "t": np.asarray(result.cameras.t),
                "points": np.asarray(result.points),
                "point_valid": np.asarray(result.point_valid)},
               metadata={"config": cfg.to_dict()})
    print(json.dumps({
        "mean_reproj_px": float(result.mean_reproj),
        "inlier_reproj_px": float(result.inlier_reproj),
        **({"k1": float(result.distortion[0]),
            "k2": float(result.distortion[1])}
           if result.distortion is not None else {}),
        "inlier_threshold_px": float(result.inlier_threshold_px),
        "outlier_fraction": float(result.outlier_fraction),
        "num_obs": int(result.num_obs),
        "output": args.output,
    }, sort_keys=True))
    return 0


def cmd_serve(args) -> int:
    """Stream a sequence of array frame-set directories through the full
    pipeline with decode/compute overlap (models/serving.py) — the
    multi-frame production loop the reference's one-shot `main()` lacks."""
    _setup_platform(args.platform)
    import time

    from stereovisionarray_tpu.datasets import save_array, save_png
    from stereovisionarray_tpu.models import (
        frame_sets_from_dirs,
        stream_depth_maps_chunked,
    )
    from stereovisionarray_tpu.utils.obslog import MetricsLogger

    cfg = load_config(args)
    dirs = sorted(args.inputs)
    os.makedirs(args.output, exist_ok=True)
    log = MetricsLogger(os.path.join(args.output, "metrics.jsonl"))

    first = _load_array_images(dirs[0], args.half_res)[0]
    n, h, w = first.shape
    if n != cfg.camera.rows * cfg.camera.cols:
        raise SystemExit(
            f"{n} images per frame set but rig is {cfg.camera.rows}x{cfg.camera.cols}"
        )
    cams = _rig_from_config(cfg, (h, w))

    temporal = None
    if args.temporal:
        # fused path: the filter scans INSIDE the chunked device program
        from stereovisionarray_tpu.models import array_baselines
        from stereovisionarray_tpu.models.array_pipeline import reference_and_sources
        from stereovisionarray_tpu.models.serving import TemporalParams

        ref_index, src = reference_and_sources(cfg, n, args.ref_index)
        _, b0 = array_baselines(cams, ref_index, src)
        f_px = float(np.broadcast_to(np.asarray(cams.fx), (n,))[ref_index])
        temporal = TemporalParams(baseline=b0, focal_px=f_px)
    stream = stream_depth_maps_chunked(
        frame_sets_from_dirs(dirs, half_res=args.half_res),
        cams, cfg, ref_index=args.ref_index, use_roi=args.roi,
        depth=args.prefetch, chunk=args.chunk, temporal=temporal,
    )

    t0 = time.perf_counter()
    count = 0
    for res in stream:
        if args.temporal:
            depth_np = np.asarray(res.depth)
            valid_np = np.asarray(res.temporal.valid)
            extra = {"stability": np.asarray(res.temporal.stability)}
        else:
            depth_np = np.asarray(res.output.refined_depth)
            valid_np = np.asarray(res.output.valid)
            extra = {}
        save_png(os.path.join(args.output, f"depth_{res.index:04d}.png"), depth_np)
        save_array(
            os.path.join(args.output, f"depth_{res.index:04d}.npz"),
            {"depth": depth_np, "valid": valid_np, **extra},
        )
        log.log("frame", index=res.index, decode_s=res.decode_s,
                valid_fraction=float(valid_np.mean()))
        count += 1
    wall = time.perf_counter() - t0
    summary = {"frames": count, "wall_s": round(wall, 3),
               "frames_per_s": round(count / max(wall, 1e-9), 3),
               "output": args.output}
    log.log("serve_done", **summary)
    print(json.dumps(summary, sort_keys=True))
    return 0


def cmd_evaluate(args) -> int:
    """Compare a result artifact against ground truth — the standalone
    version of the reference's golden check (`getIdealRef` + masked mean,
    ``/root/reference/src/functions.cpp:323-329,348-354``) with the full
    metric suite (bad-τ, EPE, masked mean)."""
    import jax.numpy as jnp

    from stereovisionarray_tpu.datasets import load_array
    from stereovisionarray_tpu.evaluation import (
        bad_pixel_ratio,
        end_point_error,
        masked_mean_error,
    )

    res, _ = load_array(args.result)
    gt_arrays, _ = load_array(args.ground_truth)

    if args.key not in res:
        raise SystemExit(f"{args.key!r} not in {args.result} (has {sorted(res)})")
    pred = jnp.asarray(res[args.key])
    gt_key = args.gt_key
    if gt_key is None:
        gt_key = args.key if args.key in gt_arrays else sorted(gt_arrays)[0]
    gt = gt_arrays[gt_key]
    if gt.ndim == pred.ndim + 1:  # per-view GT stack -> select one
        gt = gt[args.gt_index]
    gt = jnp.asarray(gt)
    if gt.shape != pred.shape:
        raise SystemExit(f"shape mismatch: result {pred.shape} vs gt {gt.shape}")

    valid = jnp.asarray(res["valid"]) if "valid" in res else jnp.ones(pred.shape, bool)
    valid = valid & (gt > 0) if args.positive_gt_only else valid
    report = {
        "key": args.key,
        "gt_key": gt_key,
        "valid_fraction": float(valid.mean()),
        "masked_mean_err": float(masked_mean_error(pred, gt, mask=valid)),
        "epe": float(end_point_error(pred, gt, mask=valid)),
    }
    for tau in args.tau:
        report[f"bad_{tau}"] = float(bad_pixel_ratio(pred, gt, tau, mask=valid))
    print(json.dumps(report, sort_keys=True))
    return 0


def cmd_inspect(args) -> int:
    """Probe pixel values / stats of a saved artifact — the scriptable
    replacement for the reference's click-to-print mouse callback
    (``/root/reference/src/functions.cpp:220-239``)."""
    from stereovisionarray_tpu.datasets import load_array

    path = args.artifact
    if path.endswith(".npz"):
        arrays, meta = load_array(path)
    else:
        from stereovisionarray_tpu.datasets import load_image_gray

        arrays, meta = {"image": load_image_gray(path)}, {}
    report = {}
    for name, arr in arrays.items():
        a = np.asarray(arr)
        entry = {"shape": list(a.shape), "dtype": str(a.dtype)}
        if np.issubdtype(a.dtype, np.number):
            finite = a[np.isfinite(a.astype(np.float64))] if a.size else a
            entry.update(
                min=float(finite.min()) if finite.size else None,
                max=float(finite.max()) if finite.size else None,
                mean=float(finite.mean()) if finite.size else None,
                nonfinite=int((~np.isfinite(a.astype(np.float64))).sum()),
            )
        if args.at is not None and a.ndim >= 2:
            u, v = args.at
            if 0 <= v < a.shape[0] and 0 <= u < a.shape[1]:
                entry["at"] = {"u": u, "v": v, "value": a[v, u].tolist()}
            else:
                entry["at"] = {"u": u, "v": v, "value": None, "error": "out of bounds"}
        report[name] = entry
    if meta:
        report["__meta__"] = {"keys": sorted(meta.keys())}
    print(json.dumps(report, sort_keys=True))
    return 0


# --------------------------------------------------------------------- #
def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="stereovisionarray_tpu",
        description="Multi-view stereo / SfM engine in JAX",
    )
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("config", help="print the resolved config as JSON")
    p.add_argument("--config")
    p.add_argument("--set", action="append", metavar="KEY=VALUE")
    p.set_defaults(fn=cmd_config)

    p = sub.add_parser("render", help="render a synthetic camera-array dataset")
    _add_common(p)
    p.add_argument("--resolution", type=int, nargs=2, default=(270, 360),
                   metavar=("H", "W"))
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("depth", help="array images -> fused + refined depth")
    _add_common(p)
    p.add_argument("--input", required=True, help="folder of array images (sorted)")
    p.add_argument("--ref-index", type=int, default=None)
    p.add_argument("--roi", action="store_true", help="gate with detected face ROI")
    p.add_argument("--half-res", action="store_true",
                   help="0.5x ingest decimation (the reference default)")
    p.add_argument("--undistort", type=float, nargs="*", default=None,
                   metavar="K", help="Brown-Conrady k1 k2 [p1 p2]: "
                   "undistort captures onto the ideal pinhole grid at ingest")
    p.add_argument("--ground-truth", help="npz with 'depths' (N,H,W)")
    p.add_argument("--cascade", action="store_true",
                   help="coarse-to-fine plane cascade (translation rigs; "
                        "equivalent to --set plane_sweep.cascade=true)")
    _add_probe(p)
    p.set_defaults(fn=cmd_depth)

    p = sub.add_parser("reconstruct",
                       help="array images -> per-view depths -> fused cloud")
    _add_common(p)
    p.add_argument("--input", required=True, help="folder of array images (sorted)")
    p.add_argument("--views", type=int, nargs="*", default=None,
                   help="view indices to reconstruct (default: all)")
    p.add_argument("--roi", action="store_true", help="gate with detected face ROI")
    p.add_argument("--half-res", action="store_true")
    p.add_argument("--rel-thresh", type=float, default=0.01,
                   help="relative depth-agreement tolerance")
    p.add_argument("--min-support", type=int, default=3,
                   help="min agreeing views (incl. self) to keep a point")
    p.add_argument("--min-confidence", type=float, default=0.0,
                   help="drop pixels below this PKRN matching confidence "
                        "before the consistency vote")
    p.add_argument("--voxel", type=float, default=0.0,
                   help="voxel-downsample the fused cloud (cell edge, "
                        "world units; confidence-weighted centroids)")
    p.add_argument("--remove-outliers", action="store_true",
                   help="grid-density outlier removal before export")
    p.add_argument("--outlier-voxel", type=float, default=0.005,
                   help="outlier-removal neighbourhood cell size")
    p.add_argument("--outlier-min-neighbors", type=int, default=3)
    p.add_argument("--ground-truth", help="npz with 'depths' (N,H,W)")
    p.set_defaults(fn=cmd_reconstruct)

    p = sub.add_parser("two-view", help="rectified pair -> SGM disparity")
    _add_common(p)
    p.add_argument("--left", required=True)
    p.add_argument("--right", required=True)
    p.add_argument("--baseline", type=float, help="metric baseline (for depth)")
    p.add_argument("--focal-px", type=float, help="focal length in pixels")
    p.add_argument("--half-res", action="store_true")
    p.add_argument("--cascade", action="store_true",
                   help="coarse-to-fine search (large disparity ranges)")
    p.add_argument("--cascade-mode", choices=("smooth", "band"),
                   default="smooth",
                   help="pre-warp: smooth field (default, seam-free) or "
                        "r4 integer bands (fallback for scenes with "
                        "strong vertical disparity structure)")
    p.add_argument("--coarse-factor", type=int, default=4)
    p.add_argument("--fine-disparities", type=int, default=32)
    p.add_argument("--band-step", type=int, default=8)
    _add_probe(p)
    p.set_defaults(fn=cmd_two_view)

    p = sub.add_parser("calibrate", help="feature + BA array calibration")
    _add_common(p)
    p.add_argument("--input", required=True)
    p.add_argument("--ref-index", type=int, default=None)
    p.add_argument("--half-res", action="store_true")
    p.add_argument("--estimate-distortion", action="store_true",
                   help="solve Brown-Conrady (k1,k2) from vertical parallax "
                        "before BA (translation rigs)")
    p.set_defaults(fn=cmd_calibrate)

    p = sub.add_parser("serve", help="stream frame-set dirs through the pipeline")
    _add_common(p)
    p.add_argument("inputs", nargs="+", help="directories, one frame set each")
    p.add_argument("--ref-index", type=int, default=None)
    p.add_argument("--roi", action="store_true")
    p.add_argument("--half-res", action="store_true")
    p.add_argument("--prefetch", type=int, default=2,
                   help="frame sets in flight ahead of the consumer")
    p.add_argument("--chunk", type=int, default=8,
                   help="frame sets per device program (lax.map batch; "
                        "amortizes per-dispatch transport latency)")
    p.add_argument("--temporal", action="store_true",
                   help="recursive temporal filter across frame sets "
                        "(confidence-weighted; adds a stability map)")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("evaluate", help="compare a result artifact vs ground truth")
    p.add_argument("--result", required=True, help="npz with the prediction")
    p.add_argument("--ground-truth", required=True, help="npz with GT arrays")
    p.add_argument("--key", default="depth", help="prediction array name")
    p.add_argument("--gt-key", default=None, help="GT array name (default: same)")
    p.add_argument("--gt-index", type=int, default=0,
                   help="view index when GT is a per-view stack")
    p.add_argument("--tau", type=float, nargs="*", default=(0.5, 1.0, 2.0),
                   help="bad-τ thresholds")
    p.add_argument("--positive-gt-only", action="store_true", default=True)
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser("inspect", help="probe values/stats of a saved artifact")
    p.add_argument("artifact", help=".npz artifact or image file")
    p.add_argument("--at", type=int, nargs=2, metavar=("U", "V"),
                   help="print the value at pixel (u, v)")
    p.set_defaults(fn=cmd_inspect)

    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
