"""End-to-end array pipeline (models/array_pipeline.py) — the reference's
`main()` (``/root/reference/src/CameraStereoVision.cpp:10-123``)."""

import numpy as np
import jax.numpy as jnp

from stereovisionarray_tpu.config import EngineConfig
from stereovisionarray_tpu.datasets import SceneSpec, reference_rig, render_camera_array
from stereovisionarray_tpu.models import array_baselines, array_depth_pipeline


def _small_setup(rows=3, cols=3, res=(48, 64)):
    cams = reference_rig(rows=rows, cols=cols, spacing=0.05, resolution=res)
    scene = SceneSpec()
    images, depths = render_camera_array(cams, res, scene)
    return cams, jnp.asarray(images), depths


def _cfg(rows=3, cols=3):
    cfg = EngineConfig()
    return cfg.override(**{
        "camera.rows": rows,
        "camera.cols": cols,
        "plane_sweep.num_planes": 48,
        "plane_sweep.topology": "to_center",
        "plane_sweep.patch": 5,
        "refine.radius": 2,
        "refine.window": 9,
        "sgm.num_paths": 4,
    })


def test_pipeline_end_to_end_accuracy():
    cams, images, depths = _small_setup()
    cfg = _cfg()
    out = array_depth_pipeline(images, cams, cfg, ref_index=4)
    gt = depths[4]
    valid = np.asarray(out.valid)
    inner = np.zeros_like(valid)
    inner[8:-8, 8:-8] = True
    sel = valid & inner
    assert sel.sum() > 0.9 * inner.sum()  # most of the interior resolves
    err = np.abs(np.asarray(out.depth) - gt)[sel]
    rerr = err / gt[sel]
    assert np.median(rerr) < 0.02  # within 2% depth on the synthetic scene

    # refinement must not blow up the solution
    rerr2 = (np.abs(np.asarray(out.refined_depth) - gt) / gt)[sel]
    assert np.median(rerr2) < 0.03


def test_pipeline_respects_explicit_mask():
    cams, images, _ = _small_setup()
    cfg = _cfg()
    h, w = images.shape[1:]
    mask = jnp.zeros((h, w), dtype=bool).at[10:30, 10:40].set(True)
    out = array_depth_pipeline(images, cams, cfg, ref_index=4, mask=mask)
    outside = ~np.asarray(mask)
    assert not np.asarray(out.valid)[outside].any()
    assert (np.asarray(out.depth)[outside] == 0).all()


def test_array_baselines_normalization():
    cams, _, _ = _small_setup()
    src = (0, 1, 2, 3, 5, 6, 7, 8)
    b_uv, b0 = array_baselines(cams, 4, src)
    assert b_uv.shape == (8, 2)
    # mean of per-view scaled lengths equals 1 (normalized to B0)
    lens = np.linalg.norm(b_uv, axis=-1)
    np.testing.assert_allclose(lens.mean(), 1.0, rtol=1e-5)
    # direct horizontal neighbour (index 3, left of center): C_ref - C_src
    # points +x -> baseline direction (+1, 0) scaled by its length ratio
    i = src.index(3)
    assert b_uv[i, 0] > 0 and abs(b_uv[i, 1]) < 1e-6


def test_default_ref_index_is_grid_center():
    cams, images, depths = _small_setup()
    cfg = _cfg()
    out = array_depth_pipeline(images, cams, cfg)  # rows=3, cols=3 -> 4
    gt = depths[4]
    valid = np.asarray(out.valid)
    inner = np.zeros_like(valid)
    inner[8:-8, 8:-8] = True
    sel = valid & inner
    rerr = (np.abs(np.asarray(out.depth) - gt) / gt)[sel]
    assert np.median(rerr) < 0.02
