"""Golden tests for N-view plane-sweep fusion (BASELINE.json config 3)
against the analytic synthetic rig (exact GT depth — the ``idealRef.yml``
pattern done properly, SURVEY.md §4)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from stereovisionarray_tpu.config import PlaneSweepConfig, SGMConfig
from stereovisionarray_tpu.datasets.synthetic import (
    SceneSpec,
    reference_rig,
    render_camera_array,
)
from stereovisionarray_tpu.models.plane_sweep import (
    plane_sweep_depth,
    plane_sweep_volume,
)

RES = (96, 128)
REF = 4  # center of the 3x3 rig
SRC = tuple(i for i in range(9) if i != REF)
CFG = PlaneSweepConfig(
    num_planes=64, z_near=0.8, z_far=1.05, cost="census", patch=7,
    fusion="topk_mean", topk=4,
)
SGM = SGMConfig(p1=1.0, p2=8.0, adaptive_p2=True, p2_min=2.0, lr_max_diff=0.0)


@pytest.fixture(scope="module")
def rig_data():
    rig = reference_rig(rows=3, cols=3, spacing=0.05, origin=(-0.05, -0.05), resolution=RES)
    imgs, deps = render_camera_array(rig, RES)
    return rig, jnp.asarray(imgs), deps


def _inner_mask(valid):
    inner = np.zeros_like(valid)
    inner[8:-8, 8:-8] = True
    return inner


class TestPlaneSweepDepth:
    def test_depth_accuracy_with_sgm(self, rig_data):
        rig, imgs, deps = rig_data
        out = plane_sweep_depth(imgs, rig, REF, SRC, CFG, SGM)
        d, v = np.asarray(out.depth), np.asarray(out.valid)
        gt = deps[REF]
        inner = _inner_mask(v)
        sel = v & inner
        assert sel.sum() / inner.sum() > 0.95
        rel = np.abs(d[sel] - gt[sel]) / gt[sel]
        assert rel.mean() < 0.01, f"mean rel depth err {rel.mean()}"
        assert (rel > 0.02).mean() < 0.05, f"bad-2% {(rel > 0.02).mean()}"

    def test_sgm_beats_raw_fusion(self, rig_data):
        """SGM aggregation over the plane axis must reduce bad pixels vs raw
        per-plane WTA (the reference has no aggregation at all)."""
        rig, imgs, deps = rig_data
        gt = deps[REF]
        bad = {}
        for name, sgm in (("sgm", SGM), ("raw", None)):
            out = plane_sweep_depth(imgs, rig, REF, SRC, CFG, sgm)
            d, v = np.asarray(out.depth), np.asarray(out.valid)
            sel = v & _inner_mask(v)
            bad[name] = (np.abs(d[sel] - gt[sel]) / gt[sel] > 0.02).mean()
        assert bad["sgm"] < bad["raw"]

    @pytest.mark.parametrize("cost", ["census", "sad", "zncc"])
    def test_cost_variants_finite_and_accurate(self, rig_data, cost):
        rig, imgs, deps = rig_data
        cfg = PlaneSweepConfig(
            num_planes=32, z_near=0.8, z_far=1.05, cost=cost, patch=5,
            fusion="topk_mean", topk=4,
        )
        out = plane_sweep_depth(imgs, rig, REF, SRC, cfg, SGM)
        d, v = np.asarray(out.depth), np.asarray(out.valid)
        assert np.isfinite(d).all()
        gt = deps[REF]
        sel = v & _inner_mask(v)
        rel = np.abs(d[sel] - gt[sel]) / gt[sel]
        assert rel.mean() < 0.02, f"{cost}: mean rel err {rel.mean()}"

    @pytest.mark.parametrize("fusion", ["mean", "min", "topk_mean"])
    def test_fusion_variants_run(self, rig_data, fusion):
        rig, imgs, _ = rig_data
        cfg = PlaneSweepConfig(
            num_planes=16, z_near=0.8, z_far=1.05, cost="sad", patch=5,
            fusion=fusion, topk=4,
        )
        out = plane_sweep_depth(imgs, rig, REF, SRC, cfg, None)
        assert np.isfinite(np.asarray(out.depth)).all()

    def test_min_views_invalidates(self, rig_data):
        """With an absurd min_views requirement everything is invalid."""
        rig, imgs, _ = rig_data
        out = plane_sweep_depth(imgs, rig, REF, SRC, CFG, None, min_views=99)
        assert not np.asarray(out.valid).any()
        assert (np.asarray(out.depth) == 0).all()


class TestPlaneSweepVolume:
    def test_volume_min_at_true_plane_flat_scene(self):
        """Single fronto-parallel plane scene: the fused cost argmin must sit
        at the plane index matching the true depth for (almost) all pixels."""
        res = (64, 96)
        rig = reference_rig(rows=3, cols=3, spacing=0.04, origin=(-0.04, -0.04), resolution=res)
        scene = SceneSpec(background_z=0.2, patches=(), sphere_radius=0.0)
        imgs, deps = render_camera_array(rig, res, scene)
        true_depth = float(deps[REF][32, 48])
        # wide bracket: adjacent planes must differ by a resolvable warp
        # shift (the rig's short baselines make narrow brackets degenerate)
        cfg = PlaneSweepConfig(
            num_planes=16, z_near=true_depth * 0.6, z_far=true_depth * 1.6,
            cost="census", patch=5, fusion="mean",
        )
        vol, nv, depths = plane_sweep_volume(jnp.asarray(imgs), rig, REF, SRC, cfg)
        k = np.argmin(np.asarray(vol), axis=-1)
        depth_at_min = np.asarray(depths)[k]
        inner = np.zeros(res, dtype=bool)
        inner[8:-8, 8:-8] = True
        rel = np.abs(depth_at_min - true_depth) / true_depth
        assert (rel < 0.08)[inner].mean() > 0.9, f"hit rate {(rel < 0.08)[inner].mean()}"


def test_backend_pallas_interpret_matches_xla(rng):
    """plane_sweep_depth(backend=pallas_interpret) reproduces the XLA path:
    the Triton SGM kernel computes the same per-path float32 sums in the
    same order as the XLA scans."""
    import numpy as np
    from stereovisionarray_tpu.config import PlaneSweepConfig, SGMConfig
    from stereovisionarray_tpu.datasets import SceneSpec, reference_rig, render_camera_array
    from stereovisionarray_tpu.models.plane_sweep import plane_sweep_depth

    res = (48, 64)
    cams = reference_rig(rows=3, cols=3, resolution=res)
    imgs, _ = render_camera_array(cams, res, SceneSpec())
    cfg = PlaneSweepConfig(num_planes=32)
    sc = SGMConfig(num_paths=4, lr_max_diff=0.0)
    src = (0, 1, 2, 3, 5, 6, 7, 8)
    a = plane_sweep_depth(jnp.asarray(imgs), cams, 4, src, cfg, sc, backend="xla")
    b = plane_sweep_depth(jnp.asarray(imgs), cams, 4, src, cfg, sc,
                          backend="pallas_interpret")
    np.testing.assert_array_equal(np.asarray(a.valid), np.asarray(b.valid))
    np.testing.assert_array_equal(np.asarray(a.plane), np.asarray(b.plane))
    np.testing.assert_array_equal(np.asarray(a.depth), np.asarray(b.depth))


def test_plane_chunk_remainder_matches_unchunked(rig_data):
    """_chunked_plane_map pads the plane axis to a chunk multiple (repeat of
    the last plane) and slices the pad off — the volume must be identical to
    plane-at-a-time mapping for a plane count that does NOT divide the
    chunk (here 40 planes, chunk 16 -> 3 chunks with 8 planes of pad)."""
    rig, imgs, _ = rig_data
    base = PlaneSweepConfig(
        num_planes=40, z_near=0.8, z_far=1.05, cost="census", patch=7,
        fusion="topk_mean", topk=4,
    )
    cfg_chunk = dataclasses.replace(base, plane_chunk=16)
    cfg_one = dataclasses.replace(base, plane_chunk=1)
    v_chunk, nv_chunk, _ = plane_sweep_volume(imgs, rig, REF, SRC, cfg_chunk)
    v_one, nv_one, _ = plane_sweep_volume(imgs, rig, REF, SRC, cfg_one)
    np.testing.assert_allclose(np.asarray(v_chunk), np.asarray(v_one), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(nv_chunk), np.asarray(nv_one))


def test_zncc_pallas_backend_skips_quantization(rig_data):
    """zncc costs live in [0, 2] with sub-unit penalties: the plane-sweep
    volume is aggregated unquantized in float32 on the kernel path too, so
    its winners match the XLA scans' (a quantized path would collapse the
    costs to 9 levels and round sub-0.125 penalties to zero)."""
    rig, imgs, deps = rig_data
    cfg = dataclasses.replace(CFG, cost="zncc", patch=7)
    sgm = SGMConfig(p1=0.05, p2=0.5, adaptive_p2=False, lr_max_diff=0.0)
    ref = plane_sweep_depth(imgs, rig, REF, SRC, cfg, sgm, backend="xla")
    out = plane_sweep_depth(
        imgs, rig, REF, SRC, cfg, sgm, backend="pallas_interpret"
    )
    rd, rv = np.asarray(ref.depth), np.asarray(ref.valid)
    od, ov = np.asarray(out.depth), np.asarray(out.valid)
    both = rv & ov & _inner_mask(rv)
    assert both.sum() > 0.5 * _inner_mask(rv).sum()
    # float32 aggregation on both sides: plane winners must agree except
    # for exact ties; depths then agree to subpixel-parabola noise
    rel = np.abs(od[both] - rd[both]) / rd[both]
    assert np.median(rel) < 5e-3, f"median rel {np.median(rel)}"
    assert (rel < 0.02).mean() > 0.97, f"agree frac {(rel < 0.02).mean()}"


def test_census_tiny_penalties_fall_back_to_float(rig_data):
    """Census costs with a nonzero penalty below one fixed-point step
    (p1=0.1 < 1/COST_SCALE): the kernel path aggregates the float volume,
    so P1 is not silently zeroed."""
    rig, imgs, _ = rig_data
    sgm = SGMConfig(p1=0.1, p2=8.0, adaptive_p2=False, lr_max_diff=0.0)
    ref = plane_sweep_depth(imgs, rig, REF, SRC, CFG, sgm, backend="xla")
    out = plane_sweep_depth(
        imgs, rig, REF, SRC, CFG, sgm, backend="pallas_interpret"
    )
    rd, rv = np.asarray(ref.depth), np.asarray(ref.valid)
    od, ov = np.asarray(out.depth), np.asarray(out.valid)
    both = rv & ov & _inner_mask(rv)
    rel = np.abs(od[both] - rd[both]) / rd[both]
    assert np.median(rel) < 5e-3, f"median rel {np.median(rel)}"
