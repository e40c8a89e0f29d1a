"""Distributed tests on the 8-device virtual CPU mesh (SURVEY.md §4:
"jax.distributed multi-process tests on CPU backend ... so disparity-sharding
and Schur-reduction collectives are testable without a pod")."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stereovisionarray_tpu.config import CostConfig, SGMConfig
from stereovisionarray_tpu.models.two_view import two_view_disparity
from stereovisionarray_tpu.ops.cost_volume import fused_cost_volume
from stereovisionarray_tpu.ops.wta import winner_take_all
from stereovisionarray_tpu.parallel import (
    make_mesh,
    sharded_two_view_disparity,
    sharded_wta,
)
from stereovisionarray_tpu.parallel.mesh import default_mesh_shape


def _stereo_batch(rng, b=2, h=48, w=64, d_true=5):
    """Synthetic rectified batch: right = left shifted d_true px, box-smoothed
    so census windows carry structure."""
    lefts, rights = [], []

    def box(img):
        p = np.pad(img, 1, mode="edge")
        return (
            p[:-2, :-2] + p[:-2, 1:-1] + p[:-2, 2:] + p[1:-1, :-2] + p[1:-1, 1:-1]
            + p[1:-1, 2:] + p[2:, :-2] + p[2:, 1:-1] + p[2:, 2:]
        ) / 9.0

    for _ in range(b):
        base = box(rng.uniform(0, 255, size=(h, w + d_true)).astype(np.float32))
        # left sees content d_true px to the right of where right sees it:
        # left[x] = base[x], right[x] = base[x + d] => right[x - d] = left[x]
        lefts.append(base[:, :w])
        rights.append(base[:, d_true:])
    return np.stack(lefts), np.stack(rights)


CFG_COST = CostConfig(num_disparities=16, census_window=(5, 5))
CFG_SGM = SGMConfig(p1=4.0, p2=32.0, num_paths=8, adaptive_p2=True)


class TestHaloExchange:
    """exchange_halo / mask_out_of_image vs a numpy padding oracle, single-
    and multi-hop (halo > block relays whole blocks around the ring)."""

    @pytest.mark.parametrize("halo", [2, 4, 7, 11, 21, 28])
    @pytest.mark.parametrize("mode", ["edge", "fill"])
    def test_exchange_matches_pad_oracle(self, halo, mode):
        from jax.sharding import PartitionSpec as P

        from stereovisionarray_tpu.parallel.halo import exchange_halo

        n, blk, w = 8, 4, 16
        full = np.arange(n * blk * w, dtype=np.float32).reshape(n * blk, w)
        mesh = make_mesh(1, 8, 1)

        def local(b):
            b = b[0]  # drop the data-axis singleton
            return exchange_halo(
                b, halo, "tile", axis=0, edge_fill=-7.0, edge_mode=mode
            )[None]

        ext = jax.jit(jax.shard_map(
            local, mesh=mesh,
            in_specs=P("data", "tile", None),
            out_specs=P("data", "tile", None),
            check_vma=False,
        ))(jnp.asarray(full)[None])[0]
        ext = np.asarray(ext).reshape(n, blk + 2 * halo, w)
        if mode == "edge":
            padded = np.pad(full, ((halo, halo), (0, 0)), mode="edge")
        else:
            padded = np.pad(full, ((halo, halo), (0, 0)),
                            constant_values=-7.0)
        for i in range(n):
            want = padded[i * blk : i * blk + blk + 2 * halo]
            np.testing.assert_array_equal(ext[i], want, err_msg=f"shard {i}")

    @pytest.mark.parametrize("halo", [3, 9, 28])
    def test_mask_out_of_image_global_positions(self, halo):
        from jax.sharding import PartitionSpec as P

        from stereovisionarray_tpu.parallel.halo import (
            exchange_halo,
            mask_out_of_image,
        )

        n, blk, w = 8, 4, 8
        full = np.arange(n * blk * w, dtype=np.float32).reshape(n * blk, w)
        mesh = make_mesh(1, 8, 1)

        def local(b):
            ext = exchange_halo(b[0], halo, "tile", axis=0, edge_mode="edge")
            return mask_out_of_image(ext, halo, "tile", axis=0,
                                     fill_value=-1.0)[None]

        ext = jax.jit(jax.shard_map(
            local, mesh=mesh,
            in_specs=P("data", "tile", None),
            out_specs=P("data", "tile", None),
            check_vma=False,
        ))(jnp.asarray(full)[None])[0]
        ext = np.asarray(ext).reshape(n, blk + 2 * halo, w)
        for i in range(n):
            g = i * blk + np.arange(blk + 2 * halo) - halo
            oob = (g < 0) | (g >= n * blk)
            want = np.where(oob[:, None], -1.0,
                            full[np.clip(g, 0, n * blk - 1)])
            np.testing.assert_array_equal(ext[i], want, err_msg=f"shard {i}")


class TestMesh:
    def test_default_shape_products(self):
        for n in (1, 2, 4, 8, 16):
            shape = default_mesh_shape(n)
            assert int(np.prod(shape)) == n

    def test_make_mesh(self):
        mesh = make_mesh(2, 2, 2)
        assert mesh.shape == {"data": 2, "tile": 2, "disp": 2}


class TestShardedTwoView:
    def _run(self, rng, mesh_shape, halo):
        left, right = _stereo_batch(rng)
        mesh = make_mesh(*mesh_shape)
        out = sharded_two_view_disparity(
            jnp.asarray(left), jnp.asarray(right), mesh, CFG_COST, CFG_SGM, halo=halo
        )
        ref = jax.vmap(
            lambda l, r: two_view_disparity(l, r, CFG_COST, CFG_SGM)[:3]
        )(jnp.asarray(left), jnp.asarray(right))
        d_sh, v_sh = np.asarray(out.disparity), np.asarray(out.valid)
        d_ref, v_ref = np.asarray(ref[0]), np.asarray(ref[1])
        exact = ((np.abs(d_sh - d_ref) < 1e-3) | (~v_ref & ~v_sh)).mean()
        close = ((np.abs(d_sh - d_ref) < 0.5) | (~v_ref & ~v_sh)).mean()
        return exact, close

    @pytest.mark.parametrize("mesh_shape", [(1, 2, 4), (1, 1, 8)])
    def test_exact_when_halo_covers_block(self, rng, mesh_shape):
        """With halo >= local block size (or no tile sharding), every SGM
        path sees its full history: data/disp sharding and fully-covered tile
        sharding must reproduce the unsharded result bit-for-bit."""
        exact, _ = self._run(rng, mesh_shape, halo=32)
        assert exact == 1.0, f"exact {exact} on mesh {mesh_shape}"

    @pytest.mark.parametrize("mesh_shape,halo,bound", [((2, 2, 2), 16, 0.97)])
    def test_truncated_halo_close(self, rng, mesh_shape, halo, bound):
        """Small halos truncate vertical/diagonal path history; agreement
        must stay high and degrade gracefully (SURVEY.md §7 'hard parts')."""
        _, close = self._run(rng, mesh_shape, halo)
        assert close > bound, f"within-0.5px {close} on mesh {mesh_shape}"

    # (2,2,2) exercises all axes; (1,2,4) the max disp split (two paths
    # per shard); (2,4,1) the undivided disp axis
    @pytest.mark.parametrize("mesh_shape", [(1, 2, 4), (2, 2, 2), (2, 4, 1)])
    def test_pallas_backend_matches_single_chip(self, mesh_shape):
        """The Triton SGM kernel (interpreted) under shard_map — halo mode
        with path parallelism over the disp axis — must reproduce the
        single-device pipeline on the same backend exactly when the halo
        covers the FULL remaining image (multi-hop exchange): integer path
        sums psum exactly.

        The input is pinned to the batch that once exposed truncated SGM
        carry history at a one-block halo (5 left-border pixels of rng(0)'s
        third batch)."""
        from stereovisionarray_tpu.ops.wta import INVALID_DISPARITY

        local_rng = np.random.default_rng(0)
        _stereo_batch(local_rng)
        _stereo_batch(local_rng)
        left, right = _stereo_batch(local_rng)  # the once-failing batch
        mesh = make_mesh(*mesh_shape)
        out = sharded_two_view_disparity(
            jnp.asarray(left), jnp.asarray(right), mesh, CFG_COST, CFG_SGM,
            halo=36, backend="pallas_interpret",
        )
        ref = jax.vmap(
            lambda l, r: two_view_disparity(
                l, r, CFG_COST, CFG_SGM, backend="pallas_interpret"
            )
        )(jnp.asarray(left), jnp.asarray(right))
        d_sh, v_sh = np.asarray(out.disparity), np.asarray(out.valid)
        d_ref, v_ref = np.asarray(ref.disparity), np.asarray(ref.valid)
        exact = ((np.abs(d_sh - d_ref) < 1e-3) | (~v_ref & ~v_sh)).mean()
        assert exact == 1.0, f"exact {exact} on mesh {mesh_shape}"
        # TwoViewOutput contract: rejected pixels carry the sentinel
        assert (d_sh[~v_sh] == INVALID_DISPARITY).all()
        # confidence plumbs through shard_map and matches single-device
        c_sh = np.asarray(out.confidence)
        c_ref = np.asarray(ref.confidence)
        both = v_sh & v_ref
        assert np.abs(c_sh[both] - c_ref[both]).max() < 1e-5
        assert (c_sh[~v_sh] == 0.0).all()

    @pytest.mark.parametrize("mesh_shape", [(1, 8, 1), (2, 4, 1)])
    def test_exact_tile_mode_bit_identical(self, rng, mesh_shape):
        """tile_mode='exact' (ppermute carry relay) must reproduce the
        unsharded XLA pipeline BIT-FOR-BIT at any tile count, with no halo
        tuning (VERDICT r1 item 4)."""
        left, right = _stereo_batch(rng)
        mesh = make_mesh(*mesh_shape)
        out = sharded_two_view_disparity(
            jnp.asarray(left), jnp.asarray(right), mesh, CFG_COST, CFG_SGM,
            halo=0, backend="xla", tile_mode="exact",
        )
        ref = jax.vmap(
            lambda l, r: two_view_disparity(l, r, CFG_COST, CFG_SGM, backend="xla")[:3]
        )(jnp.asarray(left), jnp.asarray(right))
        np.testing.assert_array_equal(np.asarray(out.disparity), np.asarray(ref[0]))
        np.testing.assert_array_equal(np.asarray(out.valid), np.asarray(ref[1]))
        np.testing.assert_array_equal(np.asarray(out.cost), np.asarray(ref[2]))

    def test_exact_tile_mode_rejects_disp_axis(self, rng):
        """disp > 1 would put UNEVEN relay-collective counts inside switch
        branches (chunk {0,1,2,3}: 2 relays vs {4,5,6,7}: 4) and deadlock
        the mesh — must be rejected up front."""
        left, right = _stereo_batch(rng)
        mesh = make_mesh(1, 4, 2)
        with pytest.raises(ValueError, match="disp"):
            sharded_two_view_disparity(
                jnp.asarray(left), jnp.asarray(right), mesh, CFG_COST, CFG_SGM,
                backend="xla", tile_mode="exact",
            )

    @pytest.mark.parametrize("dtype", ["int16", "int8"])
    @pytest.mark.parametrize("mesh_shape", [(1, 8, 1), (2, 4, 1)])
    def test_exact_tile_mode_pallas_bit_identical(self, rng, mesh_shape,
                                                  dtype):
        """Exact tile mode relays XLA scan carries; with integer costs its
        sums are exact, so it must match the single-device pipeline on the
        Triton kernel (interpreted) bit for bit at any tile count."""
        import dataclasses

        left, right = _stereo_batch(rng)
        cc = dataclasses.replace(CFG_COST, dtype=dtype)
        mesh = make_mesh(*mesh_shape)
        out = sharded_two_view_disparity(
            jnp.asarray(left), jnp.asarray(right), mesh, cc, CFG_SGM,
            halo=0, backend="pallas_interpret", tile_mode="exact",
        )
        ref = jax.vmap(
            lambda l, r: two_view_disparity(
                l, r, cc, CFG_SGM, backend="pallas_interpret"
            )[:3]
        )(jnp.asarray(left), jnp.asarray(right))
        np.testing.assert_array_equal(np.asarray(out.disparity),
                                      np.asarray(ref[0]))
        np.testing.assert_array_equal(np.asarray(out.valid),
                                      np.asarray(ref[1]))
        np.testing.assert_array_equal(np.asarray(out.cost),
                                      np.asarray(ref[2]))

    def test_exact_tile_mode_4path_bit_identical(self, rng):
        """The carry relay threads any path subset: 4-path exact tiling
        reproduces the single-device 4-path pipeline bit for bit."""
        import dataclasses

        left, right = _stereo_batch(rng)
        sgm4 = dataclasses.replace(CFG_SGM, num_paths=4)
        mesh = make_mesh(1, 8, 1)
        out = sharded_two_view_disparity(
            jnp.asarray(left), jnp.asarray(right), mesh, CFG_COST, sgm4,
            backend="xla", tile_mode="exact",
        )
        ref = jax.vmap(
            lambda l, r: two_view_disparity(l, r, CFG_COST, sgm4, backend="xla")[:3]
        )(jnp.asarray(left), jnp.asarray(right))
        np.testing.assert_array_equal(np.asarray(out.disparity), np.asarray(ref[0]))
        np.testing.assert_array_equal(np.asarray(out.cost), np.asarray(ref[2]))

    def test_rejects_disp_axis_not_dividing_paths(self, rng):
        import dataclasses

        left, right = _stereo_batch(rng)
        mesh = make_mesh(1, 1, 8)
        with pytest.raises(ValueError, match="divide"):
            sharded_two_view_disparity(
                jnp.asarray(left), jnp.asarray(right), mesh, CFG_COST,
                dataclasses.replace(CFG_SGM, num_paths=4),
            )

    def test_true_disparity_recovered(self, rng):
        d_true = 5
        left, right = _stereo_batch(rng, d_true=d_true)
        # same mesh/halo as test_truncated_halo_close -> jit cache hit
        mesh = make_mesh(2, 2, 2)
        out = sharded_two_view_disparity(
            jnp.asarray(left), jnp.asarray(right), mesh, CFG_COST, CFG_SGM, halo=16
        )
        d = np.asarray(out.disparity)
        v = np.asarray(out.valid)
        inner = np.zeros_like(v)
        inner[:, 8:-8, 12:-12] = True
        sel = v & inner
        assert sel.sum() / inner.sum() > 0.9  # nearly all interior pixels valid
        assert np.abs(d[sel] - d_true).mean() < 0.5


class TestShardedFusion:
    """sharded_fuse_depth_maps: view-axis data parallelism over the mesh
    must reproduce the single-device fusion bit-for-bit (P1 applied to the
    fusion subsystem), including ragged padding."""

    @pytest.mark.parametrize("n_views,mesh_shape", [(8, (8, 1, 1)),
                                                    (9, (4, 2, 1)),
                                                    (9, (8, 1, 1))])
    def test_matches_single_device(self, n_views, mesh_shape):
        from stereovisionarray_tpu.datasets import (
            SceneSpec,
            reference_rig,
            render_camera_array,
        )
        from stereovisionarray_tpu.models.fusion import fuse_depth_maps
        from stereovisionarray_tpu.parallel.fusion import sharded_fuse_depth_maps

        res = (32, 48)
        cams = reference_rig(rows=3, cols=3, spacing=0.05, resolution=res)
        _, depths = render_camera_array(cams, res, SceneSpec())
        cams = cams[jnp.arange(n_views)]
        depths = jnp.asarray(depths[:n_views])
        # knock out a corner of one view so validity paths are exercised
        valid = jnp.ones(depths.shape, bool).at[2, :8, :8].set(False)
        mesh = make_mesh(*mesh_shape)
        for dedup in (True, False):
            want = fuse_depth_maps(cams, depths, valid=valid,
                                   rel_thresh=0.01, min_support=3,
                                   dedup=dedup)
            got = sharded_fuse_depth_maps(cams, depths, mesh, valid=valid,
                                          rel_thresh=0.01, min_support=3,
                                          dedup=dedup)
            np.testing.assert_array_equal(np.asarray(got.valid),
                                          np.asarray(want.valid))
            np.testing.assert_array_equal(np.asarray(got.support),
                                          np.asarray(want.support))
            np.testing.assert_allclose(np.asarray(got.depth),
                                       np.asarray(want.depth), atol=1e-6)
            np.testing.assert_allclose(np.asarray(got.confidence),
                                       np.asarray(want.confidence), atol=1e-6)


class TestShardedPlaneSweep:
    def _setup(self, rng, b=2):
        from stereovisionarray_tpu.config import PlaneSweepConfig
        from stereovisionarray_tpu.datasets import (
            SceneSpec,
            reference_rig,
            render_camera_array,
        )

        rows = cols = 3
        res = (48, 64)
        cams = reference_rig(rows=rows, cols=cols, spacing=0.05, resolution=res)
        images, _ = render_camera_array(cams, res, SceneSpec())
        batch = np.stack([images + 2.0 * i for i in range(b)])  # (B, N, H, W)
        cfg = PlaneSweepConfig(num_planes=16, patch=5, topology="CROSS")
        src = (1, 3, 5, 7)
        return jnp.asarray(batch), cams, cfg, src

    @pytest.mark.parametrize("mesh_shape", [(1, 1, 8), (2, 1, 4)])
    def test_matches_unsharded(self, rng, mesh_shape):
        """Plane-sharded sweep + path-parallel SGM must reproduce the
        single-device plane_sweep_depth (planes are independent — the sweep
        phase shards with zero communication; VERDICT r1 item 7)."""
        from stereovisionarray_tpu.models.plane_sweep import plane_sweep_depth
        from stereovisionarray_tpu.parallel import sharded_plane_sweep_depth

        batch, cams, cfg, src = self._setup(rng)
        sgm = SGMConfig(p1=4.0, p2=32.0, num_paths=8, adaptive_p2=True)
        mesh = make_mesh(*mesh_shape)
        out = sharded_plane_sweep_depth(
            batch, cams, 4, src, mesh, cfg, sgm_cfg=sgm
        )
        for i in range(batch.shape[0]):
            ref = plane_sweep_depth(batch[i], cams, 4, src, cfg, sgm_cfg=sgm,
                                    backend="xla")
            d_sh = np.asarray(out.depth[i])
            d_ref = np.asarray(ref.depth)
            both = np.asarray(out.valid[i]) & np.asarray(ref.valid)
            rel = np.abs(d_sh - d_ref)[both] / np.maximum(d_ref[both], 1e-6)
            # psum adds the 8 path volumes in a different f32 order than the
            # sequential unsharded accumulation; near-tied planes can flip
            # by one plane step (~6% depth here) on a few pixels — exact
            # bit-determinism across shardings needs integer costs (the
            # two-view int16 path), not float top-k means
            assert np.median(rel) < 1e-3, f"median rel {np.median(rel)}"
            assert (rel < 0.02).mean() > 0.97, f"close frac {(rel < 0.02).mean()}"
            agree = (np.asarray(out.valid[i]) == np.asarray(ref.valid)).mean()
            assert agree > 0.98, f"valid agreement {agree}"
            # confidence rides through shard_map and tracks the unsharded
            # field (same PKRN definition; psum reorders f32 sums slightly)
            c_sh = np.asarray(out.confidence[i])
            c_ref = np.asarray(ref.confidence)
            cd = np.abs(c_sh - c_ref)[both]
            # psum reorders the f32 path sums; PKRN divides two such sums,
            # so the tolerance is looser than the depth field's
            assert np.median(cd) < 0.01, f"median conf diff {np.median(cd)}"
            assert np.percentile(cd, 90) < 0.05
            assert (c_sh[~np.asarray(out.valid[i])] == 0.0).all()

    def test_pallas_sweep_kernel_under_shard_map(self, rng):
        """The Triton SGM kernel (interpreted) inside the plane-sharded
        sweep's shard_map — path subsets per disp shard, psum'd — must
        reproduce the XLA backend: both compute the same per-path float32
        sums in the same order."""
        from stereovisionarray_tpu.parallel import sharded_plane_sweep_depth
        from stereovisionarray_tpu.models.plane_sweep import (
            inverse_depth_samples,
        )

        batch, cams, cfg, src = self._setup(rng)
        depths = inverse_depth_samples(cfg.z_near, cfg.z_far, cfg.num_planes)
        H_all = cams.fronto_plane_homography(4, jnp.asarray(src), depths)
        shifts = np.asarray(H_all[..., :2, 2] / H_all[..., 2:3, 2])
        pad = int(np.ceil(np.abs(shifts).max())) + 1
        sgm = SGMConfig(p1=4.0, p2=32.0, num_paths=8, adaptive_p2=True)
        mesh = make_mesh(2, 1, 4)
        out_x = sharded_plane_sweep_depth(
            batch, cams, 4, src, mesh, cfg, sgm_cfg=sgm, shift_pad=pad,
            backend="xla",
        )
        out_p = sharded_plane_sweep_depth(
            batch, cams, 4, src, mesh, cfg, sgm_cfg=sgm, shift_pad=pad,
            backend="pallas_interpret",
        )
        np.testing.assert_array_equal(np.asarray(out_p.valid),
                                      np.asarray(out_x.valid))
        np.testing.assert_allclose(np.asarray(out_p.depth),
                                   np.asarray(out_x.depth), rtol=1e-6)

    def test_rejects_tile_axis(self, rng):
        from stereovisionarray_tpu.parallel import sharded_plane_sweep_depth

        batch, cams, cfg, src = self._setup(rng)
        mesh = make_mesh(1, 2, 4)
        with pytest.raises(ValueError, match="tile"):
            sharded_plane_sweep_depth(batch, cams, 4, src, mesh, cfg)


class TestShardedCascadeSweep:
    """Plane-sharded cascade (parallel/cascade_sweep.py): the banded fine
    sweep's planes shard like the flat sweep's (coarse pass + band pre-warp
    replicate across the disp axis)."""

    def _setup(self, b=2):
        from stereovisionarray_tpu.config import PlaneSweepConfig
        from stereovisionarray_tpu.datasets import (
            SceneSpec,
            reference_rig,
            render_camera_array,
        )

        res = (48, 64)
        cams = reference_rig(rows=3, cols=3, spacing=0.05,
                             origin=(-0.05, -0.05), resolution=res)
        images, _ = render_camera_array(cams, res, SceneSpec())
        batch = np.stack([images + 2.0 * i for i in range(b)])
        cfg = PlaneSweepConfig(num_planes=32, patch=5, topology="CROSS")
        return jnp.asarray(batch), cams, cfg, (1, 3, 5, 7)

    @pytest.mark.parametrize("mesh_shape", [(1, 1, 8), (2, 1, 4)])
    def test_matches_unsharded_cascade(self, mesh_shape):
        from stereovisionarray_tpu.models.cascade_sweep import (
            cascade_plane_sweep_depth,
            cascade_static_params,
        )
        from stereovisionarray_tpu.parallel import sharded_cascade_sweep_depth

        batch, cams, cfg, src = self._setup()
        sgm = SGMConfig(p1=4.0, p2=32.0, num_paths=8, adaptive_p2=True)
        bo, _ = cascade_static_params(cams, 4, src, cfg, 16)
        mesh = make_mesh(*mesh_shape)
        out = sharded_cascade_sweep_depth(
            batch, cams, 4, src, mesh, cfg, sgm_cfg=sgm, shift_pad=12,
            coarse_factor=2, fine_planes=16, band_step=4, band_offsets=bo,
        )
        for i in range(batch.shape[0]):
            ref = cascade_plane_sweep_depth(
                batch[i], cams, 4, src, cfg, sgm, shift_pad=12,
                coarse_factor=2, fine_planes=16, band_step=4,
                band_offsets=bo, backend="xla",
            )
            both = np.asarray(out.valid[i]) & np.asarray(ref.valid)
            d_sh, d_ref = np.asarray(out.depth[i]), np.asarray(ref.depth)
            rel = np.abs(d_sh - d_ref)[both] / np.maximum(d_ref[both], 1e-6)
            # path-split psum reorders f32 sums vs the single-chip 8-path
            # aggregation (the TestShardedPlaneSweep tolerance rationale)
            assert np.median(rel) < 1e-3, f"median rel {np.median(rel)}"
            assert (rel < 0.02).mean() > 0.97, f"close frac {(rel < 0.02).mean()}"
            agree = (np.asarray(out.valid[i]) == np.asarray(ref.valid)).mean()
            assert agree > 0.98, f"valid agreement {agree}"
            np.testing.assert_array_equal(
                np.asarray(out.num_views[i]), np.asarray(ref.num_views)
            )

    def test_rejects_flat_rig_and_tile_axis(self):
        from stereovisionarray_tpu.parallel import sharded_cascade_sweep_depth

        batch, cams, cfg, src = self._setup()
        with pytest.raises(ValueError, match="translation"):
            sharded_cascade_sweep_depth(
                batch, cams, 4, src, make_mesh(1, 1, 8), cfg, shift_pad=0
            )
        with pytest.raises(ValueError, match="tile"):
            sharded_cascade_sweep_depth(
                batch, cams, 4, src, make_mesh(1, 2, 4), cfg, shift_pad=12,
                fine_planes=16, band_step=4,
            )


class TestShardedWTA:
    def test_matches_unsharded(self, rng):
        vol = jnp.asarray(rng.uniform(0, 64, size=(32, 128, 32)).astype(np.float32))
        mesh = make_mesh(1, 2, 4)
        d_sh, c_sh = sharded_wta(vol, mesh)
        d_ref, c_ref = winner_take_all(vol)
        np.testing.assert_array_equal(np.asarray(d_sh), np.asarray(d_ref))
        np.testing.assert_allclose(np.asarray(c_sh), np.asarray(c_ref), rtol=1e-6)

    def test_tie_break_lowest_d(self):
        vol = jnp.zeros((8, 128, 32), dtype=jnp.float32)  # all ties
        mesh = make_mesh(1, 2, 4)
        d_sh, _ = sharded_wta(vol, mesh)
        assert np.all(np.asarray(d_sh) == 0)


class TestDispOffset:
    def test_cost_chunks_concatenate(self, rng):
        left, right = _stereo_batch(rng, b=1)
        l, r = jnp.asarray(left[0]), jnp.asarray(right[0])
        full = fused_cost_volume(l, r, 16, census_window=(5, 5))
        chunks = [
            fused_cost_volume(l, r, 4, census_window=(5, 5), d_offset=o)
            for o in (0, 4, 8, 12)
        ]
        np.testing.assert_allclose(
            np.asarray(jnp.concatenate(chunks, axis=-1)), np.asarray(full), rtol=1e-6
        )


class TestDistributedBA:
    def test_matches_single_device(self):
        """Observation-sharded Schur BA must match the replicated solve to
        float-reduction tolerance (config 5, SURVEY.md §2.2 P5).

        PINNED local rng, not the shared session stream: the two solves'
        different f32 reduction orders let a near-degenerate point drift
        past atol for ~2% of random draws, so the test outcome used to
        depend on how many session-rng draws earlier tests consumed
        (failed when the file ran ALONE, passed inside the full suite —
        the halo test's latent-flakiness pattern, CLAUDE.md)."""
        from stereovisionarray_tpu.geometry.camera import translation_only_array
        from stereovisionarray_tpu.parallel.ba import distributed_bundle_adjust
        from stereovisionarray_tpu.sfm.ba import BAProblem, bundle_adjust

        rng = np.random.default_rng(11)

        pos = np.array(
            [[0, 0, -0.75], [0.05, 0, -0.75], [0, 0.05, -0.75], [-0.05, 0, -0.75]],
            dtype=np.float32,
        )
        cams = translation_only_array(0.05, pos, 1e-4, resolution=(270, 360))
        n_pts = 32
        X = np.stack(
            [
                rng.uniform(-0.05, 0.05, n_pts),
                rng.uniform(-0.05, 0.05, n_pts),
                rng.uniform(0.1, 0.3, n_pts),
            ],
            axis=-1,
        ).astype(np.float32)
        ci = np.repeat(np.arange(4), n_pts).astype(np.int32)
        pi = np.tile(np.arange(n_pts), 4).astype(np.int32)
        uv, _ = cams[jnp.asarray(ci)].project_each(jnp.asarray(X)[jnp.asarray(pi)])
        uv_c = np.asarray(uv) - np.stack(
            [np.asarray(cams.cx)[ci], np.asarray(cams.cy)[ci]], -1
        )
        # perturb points so BA has work to do
        X_bad = X + rng.normal(0, 0.005, X.shape).astype(np.float32)
        prob = BAProblem(
            cam_idx=jnp.asarray(ci), pt_idx=jnp.asarray(pi),
            uv=jnp.asarray(uv_c), valid=jnp.ones(len(ci), dtype=bool),
        )
        ref = bundle_adjust(cams, jnp.asarray(X_bad), prob, iterations=8)
        mesh = make_mesh(2, 2, 2)
        dist = distributed_bundle_adjust(
            cams, jnp.asarray(X_bad), prob, mesh, iterations=8
        )
        assert float(np.asarray(dist.cost)[-1]) < 1e-6
        np.testing.assert_allclose(
            np.asarray(dist.cameras.centers), np.asarray(ref.cameras.centers),
            atol=1e-5,
        )
        np.testing.assert_allclose(
            np.asarray(dist.points), np.asarray(ref.points), atol=1e-4
        )

    def test_padding_indivisible_obs(self, rng):
        """An observation count not divisible by the device count is padded
        with valid=False slots and still solves."""
        from stereovisionarray_tpu.geometry.camera import translation_only_array
        from stereovisionarray_tpu.parallel.ba import distributed_bundle_adjust
        from stereovisionarray_tpu.sfm.ba import BAProblem

        pos = np.array(
            [[0, 0, -0.75], [0.05, 0, -0.75], [0, 0.05, -0.75]], dtype=np.float32
        )
        cams = translation_only_array(0.05, pos, 1e-4, resolution=(270, 360))
        n_pts = 11  # 33 obs, not divisible by 8
        X = np.stack(
            [
                rng.uniform(-0.05, 0.05, n_pts),
                rng.uniform(-0.05, 0.05, n_pts),
                rng.uniform(0.1, 0.3, n_pts),
            ],
            axis=-1,
        ).astype(np.float32)
        ci = np.repeat(np.arange(3), n_pts).astype(np.int32)
        pi = np.tile(np.arange(n_pts), 3).astype(np.int32)
        uv, _ = cams[jnp.asarray(ci)].project_each(jnp.asarray(X)[jnp.asarray(pi)])
        uv_c = np.asarray(uv) - np.stack(
            [np.asarray(cams.cx)[ci], np.asarray(cams.cy)[ci]], -1
        )
        prob = BAProblem(
            cam_idx=jnp.asarray(ci), pt_idx=jnp.asarray(pi),
            uv=jnp.asarray(uv_c), valid=jnp.ones(len(ci), dtype=bool),
        )
        mesh = make_mesh(1, 2, 4)
        out = distributed_bundle_adjust(
            cams, jnp.asarray(X), prob, mesh, iterations=3
        )
        assert np.isfinite(np.asarray(out.points)).all()
