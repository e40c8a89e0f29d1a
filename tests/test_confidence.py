"""Confidence subsystem (ops/confidence.py + the second-best export from the
extraction kernels): PKRN math, kernel-vs-oracle agreement, and the
behavioral property that ambiguity shows up as low confidence."""

import numpy as np
import jax.numpy as jnp

from stereovisionarray_tpu.config import CostConfig, SGMConfig
from stereovisionarray_tpu.models.two_view import two_view_disparity
from stereovisionarray_tpu.ops.confidence import (
    confidence_from_volume,
    pkrn_confidence,
    second_best_cost,
)
from stereovisionarray_tpu.ops.wta import winner_take_all


class TestPkrnMath:
    def test_limits(self):
        best = jnp.asarray([[1.0, 1.0, 0.0]])
        second = jnp.asarray([[1.0, 100.0, 5.0]])
        conf = np.asarray(pkrn_confidence(best, second))
        assert conf[0, 0] == 0.0  # tie -> fully ambiguous
        assert 0.98 < conf[0, 1] < 1.0  # dominant winner
        assert conf[0, 2] > 0.999  # zero-cost winner
        # a zero-cost TIE is still a tie (the additive-eps property)
        z = np.asarray(pkrn_confidence(jnp.zeros((1, 1)), jnp.zeros((1, 1))))
        assert z[0, 0] == 0.0
        valid = jnp.asarray([[True, False, True]])
        gated = np.asarray(pkrn_confidence(best, second, valid))
        assert gated[0, 1] == 0.0

    def test_scale_invariance(self):
        r = np.random.default_rng(0)
        c1 = jnp.asarray(r.uniform(0, 50, (8, 8)).astype(np.float32))
        c2 = c1 + jnp.asarray(r.uniform(1, 50, (8, 8)).astype(np.float32))
        a = np.asarray(pkrn_confidence(c1, c2))
        b = np.asarray(pkrn_confidence(4.0 * c1, 4.0 * c2))
        np.testing.assert_allclose(a, b, atol=1e-3)  # up to the tie eps

    def test_second_best_excludes_neighbours(self):
        vol = jnp.asarray(
            np.array([[[5, 1, 2, 9, 7, 6]]], dtype=np.float32)
        )  # winner d=1; d in {0,1,2} excluded -> second over {9, 7, 6} = 6
        d, _ = winner_take_all(vol)
        assert int(d[0, 0]) == 1
        sec = float(second_best_cost(vol, d)[0, 0])
        assert sec == 6.0


class TestKernelVsOracle:
    def test_two_view_backends_agree(self):
        """The XLA scans and the Triton kernel (interpret mode) compute the
        same int16 fixed-point sums, so the confidence fields are equal."""
        r = np.random.default_rng(2)
        base = r.uniform(0, 255, (32, 80)).astype(np.float32)
        left = jnp.asarray(base[:, :64])
        right = jnp.asarray(base[:, 8:72])
        ccfg = CostConfig(num_disparities=16, census_window=(5, 5), dtype="int16")
        scfg = SGMConfig(num_paths=4, uniqueness=0.0, lr_max_diff=0.0)
        a = two_view_disparity(left, right, ccfg, scfg, backend="xla")
        b = two_view_disparity(left, right, ccfg, scfg, backend="pallas_interpret")
        assert a.confidence is not None and b.confidence is not None
        np.testing.assert_array_equal(np.asarray(a.valid), np.asarray(b.valid))
        np.testing.assert_array_equal(np.asarray(a.confidence),
                                      np.asarray(b.confidence))


class TestBehaviour:
    def test_ambiguity_lowers_confidence(self):
        """Periodic stripes (period < D) admit multiple cost minima; the
        confidence field must report that, and report near-certainty on
        aperiodic random texture."""
        r = np.random.default_rng(3)
        h, w, D = 32, 96, 16
        tex = r.uniform(0, 255, (h, w + D)).astype(np.float32)
        stripes = np.tile(
            np.array([0, 0, 255.0, 255.0] * ((w + D) // 4), dtype=np.float32)[: w + D],
            (h, 1),
        )
        from stereovisionarray_tpu.ops import disparity_from_volume, fused_cost_volume

        def conf_of(img):
            # raw WTA (no SGM smoothing): ambiguity comes straight from the
            # matching costs
            left = jnp.asarray(img[:, :w])
            right = jnp.asarray(img[:, 4 : w + 4])
            vol = fused_cost_volume(left, right, D, census_window=(5, 5))
            res = disparity_from_volume(vol, with_confidence=True)
            inner = np.s_[4:-4, D:-4]
            return np.asarray(res.confidence)[inner]

        c_tex = conf_of(tex)
        c_str = conf_of(stripes)
        assert np.median(c_tex) > 0.5
        # stripes repeat every 4 px -> a cost minimum every 4 disparities;
        # second-best ~ best -> confidence collapses
        assert np.median(c_str) < 0.05
        assert np.median(c_tex) > np.median(c_str) + 0.4
