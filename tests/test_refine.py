"""Multi-view photoconsistency refinement (ops/refine.py) — the vectorized
`improveWithDisparity` (``/root/reference/src/functions.cpp:11-52``)."""

import numpy as np
import jax
import jax.numpy as jnp

from stereovisionarray_tpu.ops import box_filter2d, multiview_refine
from stereovisionarray_tpu.ops.warp import warp_with_disparity


def _textured(rng, h, w):
    """Smooth-ish random texture with enough gradient for photoconsistency."""
    base = rng.uniform(0.0, 255.0, size=(h // 4 + 2, w // 4 + 2)).astype(np.float32)
    up = np.kron(base, np.ones((4, 4), dtype=np.float32))[:h, :w]
    return up


def _make_views(reference, true_disp, baselines):
    """Each aux view is the reference sampled so that warping it back with
    `true_disp` along its baseline reproduces the reference: build aux by
    inverse resampling on a grid (valid away from borders)."""
    views = []
    h, w = reference.shape
    for b in baselines:
        # aux(y + d*by, x + d*bx) == ref(y, x)  =>  aux(u) = ref(u - d_at_src * b)
        # For a constant-gradient disparity this inverse is well-approximated
        # by resampling with the same (smooth) disparity field.
        v, u = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32), indexing="ij")
        su = u - true_disp * b[0]
        sv = v - true_disp * b[1]
        su = np.clip(su, 0, w - 1)
        sv = np.clip(sv, 0, h - 1)
        u0 = np.floor(su).astype(int)
        v0 = np.floor(sv).astype(int)
        fu = su - u0
        fv = sv - v0
        u1 = np.minimum(u0 + 1, w - 1)
        v1 = np.minimum(v0 + 1, h - 1)
        img = (
            reference[v0, u0] * (1 - fu) * (1 - fv)
            + reference[v0, u1] * fu * (1 - fv)
            + reference[v1, u0] * (1 - fu) * fv
            + reference[v1, u1] * fu * fv
        )
        views.append(img)
    return np.stack(views)


def test_refine_recovers_constant_offset():
    rng = np.random.default_rng(7)
    h, w = 64, 80
    ref = _textured(rng, h, w)
    true_disp = np.full((h, w), 6.0, dtype=np.float32)
    baselines = np.asarray([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0]], dtype=np.float32)
    aux = _make_views(ref, true_disp, baselines)

    init = jnp.asarray(true_disp + 3.0)  # constant 3 px error
    out = multiview_refine(
        jnp.asarray(ref), jnp.asarray(aux), jnp.asarray(baselines), init,
        radius=5, window=11,
    )
    inner = np.s_[12:-12, 12:-12]
    err = np.abs(np.asarray(out.disparity) - true_disp)[inner]
    init_err = np.abs(np.asarray(init) - true_disp)[inner]
    assert err.mean() < 0.5 * init_err.mean()
    assert err.mean() < 1.0


def test_refine_respects_mask_passthrough():
    rng = np.random.default_rng(1)
    h, w = 32, 32
    ref = _textured(rng, h, w)
    aux = np.stack([ref])
    baselines = jnp.asarray([[1.0, 0.0]], dtype=jnp.float32)
    init = jnp.full((h, w), 4.0, dtype=jnp.float32)
    mask = jnp.zeros((h, w), dtype=bool)
    out = multiview_refine(jnp.asarray(ref), jnp.asarray(aux), baselines, init, mask=mask, radius=3, window=7)
    np.testing.assert_array_equal(np.asarray(out.disparity), np.asarray(init))


def test_refine_warp_consistency_convention():
    """warp_with_disparity(aux, true_disp, b) ≈ ref inside the valid region —
    the convention multiview_refine scores against."""
    rng = np.random.default_rng(5)
    h, w = 48, 48
    ref = _textured(rng, h, w)
    d = np.full((h, w), 5.0, dtype=np.float32)
    b = np.asarray([1.0, 0.0], dtype=np.float32)
    aux = _make_views(ref, d, [b])[0]
    back, ok = warp_with_disparity(jnp.asarray(aux), jnp.asarray(d), jnp.asarray(b))
    inner = np.s_[8:-8, 8:-8]
    err = np.abs(np.asarray(back) - ref)[inner]
    assert err.mean() < 2.0


def test_box_filter_matches_naive():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(17, 13)).astype(np.float32)
    k = 5
    got = np.asarray(box_filter2d(jnp.asarray(x), k))
    r = k // 2
    pad = np.pad(x, r)  # zero padding: border windows sum in-bounds only
    want = np.zeros_like(x)
    for dy in range(k):
        for dx in range(k):
            want += pad[dy : dy + x.shape[0], dx : dx + x.shape[1]]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_subpixel_offset_recovery():
    """A fractional constant error should be recovered to < 0.35 px via the
    parabola fit (integer-only search could at best leave 0.5)."""
    rng = np.random.default_rng(11)
    h, w = 64, 64
    ref = _textured(rng, h, w)
    true_disp = np.full((h, w), 5.6, dtype=np.float32)
    baselines = np.asarray([[1.0, 0.0], [0.0, 1.0]], dtype=np.float32)
    aux = _make_views(ref, true_disp, baselines)
    init = jnp.asarray(np.full((h, w), 3.0, dtype=np.float32))
    out = multiview_refine(
        jnp.asarray(ref), jnp.asarray(aux), jnp.asarray(baselines), init,
        radius=5, window=9,
    )
    inner = np.s_[12:-12, 12:-12]
    err = np.abs(np.asarray(out.disparity) - true_disp)[inner]
    assert np.median(err) < 0.35


def test_exact_and_approx_warp_agree_on_smooth_disparity():
    """The single-gather approximation (exact_warp=False, the default)
    matches the literal re-gather objective on smooth disparity fields."""
    rng = np.random.default_rng(3)
    h, w = 64, 64
    ref = _textured(rng, h, w)
    v, u = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    true_disp = (4.0 + 2.0 * u / w).astype(np.float32)  # smooth gradient
    baselines = np.asarray([[1.0, 0.0], [0.0, 1.0]], dtype=np.float32)
    aux = _make_views(ref, true_disp, baselines)
    init = jnp.asarray(true_disp + 2.0)
    a = multiview_refine(jnp.asarray(ref), jnp.asarray(aux), jnp.asarray(baselines),
                         init, radius=4, window=9, exact_warp=True)
    b = multiview_refine(jnp.asarray(ref), jnp.asarray(aux), jnp.asarray(baselines),
                         init, radius=4, window=9, exact_warp=False)
    inner = np.s_[10:-10, 10:-10]
    d = np.abs(np.asarray(a.disparity) - np.asarray(b.disparity))[inner]
    assert np.median(d) < 0.1
    # both recover the truth
    for out in (a, b):
        err = np.abs(np.asarray(out.disparity) - true_disp)[inner]
        assert np.median(err) < 0.5


def test_candidate_stack_matches_exact_warp_axis_aligned():
    """The static candidate-stack fast path (concrete baselines +
    max_disparity) must reproduce the exact per-offset warp for axis-aligned
    baselines: hat-weight blending of integer-pixel shifted copies IS
    bilinear sampling along that axis."""
    rng = np.random.default_rng(11)
    h, w = 64, 80
    ref = _textured(rng, h, w)
    true_disp = np.full((h, w), 6.0, dtype=np.float32)
    true_disp[20:40, 20:50] = 9.0
    baselines = np.asarray([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0]], dtype=np.float32)
    aux = _make_views(ref, true_disp, baselines)
    init = jnp.asarray(true_disp + 2.0)

    kwargs = dict(radius=4, window=9, subpixel=True)
    fast = multiview_refine(
        jnp.asarray(ref), jnp.asarray(aux), baselines, init,
        max_disparity=20.0, **kwargs,
    )
    exact = multiview_refine(
        jnp.asarray(ref), jnp.asarray(aux), jnp.asarray(baselines), init,
        exact_warp=True, **kwargs,
    )
    fd = np.asarray(fast.disparity)
    ed = np.asarray(exact.disparity)
    both = np.asarray(fast.valid) & np.asarray(exact.valid)
    # identical winner selection away from borders (subpixel parabola may
    # differ by float noise)
    inner = np.zeros_like(both)
    inner[10:-10, 10:-10] = True
    m = both & inner
    assert m.mean() > 0.5
    assert np.abs(fd - ed)[m].max() < 0.26


def test_candidate_stack_recovers_constant_offset():
    """End-to-end recovery through the fast path (the array pipeline's
    default refine configuration)."""
    rng = np.random.default_rng(13)
    h, w = 64, 80
    ref = _textured(rng, h, w)
    true_disp = np.full((h, w), 6.0, dtype=np.float32)
    baselines = np.asarray([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0]], dtype=np.float32)
    aux = _make_views(ref, true_disp, baselines)
    init = jnp.asarray(true_disp + 3.0)
    out = multiview_refine(
        jnp.asarray(ref), jnp.asarray(aux), baselines, init,
        radius=5, window=11, max_disparity=20.0,
    )
    inner = np.zeros((h, w), dtype=bool)
    inner[12:-12, 12:-12] = True
    err = np.abs(np.asarray(out.disparity) - true_disp)[inner & np.asarray(out.valid)]
    assert np.median(err) < 0.5


def test_refine_traces_under_outer_lax_map():
    """Regression: inside an outer jit/lax.map trace, constant-input jnp ops
    (the candidate offsets) become tracers; the static candidate-stack path
    must iterate host-side offsets (perf_array_stages.py batches frames this
    way)."""
    rng = np.random.default_rng(3)
    h, w = 32, 48
    ref = jnp.asarray(_textured(rng, h, w))
    baselines = np.asarray([[1.0, 0.0], [0.0, 1.0]], dtype=np.float32)
    aux = jnp.stack([ref, ref])
    disp = jnp.full((h, w), 2.0)

    def one(s):
        out = multiview_refine(
            ref + s, aux, baselines, disp, radius=3, window=7,
            max_disparity=8.0,
        )
        return jnp.sum(out.disparity)

    @jax.jit
    def prog():
        return jnp.sum(jax.lax.map(one, jnp.arange(2, dtype=jnp.float32)))

    assert np.isfinite(float(prog()))


def test_candidate_stack_validity_matches_exact_warp_at_zero_disparity():
    """Regression (r2 review): the stack path must mirror
    warp_with_disparity's `d > 0` evidence gate — zero/negative candidate
    disparities are not photoconsistency evidence — and must agree with the
    literal exact_warp objective on validity and output bit-for-bit for
    axis-aligned baselines, including an all-zero (sweep-invalid-fill)
    initial disparity."""
    rng = np.random.default_rng(17)
    h, w = 32, 40
    ref = _textured(rng, h, w)
    aux = jnp.asarray(np.stack([_textured(rng, h, w), _textured(rng, h, w)]))
    baselines = np.asarray([[1.0, 0.0], [0.0, 1.0]], dtype=np.float32)
    kwargs = dict(radius=2, step=1.0, window=5)
    for d0 in (0.0, 3.0):
        disp = jnp.full((h, w), d0, jnp.float32)
        stack = multiview_refine(
            jnp.asarray(ref), aux, baselines, disp, max_disparity=8.0, **kwargs
        )
        exact = multiview_refine(
            jnp.asarray(ref), aux, jnp.asarray(baselines), disp,
            exact_warp=True, **kwargs,
        )
        np.testing.assert_array_equal(
            np.asarray(stack.valid), np.asarray(exact.valid)
        )
        np.testing.assert_allclose(
            np.asarray(stack.disparity), np.asarray(exact.disparity), atol=1e-5
        )


def test_candidate_stack_zero_baseline_row():
    """Regression (r2 review): a zero baseline row (source camera at the
    reference center — array_baselines emits a zero vector) must not crash
    the static path and must behave as an identity warp."""
    rng = np.random.default_rng(19)
    h, w = 32, 40
    ref = _textured(rng, h, w)
    aux = jnp.asarray(np.stack([ref, ref]))
    baselines = np.asarray([[1.0, 0.0], [0.0, 0.0]], dtype=np.float32)
    disp = jnp.full((h, w), 3.0, jnp.float32)
    out = multiview_refine(
        jnp.asarray(ref), aux, baselines, disp, radius=2, step=1.0, window=5,
        max_disparity=8.0,
    )
    assert np.isfinite(np.asarray(out.disparity)).all()
