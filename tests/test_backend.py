"""Environment plumbing: SGM backend resolution, the compilation-cache
directory, the camera pytree without flax, import without flax/orbax, and
the full-precision homography grid."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stereovisionarray_tpu.backend import resolve_backend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize(
    "backend,platform,want",
    [
        ("auto", "cpu", "xla"),
        ("auto", "gpu", "pallas"),
        ("xla", "gpu", "xla"),
        ("xla", "cpu", "xla"),
        ("pallas", "gpu", "pallas"),
        ("pallas_interpret", "cpu", "pallas_interpret"),
    ],
)
def test_resolve_backend(backend, platform, want):
    assert resolve_backend(backend, platform) == want


def test_resolve_backend_default_platform_is_cpu_here():
    assert resolve_backend("auto") == "xla"


@pytest.mark.parametrize(
    "backend,platform,match",
    [
        ("auto", "rocm", "no SGM backend"),  # no rule for another platform
        ("pallas", "cpu", "compiles for a GPU"),  # never interprets silently
        ("triton", "gpu", "unknown backend"),
    ],
)
def test_resolve_backend_rejects(backend, platform, match):
    with pytest.raises(ValueError, match=match):
        resolve_backend(backend, platform)


def _cache_dir_in_child(env_value):
    """enable_compile_cache() in a fresh interpreter -> (returned dir, the
    dir jax is configured with)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    code = (
        "import jax\n"
        "from stereovisionarray_tpu.compile_cache import enable_compile_cache\n"
        "print(enable_compile_cache()); print(jax.config.jax_compilation_cache_dir)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    return out.split()


def test_compile_cache_defaults_to_checkout(tmp_path):
    returned, configured = _cache_dir_in_child(None)
    want = os.path.join(REPO, ".jax_cache")
    assert returned == configured == want


def test_compile_cache_env_var_wins(tmp_path):
    d = str(tmp_path / "cc")
    returned, configured = _cache_dir_in_child(d)
    assert returned == configured == d  # jax's own setting, untouched


def test_cli_and_models_import_without_flax_and_orbax():
    """The main path must not need packages the GPU host may lack."""
    code = (
        "import sys\n"
        "sys.modules['flax'] = None\n"
        "sys.modules['orbax'] = None\n"
        "sys.modules['orbax.checkpoint'] = None\n"
        "import stereovisionarray_tpu.cli, stereovisionarray_tpu.models\n"
        "import stereovisionarray_tpu.utils, stereovisionarray_tpu.parallel\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)


def test_camera_array_is_a_pytree():
    from stereovisionarray_tpu.datasets import reference_rig

    cams = reference_rig(rows=2, cols=2, resolution=(16, 20))
    leaves, tree = jax.tree_util.tree_flatten(cams)
    assert len(leaves) == 6
    back = jax.tree_util.tree_unflatten(tree, leaves)
    np.testing.assert_array_equal(np.asarray(back.t), np.asarray(cams.t))
    doubled = jax.jit(lambda c: jax.tree_util.tree_map(lambda x: 2 * x, c))(cams)
    np.testing.assert_allclose(np.asarray(doubled.fx), 2 * np.asarray(cams.fx))
    with pytest.raises(Exception):
        cams.fx = cams.fy  # frozen, as the flax struct was


def test_homography_grid_matches_float64():
    """ops/warp.py's sampling grid (H @ [u, v, 1]) at a general-rig
    homography stays within 1e-4 px of a float64 grid."""
    from stereovisionarray_tpu.ops.warp import homography_warp

    h, w = 270, 360
    Hm = np.array([[0.98, 0.05, 12.3], [-0.04, 1.01, -7.9], [2e-5, -3e-5, 1.0]])
    # an image whose value IS its column: the bilinear sample returns the
    # sampled x coordinate wherever it lands inside the image
    img = np.broadcast_to(np.arange(w, dtype=np.float32)[None, :], (h, w))
    got, ok = homography_warp(jnp.asarray(img), jnp.asarray(Hm, jnp.float32))
    v, u = np.mgrid[0:h, 0:w].astype(np.float64)
    H32 = Hm.astype(np.float32).astype(np.float64)
    src = np.einsum("ij,jhw->ihw", H32, np.stack([u, v, np.ones_like(u)]))
    x64 = src[0] / src[2]
    inside = np.asarray(ok) & (x64 > 1) & (x64 < w - 2)
    err = np.abs(np.asarray(got, np.float64) - x64)[inside]
    assert inside.mean() > 0.8
    assert err.max() < 1e-4, err.max()
