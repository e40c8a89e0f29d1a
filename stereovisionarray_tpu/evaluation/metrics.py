"""Evaluation harness — the test-pyramid version of the reference's manual
eyeballing.

Reference equivalents: ground truth loaded from ``idealRef.yml`` and shown as
a x50 error image (``/root/reference/src/functions.cpp:323-329``,
``/root/reference/src/CameraStereoVision.cpp:107-111``) plus a masked mean
(``calculateAverageError``, ``/root/reference/src/functions.cpp:348-354``).
Here: Middlebury-standard bad-τ ratios, end-point error, masked means, and
ATE for calibrated poses — all jittable and mask-aware.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

# float32 matmuls pinned to full precision: a GPU may otherwise run them in
# TF32 (about 3 decimal digits)
_HI = jax.lax.Precision.HIGHEST


def _masked(values: jnp.ndarray, mask: Optional[jnp.ndarray]) -> tuple[jnp.ndarray, jnp.ndarray]:
    if mask is None:
        return values, jnp.ones_like(values, dtype=jnp.float32)
    # broadcast the mask up-front: a (1, W) mask against (H, W) values must
    # count every row in the denominator, not silently shrink it
    m = jnp.broadcast_to(mask, jnp.broadcast_shapes(values.shape, mask.shape)).astype(jnp.float32)
    return values * m, m


def bad_pixel_ratio(
    disparity: jnp.ndarray,
    gt: jnp.ndarray,
    tau: float = 2.0,
    mask: Optional[jnp.ndarray] = None,
    invalid_counts_bad: bool = True,
) -> jnp.ndarray:
    """Middlebury bad-τ: fraction of (masked) pixels with |d - d_gt| > τ.
    Invalid predictions (d < 0) count as bad when invalid_counts_bad."""
    err = jnp.abs(disparity - gt)
    bad = err > tau
    if invalid_counts_bad:
        bad = bad | (disparity < 0)
    badf, m = _masked(bad.astype(jnp.float32), mask)
    return jnp.sum(badf) / jnp.maximum(jnp.sum(m), 1.0)


def end_point_error(
    disparity: jnp.ndarray, gt: jnp.ndarray, mask: Optional[jnp.ndarray] = None
) -> jnp.ndarray:
    """Mean |d - d_gt| over valid predictions within the mask."""
    valid = disparity >= 0
    m = valid if mask is None else (valid & mask)
    err, mf = _masked(jnp.abs(disparity - gt), m)
    return jnp.sum(err) / jnp.maximum(jnp.sum(mf), 1.0)


def masked_mean_error(
    depth: jnp.ndarray, gt: jnp.ndarray, mask: Optional[jnp.ndarray] = None
) -> jnp.ndarray:
    """The reference's ``calculateAverageError``: mean signed error within the
    ROI (``/root/reference/src/functions.cpp:348-354``)."""
    err, m = _masked(depth - gt, mask)
    return jnp.sum(err) / jnp.maximum(jnp.sum(m), 1.0)


def depth_error_map(depth: jnp.ndarray, gt: jnp.ndarray, scale: float = 50.0) -> jnp.ndarray:
    """The x50 visual error image the reference displays
    (``/root/reference/src/CameraStereoVision.cpp:110``) — returned as an
    array for PNG export instead of an imshow window."""
    return (depth - gt) * scale


def absolute_trajectory_error(
    centers_est: jnp.ndarray,
    centers_gt: jnp.ndarray,
    align: bool = True,
    align_scale: bool = False,
) -> jnp.ndarray:
    """ATE (RMSE of camera centers) after optional similarity alignment
    (Umeyama) — pose accuracy metric for calibration/BA.

    align_scale additionally removes the global-scale gauge (monocular BA
    cannot observe scale; compare up to Sim(3) in that setting)."""
    if align:
        mu_e = centers_est.mean(axis=0)
        mu_g = centers_gt.mean(axis=0)
        e = centers_est - mu_e
        g = centers_gt - mu_g
        cov = jnp.matmul(e.T, g, precision=_HI)
        u, s, vt = jnp.linalg.svd(cov)
        d = jnp.sign(jnp.linalg.det(jnp.matmul(vt.T, u.T, precision=_HI)))
        D = jnp.diag(jnp.array([1.0, 1.0, d]))
        R = jnp.linalg.multi_dot([vt.T, D, u.T], precision=_HI)
        if align_scale:
            var_e = jnp.sum(e * e)
            scale = jnp.sum(s * jnp.diag(D)) / jnp.maximum(var_e, 1e-12)
        else:
            scale = 1.0
        aligned = scale * jnp.matmul(R, e.T, precision=_HI).T + mu_g
    else:
        aligned = centers_est
    return jnp.sqrt(jnp.mean(jnp.sum((aligned - centers_gt) ** 2, axis=-1)))
