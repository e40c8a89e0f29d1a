"""Landmark-free subject detection: moment-based foreground ellipse.

The reference needs dlib's HOG face detector + a 100 MB landmark model just
to build a compute-gating mask (``/root/reference/src/dlibFaceSelect.cpp:19-25``)
— host-only, deserialized from disk on every call. For the *gating* role
(restrict depth estimation to the subject) a foreground blob estimate is
sufficient and runs as a handful of fused elementwise ops on device:

  smooth -> threshold at the Otsu point -> intensity-weighted centroid and
  second moments of the foreground -> ellipse with the reference's
  empirical axis scaling.

External landmark detectors remain pluggable through
``mask.face_mask_from_landmarks`` when true facial geometry is required.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp


class EllipseROI(NamedTuple):
    center: jnp.ndarray  # (2,) (u, v)
    axes: jnp.ndarray  # (2,) semi-axes
    angle: jnp.ndarray  # radians
    found: jnp.ndarray  # bool: enough foreground support


def _box(x: jnp.ndarray, k: int) -> jnp.ndarray:
    p = k // 2

    def along(a, axis):
        pad = [(0, 0)] * a.ndim
        pad[axis] = (p + 1, p)
        ap = jnp.pad(a, pad, mode="edge")
        c = jnp.cumsum(ap, axis=axis)
        hi = jax.lax.slice_in_dim(c, k, k + a.shape[axis], axis=axis)
        lo = jax.lax.slice_in_dim(c, 0, a.shape[axis], axis=axis)
        return (hi - lo) / k

    return along(along(x, -1), -2)


def _otsu_threshold(image: jnp.ndarray, bins: int = 64) -> jnp.ndarray:
    """Otsu's threshold via a fixed-bin histogram (jit-friendly: the
    between-class variance argmax over static bins)."""
    lo = jnp.min(image)
    hi = jnp.max(image)
    span = jnp.maximum(hi - lo, 1e-6)
    idx = jnp.clip(((image - lo) / span * bins).astype(jnp.int32), 0, bins - 1)
    hist = jnp.zeros((bins,), jnp.float32).at[idx.reshape(-1)].add(1.0)
    p = hist / jnp.maximum(jnp.sum(hist), 1.0)
    centers = lo + (jnp.arange(bins, dtype=jnp.float32) + 0.5) / bins * span
    w0 = jnp.cumsum(p)
    mu_t = jnp.sum(p * centers)
    mu0 = jnp.cumsum(p * centers)
    w1 = 1.0 - w0
    denom = jnp.maximum(w0 * w1, 1e-9)
    sigma_b = (mu_t * w0 - mu0) ** 2 / denom
    return centers[jnp.argmax(sigma_b)]


@functools.partial(jax.jit, static_argnames=("smooth", "height_scale", "invert"))
def detect_face_ellipse(
    image: jnp.ndarray,
    smooth: int = 9,
    height_scale: float = 1.7,
    min_fraction: float = 0.01,
    invert: bool = False,
) -> EllipseROI:
    """Detect the dominant foreground blob as an ellipse ROI.

    image: (H, W) grayscale. invert=True if the subject is darker than the
    background. height_scale mirrors the reference's 1.7x vertical stretch
    (``/root/reference/src/dlibFaceSelect.cpp:56-60``).
    """
    img = _box(image.astype(jnp.float32), smooth)
    img = -img if invert else img
    thr = _otsu_threshold(img)
    wgt = jnp.maximum(img - thr, 0.0)  # soft foreground weight

    h, w = img.shape
    v = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    u = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    total = jnp.sum(wgt)
    total_safe = jnp.maximum(total, 1e-6)
    cu = jnp.sum(wgt * u) / total_safe
    cv = jnp.sum(wgt * v) / total_safe
    duu = jnp.sum(wgt * (u - cu) ** 2) / total_safe
    dvv = jnp.sum(wgt * (v - cv) ** 2) / total_safe
    duv = jnp.sum(wgt * (u - cu) * (v - cv)) / total_safe

    # principal axes of the weight distribution
    tr = duu + dvv
    det = duu * dvv - duv * duv
    disc = jnp.sqrt(jnp.maximum(tr * tr / 4.0 - det, 0.0))
    lam1 = tr / 2.0 + disc  # major
    lam2 = tr / 2.0 - disc
    angle = 0.5 * jnp.arctan2(2.0 * duv, duu - dvv)
    # 2-sigma ellipse, vertically stretched like the reference's face oval
    a = 2.0 * jnp.sqrt(jnp.maximum(lam1, 1.0))
    b = 2.0 * jnp.sqrt(jnp.maximum(lam2, 1.0))
    axes = jnp.stack([a, b * (height_scale / 1.7)])

    found = total > min_fraction * h * w * jnp.maximum(jnp.max(wgt), 1e-6)
    return EllipseROI(
        center=jnp.stack([cu, cv]), axes=axes, angle=angle, found=found
    )
