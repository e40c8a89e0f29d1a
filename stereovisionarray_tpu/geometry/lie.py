"""SO(3) / SE(3) exponential and logarithm maps (Rodrigues), batched.

Used by bundle adjustment and pose-graph refinement (``models/sfm.py``) to
parameterize camera rotations with minimal 3-vectors — the capability the
reference lacks entirely (its poses are hard-coded constants,
``/root/reference/src/CameraStereoVision.cpp:33-39``).

All functions broadcast over leading batch dims and are differentiable
(Taylor-guarded near theta = 0 so gradients are finite).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST

_EPS = 1e-8


def _hat(w: jnp.ndarray) -> jnp.ndarray:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrices."""
    zeros = jnp.zeros_like(w[..., 0])
    return jnp.stack(
        [
            jnp.stack([zeros, -w[..., 2], w[..., 1]], axis=-1),
            jnp.stack([w[..., 2], zeros, -w[..., 0]], axis=-1),
            jnp.stack([-w[..., 1], w[..., 0], zeros], axis=-1),
        ],
        axis=-2,
    )


# Taylor-switch angle for series that suffer float32 cancellation in their
# closed forms (e.g. (1 - sin/x terms)): below 0.1 rad the 2-3 term series
# is accurate to ~1e-9 while the closed form has lost most of its digits.
_SMALL_ANGLE = 0.1


def _sinc(theta, theta2, theta2_safe):
    """sin(t)/t, exact limit 1 at t=0. No cancellation anywhere."""
    return jnp.where(
        theta2 < _EPS, 1.0 - theta2 / 6.0, jnp.sin(theta) / jnp.sqrt(theta2_safe)
    )


def _one_minus_cos_over_t2(theta):
    """(1 - cos t)/t^2 via the half-angle identity 0.5*(sin(t/2)/(t/2))^2 —
    cancellation-free for ALL t (the naive form loses every float32 digit
    for t in [1e-4, 1e-2], which used to NaN se3_log downstream)."""
    half = 0.5 * theta
    half_safe = jnp.maximum(half, _EPS)
    s = jnp.where(half < _EPS, 1.0 - half * half / 6.0, jnp.sin(half_safe) / half_safe)
    return 0.5 * s * s


def so3_exp(w: jnp.ndarray) -> jnp.ndarray:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3)."""
    theta2 = jnp.sum(w * w, axis=-1)
    # `where`-guarded divisions must never see a zero denominator, or the
    # non-selected branch poisons gradients with 0 * inf = NaN.
    theta2_safe = jnp.maximum(theta2, _EPS * _EPS)
    theta = jnp.sqrt(theta2_safe)
    a = _sinc(theta, theta2, theta2_safe)
    b = _one_minus_cos_over_t2(theta)
    W = _hat(w)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * jnp.matmul(
        W, W, precision=_HI)


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrices (..., 3, 3) -> axis-angle (..., 3)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = jnp.clip((trace - 1.0) / 2.0, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = jnp.arccos(cos_theta)
    # vee of the antisymmetric part
    v = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    small = theta < 1e-4
    sin_safe = jnp.where(small, 1.0, jnp.sin(theta))
    scale = jnp.where(small, 0.5 + theta * theta / 12.0, theta / (2.0 * sin_safe))
    return scale[..., None] * v


def se3_exp(xi: jnp.ndarray):
    """Twist (..., 6) = (w, v) -> (R (...,3,3), t (...,3))."""
    w, v = xi[..., :3], xi[..., 3:]
    theta2 = jnp.sum(w * w, axis=-1)
    theta2_safe = jnp.maximum(theta2, _EPS * _EPS)
    theta = jnp.sqrt(theta2_safe)
    a = _sinc(theta, theta2, theta2_safe)
    b = _one_minus_cos_over_t2(theta)
    # (1 - sin t / t)/t^2: closed form cancels below ~0.1 rad in f32
    c = jnp.where(
        theta < _SMALL_ANGLE,
        1.0 / 6.0 - theta2 / 120.0 + theta2 * theta2 / 5040.0,
        (1.0 - a) / theta2_safe,
    )
    W = _hat(w)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), W.shape)
    WW = jnp.matmul(W, W, precision=_HI)
    R = eye + a[..., None, None] * W + b[..., None, None] * WW
    V = eye + b[..., None, None] * W + c[..., None, None] * WW
    t = jnp.einsum("...ij,...j->...i", V, v, precision=_HI)
    return R, t


def se3_log(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """(R, t) -> twist (..., 6) = (w, v)."""
    w = so3_log(R)
    theta2 = jnp.sum(w * w, axis=-1)
    theta2_safe = jnp.maximum(theta2, _EPS * _EPS)
    theta = jnp.sqrt(theta2_safe)
    W = _hat(w)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    # V^{-1} = I - W/2 + (1/theta^2)(1 - a/(2b)) W^2.
    # 1 - a/(2b) ~ theta^2/12: total cancellation in f32 below ~0.1 rad —
    # the series branch is mandatory there, and b must come from the
    # half-angle form or it is exactly 0 (0/0 -> NaN) near 1e-3 rad.
    a = _sinc(theta, theta2, theta2_safe)
    b = _one_minus_cos_over_t2(theta)
    coef = jnp.where(
        theta < _SMALL_ANGLE,
        1.0 / 12.0 + theta2 / 720.0 + theta2 * theta2 / 30240.0,
        (1.0 - a / (2.0 * jnp.maximum(b, _EPS))) / theta2_safe,
    )
    V_inv = eye - 0.5 * W + coef[..., None, None] * jnp.matmul(
        W, W, precision=_HI)
    v = jnp.einsum("...ij,...j->...i", V_inv, t, precision=_HI)
    return jnp.concatenate([w, v], axis=-1)
