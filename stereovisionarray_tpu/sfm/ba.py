"""Bundle adjustment: Levenberg-Marquardt with Schur-complement reduction,
solved matrix-free by preconditioned conjugate gradients.

Replaces the reference's hard-coded pose grid
(``/root/reference/src/CameraStereoVision.cpp:33-39``) with estimated poses.

Device-program structure (SURVEY.md §7 step 8, "hard parts"):
 - the sparse landmark-camera normal equations are never materialized —
   per-observation 2x6 / 2x3 Jacobian blocks are contracted on the fly
   (einsum batched over all M observations), camera/point blocks are built
   with ``segment_sum``;
 - the reduced camera system S δc = b is solved by CG where each
   matvec S x = (U + λ) x − W V⁻¹ Wᵀ x is two segment-sums and a batched
   3x3 solve — exactly the form that distributes over an observation-sharded
   mesh with one ``psum`` per matvec (``parallel/ba.py``, config 5);
 - fixed iteration counts everywhere (LM outer loop via ``lax.scan``, CG
   inner loop via ``lax.fori_loop``), accept/reject as a ``where``-select on
   the state pytree — no data-dependent control flow, one compiled program.

Robustness: IRLS with huber / cauchy / tukey kernels (tukey's cut scales
with the MAD of current inlier residuals); LM damping adapts x0.3 on accept
/ x5 on reject, so diverging or NaN candidate steps are discarded instead of
poisoning the state.

Gauge: camera 0 is frozen; the global scale is fixed by renormalizing the
camera-0 -> camera-1 baseline to its initial length after every accepted
update (scale is unobservable from reprojections alone).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from stereovisionarray_tpu.geometry.camera import CameraArray
from stereovisionarray_tpu.geometry.lie import _hat, so3_exp

_HI = jax.lax.Precision.HIGHEST


class BAProblem(NamedTuple):
    """Fixed-shape observation list (pad with valid=False)."""

    cam_idx: jnp.ndarray  # (M,) int32
    pt_idx: jnp.ndarray  # (M,) int32
    uv: jnp.ndarray  # (M, 2) float32 principal-point-centred measurements
    valid: jnp.ndarray  # (M,) bool


class BAState(NamedTuple):
    cameras: CameraArray
    points: jnp.ndarray  # (P, 3)
    cost: jnp.ndarray  # (iters + 1,) robust mean cost per iteration


# ---------------------------------------------------------------------- #
# Robust kernels
# ---------------------------------------------------------------------- #
def _robust_weight(norm: jnp.ndarray, c, kernel: str) -> jnp.ndarray:
    """IRLS weight ρ'(r)/r at scale c."""
    if kernel == "huber":
        return jnp.where(norm <= c, 1.0, c / jnp.maximum(norm, 1e-9))
    if kernel == "cauchy":
        return 1.0 / (1.0 + (norm / c) ** 2)
    if kernel == "tukey":
        u = jnp.clip(norm / c, 0.0, 1.0)
        return (1.0 - u * u) ** 2
    raise ValueError(f"unknown robust kernel {kernel!r}")


def _robust_rho(norm: jnp.ndarray, c, kernel: str) -> jnp.ndarray:
    """Robust loss ρ(||r||) at scale c (for LM step acceptance)."""
    if kernel == "huber":
        return jnp.where(norm <= c, 0.5 * norm * norm, c * (norm - 0.5 * c))
    if kernel == "cauchy":
        return 0.5 * c * c * jnp.log1p((norm / c) ** 2)
    if kernel == "tukey":
        u2 = jnp.clip((norm / c) ** 2, 0.0, 1.0)
        return (c * c / 6.0) * (1.0 - (1.0 - u2) ** 3)
    raise ValueError(f"unknown robust kernel {kernel!r}")


def _masked_median(x: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """Median over valid entries only (invalid slots sorted to the top and
    the median index computed from the true valid count)."""
    n = jnp.sum(valid.astype(jnp.int32))
    xs = jnp.sort(jnp.where(valid, x, jnp.inf))
    i = jnp.clip((n - 1) // 2, 0, x.shape[0] - 1)
    j = jnp.clip(n // 2, 0, x.shape[0] - 1)
    return 0.5 * (xs[i] + xs[j])


def _kernel_scale(
    norm: jnp.ndarray, valid: jnp.ndarray, scale: float, kernel: str,
    axis_name=None,
):
    """Kernel scale: fixed for huber/cauchy; MAD-adaptive (floored at
    ``scale``) for tukey, over valid residuals only. Under observation
    sharding (``axis_name``) the residuals are all-gathered first — the MAD
    must see the full distribution, and every shard must agree on c."""
    if kernel != "tukey":
        return jnp.asarray(scale, norm.dtype)
    if axis_name is not None:
        norm = jax.lax.all_gather(norm, axis_name, tiled=True)
        valid = jax.lax.all_gather(valid, axis_name, tiled=True)
    med = _masked_median(norm, valid)
    mad = _masked_median(jnp.abs(norm - med), valid)
    c = 4.685 * 1.4826 * mad
    c = jnp.where(jnp.isfinite(c), c, jnp.asarray(scale, norm.dtype))
    return jnp.maximum(jnp.asarray(scale, norm.dtype), c)


# ---------------------------------------------------------------------- #
# Residuals / Jacobians
# ---------------------------------------------------------------------- #
def _forward_residuals(R, t, X, fx, fy, problem: BAProblem):
    """Residuals r (M,2), norms (M,), geometric validity (M,) bool."""
    ci, pi = problem.cam_idx, problem.pt_idx
    x_cam = jnp.einsum("mij,mj->mi", R[ci], X[pi], precision=_HI) + t[ci]
    z = x_cam[..., 2]
    z_safe = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    inv_z = 1.0 / z_safe
    u = fx[ci] * x_cam[..., 0] * inv_z
    v = fy[ci] * x_cam[..., 1] * inv_z
    r = jnp.stack([u, v], axis=-1) - problem.uv
    norm = jnp.linalg.norm(r, axis=-1)
    geom_ok = problem.valid & (z > 1e-4)
    return r, norm, geom_ok, x_cam, inv_z


def _blocks(R, fx, fy, x_cam, inv_z, problem: BAProblem):
    """Jacobian blocks Jc (M,2,6), Jp (M,2,3) at the current state."""
    ci = problem.cam_idx
    fxm, fym = fx[ci], fy[ci]
    zero = jnp.zeros_like(inv_z)
    J_proj = jnp.stack(
        [
            jnp.stack([fxm * inv_z, zero, -fxm * x_cam[..., 0] * inv_z * inv_z], -1),
            jnp.stack([zero, fym * inv_z, -fym * x_cam[..., 1] * inv_z * inv_z], -1),
        ],
        axis=-2,
    )
    # left perturbation: dx_cam/dω = -[x_cam]x, dx_cam/dv = I, dx_cam/dX = R
    J_cam = jnp.concatenate(
        [-jnp.einsum("mij,mjk->mik", J_proj, _hat(x_cam), precision=_HI), J_proj],
        axis=-1,
    )
    J_pt = jnp.einsum("mij,mjk->mik", J_proj, R[ci], precision=_HI)
    return J_cam, J_pt


# ---------------------------------------------------------------------- #
# One LM solve at damping lam
# ---------------------------------------------------------------------- #
def _lm_step(
    R, t, X, fx, fy, problem, n_cams, n_pts, lam, c, kernel, cg_iters,
    axis_name=None,
):
    """Solve the damped normal equations; returns (dc (Nc,6), dp (P,3)).

    With ``axis_name`` set (inside shard_map over an observation-sharded
    mesh), every segment-sum reduction is completed by a ``psum`` — the
    distributed Schur reduction of BASELINE.json config 5. Cameras, points,
    and the CG state stay replicated; only observations are sharded."""
    r, norm, geom_ok, x_cam, inv_z = _forward_residuals(R, t, X, fx, fy, problem)
    Jc, Jp = _blocks(R, fx, fy, x_cam, inv_z, problem)
    w = _robust_weight(norm, c, kernel) * geom_ok.astype(r.dtype)
    ci, pi = problem.cam_idx, problem.pt_idx

    def allreduce(x):
        return x if axis_name is None else jax.lax.psum(x, axis_name)

    wJc = Jc * w[:, None, None]
    wJp = Jp * w[:, None, None]
    U = allreduce(jax.ops.segment_sum(
        jnp.einsum("mri,mrj->mij", Jc, wJc, precision=_HI), ci, num_segments=n_cams
    ))
    V = allreduce(jax.ops.segment_sum(
        jnp.einsum("mri,mrj->mij", Jp, wJp, precision=_HI), pi, num_segments=n_pts
    ))
    W_m = jnp.einsum("mri,mrj->mij", wJc, Jp, precision=_HI)  # (M_local, 6, 3)
    b_c = -allreduce(jax.ops.segment_sum(
        jnp.einsum("mri,mr->mi", wJc, r, precision=_HI), ci, num_segments=n_cams
    ))
    b_p = -allreduce(jax.ops.segment_sum(
        jnp.einsum("mri,mr->mi", wJp, r, precision=_HI), pi, num_segments=n_pts
    ))

    # LM damping: multiplicative on the diagonal (scale-invariant) + absolute
    eye6 = jnp.eye(6, dtype=R.dtype)[None]
    eye3 = jnp.eye(3, dtype=R.dtype)[None]
    U = U + lam * (U * eye6) + 1e-8 * eye6
    V = V + lam * (V * eye3) + 1e-8 * eye3
    V_inv = jnp.linalg.inv(V)

    fixed = jnp.arange(n_cams) == 0  # gauge camera

    def mask_c(x):
        return jnp.where(fixed[:, None], 0.0, x)

    b_red = mask_c(
        b_c
        - allreduce(jax.ops.segment_sum(
            jnp.einsum(
                "mij,mj->mi",
                W_m,
                jnp.einsum("pij,pj->pi", V_inv, b_p, precision=_HI)[pi],
                precision=_HI,
            ),
            ci,
            num_segments=n_cams,
        ))
    )

    def schur_matvec(x):
        x = mask_c(x)
        Ux = jnp.einsum("cij,cj->ci", U, x, precision=_HI)
        y = allreduce(jax.ops.segment_sum(
            jnp.einsum("mij,mi->mj", W_m, x[ci], precision=_HI), pi, num_segments=n_pts
        ))
        z2 = jnp.einsum("pij,pj->pi", V_inv, y, precision=_HI)
        EVWx = allreduce(jax.ops.segment_sum(
            jnp.einsum("mij,mj->mi", W_m, z2[pi], precision=_HI), ci, num_segments=n_cams
        ))
        return mask_c(Ux - EVWx)

    U_inv = jnp.linalg.inv(U)

    def precond(x):
        return mask_c(jnp.einsum("cij,cj->ci", U_inv, x, precision=_HI))

    x0 = jnp.zeros_like(b_red)
    z0 = precond(b_red)

    def cg_body(_, carry):
        x, rr, z, p = carry
        Ap = schur_matvec(p)
        rz = jnp.sum(rr * z)
        denom = jnp.sum(p * Ap)
        alpha = rz / jnp.where(jnp.abs(denom) < 1e-20, 1e-20, denom)
        x = x + alpha * p
        r_new = rr - alpha * Ap
        z_new = precond(r_new)
        beta = jnp.sum(r_new * z_new) / jnp.where(jnp.abs(rz) < 1e-20, 1e-20, rz)
        return x, r_new, z_new, z_new + beta * p

    dc, *_ = jax.lax.fori_loop(0, cg_iters, cg_body, (x0, b_red, z0, z0))

    Wt_dc = allreduce(jax.ops.segment_sum(
        jnp.einsum("mij,mi->mj", W_m, dc[ci], precision=_HI), pi, num_segments=n_pts
    ))
    dp = jnp.einsum("pij,pj->pi", V_inv, b_p - Wt_dc, precision=_HI)
    return dc, dp


def _apply_update(R, t, X, dc, dp, base_len, fix_scale):
    dR = so3_exp(dc[:, :3])
    R_new = jnp.einsum("cij,cjk->cik", dR, R, precision=_HI)
    t_new = jnp.einsum("cij,cj->ci", dR, t, precision=_HI) + dc[:, 3:]
    X_new = X + dp
    if fix_scale:
        C = -jnp.einsum("cji,cj->ci", R_new, t_new, precision=_HI)
        s = base_len / (jnp.linalg.norm(C[1] - C[0]) + 1e-12)
        C0 = C[0]
        C_scaled = C0 + s * (C - C0)
        X_new = C0 + s * (X_new - C0)
        t_new = -jnp.einsum("cij,cj->ci", R_new, C_scaled, precision=_HI)
    return R_new, t_new, X_new


def _mean_rho(R, t, X, fx, fy, problem, c, kernel, axis_name=None):
    _, norm, geom_ok, _, _ = _forward_residuals(R, t, X, fx, fy, problem)
    # behind-camera candidates carry the worst in-range loss (bounded kernels
    # must not reward pushing points out of view)
    rho = jnp.where(geom_ok, _robust_rho(norm, c, kernel), _robust_rho(1e6, c, kernel))
    wv = problem.valid.astype(norm.dtype)
    num = jnp.sum(rho * wv)
    den = jnp.sum(wv)
    if axis_name is not None:
        num = jax.lax.psum(num, axis_name)
        den = jax.lax.psum(den, axis_name)
    return num / jnp.maximum(den, 1.0)


# ---------------------------------------------------------------------- #
# Public driver
# ---------------------------------------------------------------------- #
@functools.partial(
    jax.jit,
    static_argnames=("iterations", "cg_iters", "fix_scale", "kernel", "axis_name"),
)
def bundle_adjust(
    cameras: CameraArray,
    points: jnp.ndarray,
    problem: BAProblem,
    iterations: int = 20,
    damping: float = 1e-3,
    huber: float = 2.0,
    cg_iters: int = 30,
    fix_scale: bool = True,
    kernel: str = "huber",
    axis_name: str = None,
) -> BAState:
    """Run ``iterations`` LM steps; returns refined cameras/points.

    ``problem.uv`` must be principal-point-centred pixel measurements
    (u - cx, v - cy) — intrinsics are known and fixed (array calibration
    refines extrinsics + structure, matching the reference's setting of a
    known camera model with unknown-but-rigid placement). ``damping`` is the
    initial LM λ; it adapts by x0.3 on accepted steps, x5 on rejected ones.
    """
    n_cams = len(cameras)
    n_pts = points.shape[0]
    R0, t0 = cameras.R, cameras.t
    fx, fy = cameras.fx, cameras.fy
    base_len = jnp.linalg.norm(cameras.centers[1] - cameras.centers[0]) + 1e-12

    def step(carry, _):
        R, t, X, lam = carry
        _, norm, geom_ok, _, _ = _forward_residuals(R, t, X, fx, fy, problem)
        c = _kernel_scale(norm, geom_ok, huber, kernel, axis_name)
        cost_cur = _mean_rho(R, t, X, fx, fy, problem, c, kernel, axis_name)

        dc, dp = _lm_step(
            R, t, X, fx, fy, problem, n_cams, n_pts, lam, c, kernel, cg_iters,
            axis_name,
        )
        R_new, t_new, X_new = _apply_update(R, t, X, dc, dp, base_len, fix_scale)
        cost_new = _mean_rho(R_new, t_new, X_new, fx, fy, problem, c, kernel, axis_name)

        accept = jnp.isfinite(cost_new) & (cost_new < cost_cur)

        def sel(a, b):
            return jnp.where(accept, a, b)

        R = sel(R_new, R)
        t = sel(t_new, t)
        X = sel(X_new, X)
        lam = jnp.where(
            accept, jnp.maximum(lam * 0.3, 1e-8), jnp.minimum(lam * 5.0, 1e4)
        )
        return (R, t, X, lam), cost_cur

    lam0 = jnp.asarray(damping, R0.dtype)
    (R_f, t_f, X_f, _), costs = jax.lax.scan(
        step, (R0, t0, points.astype(R0.dtype), lam0), None, length=iterations
    )
    _, norm_f, ok_f, _, _ = _forward_residuals(R_f, t_f, X_f, fx, fy, problem)
    c_f = _kernel_scale(norm_f, ok_f, huber, kernel, axis_name)
    final_cost = _mean_rho(R_f, t_f, X_f, fx, fy, problem, c_f, kernel, axis_name)
    cams_out = CameraArray(
        fx=cameras.fx, fy=cameras.fy, cx=cameras.cx, cy=cameras.cy, R=R_f, t=t_f
    )
    return BAState(
        cameras=cams_out, points=X_f, cost=jnp.concatenate([costs, final_cost[None]])
    )
