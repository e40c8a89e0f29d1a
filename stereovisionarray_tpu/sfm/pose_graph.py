"""Pose-graph optimization over relative-pose constraints.

Given measured relative poses Z_ij between camera pairs (e.g. from pairwise
calibration or BA of subsets — the array topologies of
``/root/reference/src/functions.cpp:148-213`` define which edges exist),
refine absolute poses X_i minimizing

    sum_ij || log( Z_ij^{-1} · X_i^{-1} · X_j ) ||²_Σ

Gauss-Newton with numeric-free analytic structure is overkill here (the
problem is tiny: N <= dozens of cameras, E <= hundreds of edges), so the
simple choice is plain GN with jax.grad/jacfwd-free *autodiff residual
stacking*: residuals are a fixed (E, 6) tensor, the update solves one dense
(6N x 6N) normal system via Cholesky — tiny and fully
jittable. Camera 0 is gauge-fixed.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from stereovisionarray_tpu.geometry.lie import se3_log, so3_exp

_HI = jax.lax.Precision.HIGHEST


class PoseGraph(NamedTuple):
    """Edges i -> j with measured relative pose x_j = (R_ij, t_ij) ∘ x_i,
    i.e. Z_ij maps camera-i coordinates to camera-j coordinates."""

    edge_i: jnp.ndarray  # (E,) int32
    edge_j: jnp.ndarray  # (E,) int32
    R_meas: jnp.ndarray  # (E, 3, 3)
    t_meas: jnp.ndarray  # (E, 3)
    weight: jnp.ndarray  # (E,) edge confidence (0 disables an edge)


def _edge_residuals(R, t, graph: PoseGraph) -> jnp.ndarray:
    """(E, 6) se(3) residuals log(Z_ij⁻¹ · T_j · T_i⁻¹) where T are
    world-to-camera transforms (x_cam = R x + t)."""
    Ri, ti = R[graph.edge_i], t[graph.edge_i]
    Rj, tj = R[graph.edge_j], t[graph.edge_j]
    # relative: x_j = R_rel x_i + t_rel with R_rel = Rj Ri^T
    R_rel = jnp.einsum("eik,ejk->eij", Rj, Ri, precision=_HI)
    t_rel = tj - jnp.einsum("eij,ej->ei", R_rel, ti, precision=_HI)
    # error transform: Z⁻¹ ∘ rel
    R_err = jnp.einsum("eki,ekj->eij", graph.R_meas, R_rel, precision=_HI)
    t_err = jnp.einsum("eki,ek->ei", graph.R_meas, t_rel - graph.t_meas, precision=_HI)
    return se3_log(R_err, t_err)


@functools.partial(jax.jit, static_argnames=("iterations",))
def pose_graph_optimize(
    R: jnp.ndarray,
    t: jnp.ndarray,
    graph: PoseGraph,
    iterations: int = 10,
    damping: float = 1e-4,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Refine world-to-camera poses (N,3,3), (N,3) against the edge set.

    Returns (R, t, per-iteration mean residual norm). Levenberg-Marquardt:
    the (E, 6) residual of the *perturbed* poses (left-multiplied se(3)
    deltas) is differentiated with jacfwd — exact Jacobians for a tiny
    state, one dense solve per iteration — and each step is ACCEPTED only
    if it reduces the cost and stays finite (pure GN can diverge to
    inf/NaN from a noisy init when H is near-singular; rejected steps
    raise the damping 10x, accepted ones lower it 0.3x — branch-free via
    `where` so the whole loop stays one `lax.scan`).
    """
    n = R.shape[0]

    def residuals_at(R_c, t_c):
        res = _edge_residuals(R_c, t_c, graph)
        return res * graph.weight[:, None]

    def mean_norm(res):
        return jnp.mean(jnp.linalg.norm(res, axis=-1))

    def lm_step(carry, _):
        R_c, t_c, lam = carry

        def perturbed_residuals(delta):  # delta: (N, 6)
            dR = so3_exp(delta[:, :3])
            R_p = jnp.einsum("nij,njk->nik", dR, R_c, precision=_HI)
            t_p = jnp.einsum("nij,nj->ni", dR, t_c, precision=_HI) + delta[:, 3:]
            return residuals_at(R_p, t_p)

        zero = jnp.zeros((n, 6), dtype=R.dtype)
        res0 = perturbed_residuals(zero)  # (E, 6)
        cost0 = mean_norm(res0)
        J = jax.jacfwd(perturbed_residuals)(zero)  # (E, 6, N, 6)
        Jf = J.reshape(-1, n * 6)
        rf = res0.reshape(-1)
        JtJ = jnp.matmul(Jf.T, Jf, precision=_HI)
        # LM damping scaled to the Hessian diagonal (scale-invariant)
        diag = jnp.diag(JtJ)
        H = JtJ + lam * jnp.diag(jnp.maximum(diag, 1e-12)) + 1e-9 * jnp.eye(
            n * 6, dtype=R.dtype
        )
        g = jnp.matmul(Jf.T, rf, precision=_HI)
        # gauge: freeze camera 0 by pinning its block to identity
        mask = jnp.arange(n * 6) < 6
        H = jnp.where(mask[:, None] | mask[None, :], 0.0, H)
        H = H + jnp.diag(mask.astype(R.dtype))
        g = jnp.where(mask, 0.0, g)
        delta = -jnp.linalg.solve(H, g).reshape(n, 6)

        dR = so3_exp(delta[:, :3])
        R_try = jnp.einsum("nij,njk->nik", dR, R_c, precision=_HI)
        t_try = jnp.einsum("nij,nj->ni", dR, t_c, precision=_HI) + delta[:, 3:]
        cost_try = mean_norm(residuals_at(R_try, t_try))

        accept = jnp.isfinite(cost_try) & (cost_try < cost0)
        R_new = jnp.where(accept, R_try, R_c)
        t_new = jnp.where(accept, t_try, t_c)
        lam_new = jnp.clip(jnp.where(accept, lam * 0.3, lam * 10.0), 1e-9, 1e6)
        return (R_new, t_new, lam_new), cost0

    lam0 = jnp.asarray(damping, dtype=R.dtype)
    (R_f, t_f, _), costs = jax.lax.scan(lm_step, (R, t, lam0), None, length=iterations)
    return R_f, t_f, costs
