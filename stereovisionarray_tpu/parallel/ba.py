"""Distributed bundle adjustment: observation-sharded Schur reduction over
the mesh — BASELINE.json config 5 ("distributed Schur-complement BA over pod
slice").

Partitioning: the observation list (the large axis — M grows with views x
features x keyframes) is sharded across every mesh device; cameras, points,
and the LM/CG state are replicated. All block assemblies and the two
segment-sums inside each CG matvec end in one ``psum`` (sfm/ba.py's
``allreduce`` hook), so each shard computes partial normal-equation blocks
from its own observations and XLA reduces them across devices. Every device runs
the identical replicated solve — results are bit-identical across shards,
and identical to the single-device ``bundle_adjust`` up to float reduction
order (tested in tests/test_parallel.py).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from stereovisionarray_tpu.geometry.camera import CameraArray
from stereovisionarray_tpu.sfm.ba import BAProblem, BAState, bundle_adjust

_OBS_AXIS = "obs"


def _pad_problem(problem: BAProblem, multiple: int) -> BAProblem:
    """Pad the observation list to a multiple of the shard count (padding
    slots get valid=False and index 0 — they contribute zero weight)."""
    m = problem.cam_idx.shape[0]
    m_pad = (-m) % multiple
    if m_pad == 0:
        return problem
    return BAProblem(
        cam_idx=jnp.pad(problem.cam_idx, (0, m_pad)),
        pt_idx=jnp.pad(problem.pt_idx, (0, m_pad)),
        uv=jnp.pad(problem.uv, ((0, m_pad), (0, 0))),
        valid=jnp.pad(problem.valid, (0, m_pad)),
    )


def distributed_bundle_adjust(
    cameras: CameraArray,
    points: jnp.ndarray,
    problem: BAProblem,
    mesh: Mesh,
    iterations: int = 20,
    damping: float = 1e-3,
    huber: float = 2.0,
    cg_iters: int = 30,
    fix_scale: bool = True,
    kernel: str = "huber",
) -> BAState:
    """``sfm.ba.bundle_adjust`` with observations sharded over ALL devices of
    ``mesh`` (the mesh's axes are collapsed into one logical ``obs`` axis —
    BA wants maximum observation parallelism, not the stereo pipeline's
    data/tile/disp split)."""
    n_dev = int(np.prod(list(mesh.shape.values())))
    flat_mesh = Mesh(mesh.devices.reshape(-1), (_OBS_AXIS,))
    problem = _pad_problem(problem, n_dev)

    obs_spec = BAProblem(
        cam_idx=P(_OBS_AXIS),
        pt_idx=P(_OBS_AXIS),
        uv=P(_OBS_AXIS, None),
        valid=P(_OBS_AXIS),
    )
    rep = jax.tree_util.tree_map(lambda _: P(), (cameras, points))

    def local(cams_l, pts_l, prob_l):
        return bundle_adjust(
            cams_l,
            pts_l,
            prob_l,
            iterations=iterations,
            damping=damping,
            huber=huber,
            cg_iters=cg_iters,
            fix_scale=fix_scale,
            kernel=kernel,
            axis_name=_OBS_AXIS,
        )

    out_spec = BAState(
        cameras=jax.tree_util.tree_map(lambda _: P(), cameras),
        points=P(),
        cost=P(),
    )
    sharded = jax.shard_map(
        local,
        mesh=flat_mesh,
        in_specs=(rep[0], rep[1], obs_spec),
        out_specs=out_spec,
        check_vma=False,
    )
    problem = jax.device_put(
        problem, jax.tree_util.tree_map(lambda s: NamedSharding(flat_mesh, s), obs_spec)
    )
    return sharded(cameras, points, problem)
