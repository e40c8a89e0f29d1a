"""Multi-device sharding layer — the scale-out path the reference lacks.

The reference is one process, one thread (SURVEY.md §0: zero threading /
MPI / socket includes anywhere; its hot loop is a nested per-pixel ``for``
at ``/root/reference/src/CameraStereoVision.cpp:49-95``). Here scale-out is
expressed as a ``jax.sharding.Mesh`` with named axes

  - ``data``: independent stereo problems (camera pairs / keyframes) —
    pure data parallelism (SURVEY.md §2.2 P1);
  - ``tile``: image rows — spatial tile parallelism with ``ppermute`` halo
    exchange so SGM paths cross tile edges (P2);
  - ``disp``: the disparity axis of the H x W x D cost volume — the
    domain's sequence/context-parallel analogue, partial WTA minima
    combined with an all-gather min-reduce (P3).

XLA schedules all collectives (NCCL over NVLink between the cards of a GPU
host; P6) — there is no hand-written communication backend, by design.
"""

from stereovisionarray_tpu.parallel.mesh import (  # noqa: F401
    AXIS_DATA,
    AXIS_DISP,
    AXIS_TILE,
    make_mesh,
)
from stereovisionarray_tpu.parallel.ba import distributed_bundle_adjust  # noqa: F401
from stereovisionarray_tpu.parallel.halo import exchange_halo  # noqa: F401
from stereovisionarray_tpu.parallel.two_view import (  # noqa: F401
    sharded_two_view_disparity,
    sharded_wta,
)
from stereovisionarray_tpu.parallel.plane_sweep import (  # noqa: F401
    sharded_plane_sweep_depth,
)
from stereovisionarray_tpu.parallel.cascade_sweep import (  # noqa: F401
    sharded_cascade_sweep_depth,
)
from stereovisionarray_tpu.parallel.streaming import (  # noqa: F401
    DevicePipeline,
    StreamExecutor,
    throughput_stream,
)
from stereovisionarray_tpu.parallel.fusion import (  # noqa: F401
    sharded_fuse_depth_maps,
)
