"""Device-mesh construction for the engine's three parallel axes.

Axis semantics (SURVEY.md §2.2):
  data — camera pairs / keyframes (embarrassingly parallel problems)
  tile — image rows (halo-coupled spatial tiles)
  disp — disparity candidates (cost-volume shard axis)

The cards of one GPU host are joined all to all by NVLink, so every
device pair is equally close and the mesh follows the algorithm alone:
devices fill the (data, tile, disp) grid in order. ``data`` is outermost,
so a multi-host run would put it across hosts, where only the final maps
cross the network.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

AXIS_DATA = "data"
AXIS_TILE = "tile"
AXIS_DISP = "disp"

AXES = (AXIS_DATA, AXIS_TILE, AXIS_DISP)


def make_mesh(
    data: int = 1,
    tile: int = 1,
    disp: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a ``(data, tile, disp)`` mesh over ``devices`` (default: all).

    The product must equal the device count. Axes of size 1 are kept in the
    mesh (so PartitionSpecs stay uniform) — XLA elides collectives over
    singleton axes.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if data * tile * disp != n:
        raise ValueError(
            f"mesh {data}x{tile}x{disp} = {data * tile * disp} != {n} devices"
        )
    dev_array = np.asarray(list(devices), dtype=object).reshape(data, tile, disp)
    return Mesh(dev_array, AXES)


def default_mesh_shape(n_devices: int) -> tuple[int, int, int]:
    """Factor ``n_devices`` into a (data, tile, disp) shape that exercises
    every axis when possible: prefer tile (best compute/communication ratio
    for stereo tiles), then data, then disp."""
    shape = {AXIS_DATA: 1, AXIS_TILE: 1, AXIS_DISP: 1}
    order = [AXIS_TILE, AXIS_DATA, AXIS_DISP, AXIS_TILE, AXIS_DATA, AXIS_TILE]
    remaining = n_devices
    i = 0
    while remaining > 1 and i < len(order):
        if remaining % 2 == 0:
            shape[order[i]] *= 2
            remaining //= 2
        else:
            # odd residue: fold the whole remainder into data
            shape[AXIS_DATA] *= remaining
            remaining = 1
        i += 1
    shape[AXIS_DATA] *= remaining if remaining > 1 else 1
    return (shape[AXIS_DATA], shape[AXIS_TILE], shape[AXIS_DISP])


def device_counts() -> dict:
    """Host/device topology snapshot (observability; SURVEY.md §5)."""
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_device_count": jax.local_device_count(),
        "global_device_count": jax.device_count(),
        "platform": jax.devices()[0].platform,
    }
