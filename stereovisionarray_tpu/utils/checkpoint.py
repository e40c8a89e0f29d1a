"""Checkpoint / resume via Orbax.

Replaces the reference's single-Mat YAML serialization
(``saveImage``/``loadImage``, ``/root/reference/src/functions.cpp:331-346``)
with a real checkpoint of arbitrary pipeline state pytrees — camera arrays,
landmark clouds, per-keyframe depth maps, BA state — plus the EngineConfig
that produced them. Orbax records sharding metadata, so a checkpoint written
from a sharded run restores onto a different mesh shape (the re-shardable
resume path of SURVEY.md §5 "failure detection / elastic recovery").

Orbax is imported inside the functions that use it, so the package (and
the CLI) import without it.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional, Tuple

import jax
import numpy as np

from stereovisionarray_tpu.config import EngineConfig

_CONFIG_FILE = "engine_config.json"


def save_checkpoint(
    path: str,
    state: Any,
    config: Optional[EngineConfig] = None,
    force: bool = True,
) -> None:
    """Write `state` (any pytree of arrays) and optionally the config.

    path: directory (created if needed; absolute path required by orbax)."""
    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(os.path.join(path, "state"), state, force=force)
    if config is not None:
        with open(os.path.join(path, _CONFIG_FILE), "w") as f:
            f.write(config.to_json())


def load_checkpoint(
    path: str, target: Any = None
) -> Tuple[Any, Optional[EngineConfig]]:
    """Restore (state, config). ``target`` (a pytree of like-shaped arrays
    or ShapeDtypeStructs, possibly with shardings) guides structure/placement;
    without it, arrays come back as numpy."""
    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    with ocp.StandardCheckpointer() as ckptr:
        if target is not None:
            state = ckptr.restore(os.path.join(path, "state"), target)
        else:
            state = ckptr.restore(os.path.join(path, "state"))
    cfg = None
    cfg_path = os.path.join(path, _CONFIG_FILE)
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            cfg = EngineConfig.from_json(f.read())
    return state, cfg
