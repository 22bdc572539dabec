"""Device-mesh helpers.

The reference is a single-GPU op library with zero multi-device code
(SURVEY.md §2: no NCCL/MPI, no tf.distribute).  Here all parallelism
(data / head-tensor / context / sequence) is expressed as named mesh axes
+ sharding specs, and XLA lowers the named collectives to NCCL.  The
cards of one host are joined all to all by NVLink, so a mesh's shape
follows the algorithm, not a physical topology.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["make_mesh", "AXIS_DATA", "AXIS_MODEL", "AXIS_CONTEXT"]

AXIS_DATA = "data"
AXIS_MODEL = "model"
AXIS_CONTEXT = "context"


def maybe_init_distributed() -> bool:
    """Initialise ``jax.distributed`` when running multi-host.

    Call once at program start on every host (before any device use);
    after it, ``jax.devices()`` spans all hosts and the same mesh/sharding
    code runs unchanged.  No-ops (returns False) when no coordinator is
    configured in ``COORDINATOR_ADDRESS``.
    """
    import os

    if jax.process_count() > 1:
        return True  # already initialised
    if os.environ.get("COORDINATOR_ADDRESS"):
        jax.distributed.initialize()
        return True
    return False


def make_mesh(
    shape: Optional[Sequence[int]] = None,
    axis_names: Tuple[str, ...] = (AXIS_DATA, AXIS_MODEL),
    devices=None,
) -> Mesh:
    """Build a mesh over the available devices.

    ``shape=None`` puts all devices on the first axis.  Axis sizes must
    multiply to the device count.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} devices")
    return Mesh(np.asarray(devices).reshape(shape), axis_names)
