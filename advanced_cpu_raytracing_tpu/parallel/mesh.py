"""Device-mesh helpers for multi-chip rendering.

The reference's only parallelism is 8 pthreads over row blocks
(src/main.cpp:15, 38-39).  The equivalent here: a 1-D device mesh with
pixels/tiles sharded on the ``tiles`` axis; the scene pack is replicated;
framebuffer and gradient reductions are XLA-inserted collectives.  The mesh
follows the algorithm alone: every GPU of a host reaches every other over
NVLink at the same rate, so no topology is assumed.
Multi-host launch goes through ``jax.distributed.initialize`` (initialize()
below) with the same mesh spanning all processes.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

TILE_AXIS = "tiles"


def make_device_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (TILE_AXIS,))


def tile_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(TILE_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def initialize_distributed(**kwargs) -> None:
    """Multi-host init (no-op when single-process)."""
    if jax.process_count() == 1 and not kwargs:
        return
    jax.distributed.initialize(**kwargs)
