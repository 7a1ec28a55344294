"""Device-mesh helpers.

The reference's only parallelism is shared-memory threads over pixels
(`Array.Parallel.iter`, `Core/Integrator/Integrators.fs:164`). The
replacement is a 1-D `jax.sharding.Mesh` over all addressable devices with
the pixel-sample wavefront sharded along it ("ray parallelism" == data
parallelism for rendering); scene arrays are replicated. XLA lowers the
collectives to the devices' interconnect; `jax.distributed.initialize`
extends the same code to multiple processes (`parallel.launch`).
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

RAY_AXIS = "rays"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over `n_devices` (default: all addressable devices)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (RAY_AXIS,))


def ray_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (ray/pixel batch) axis."""
    return NamedSharding(mesh, P(RAY_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
