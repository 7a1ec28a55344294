"""Multi-process launch: extend the single-host mesh across processes.

The reference has no distributed runtime at all (SURVEY §2.15: its only
parallelism is `Array.Parallel` threads). Here the same renderer code runs
multi-process because everything is expressed over a `jax.sharding.Mesh`:
initialize the distributed runtime once per process with an explicit
coordinator, then build the mesh over *all* devices — the `shard_map`
collectives (framebuffer psum, gradient pmean in `opt.inverse`) need no
further code changes.

    python -c "
    from mafrixraytracing_tpu.parallel import launch
    launch.init('localhost:12345', num_processes=2, process_id=0)
    mesh = launch.global_mesh()
    ...render_image_sharded(scene, camera, mesh, ...)"

The coordinator can also come from the standard JAX_COORDINATOR_ADDRESS /
JAX_NUM_PROCESSES / JAX_PROCESS_ID environment variables; with none given,
`init()` is a single-process no-op.
"""
from __future__ import annotations

import os

import jax

from mafrixraytracing_tpu.parallel.mesh import make_mesh

_initialized = False


def init(coordinator_address: str | None = None,
         num_processes: int | None = None,
         process_id: int | None = None) -> bool:
    """Initialize `jax.distributed` for a multi-process run. Returns True
    if the distributed runtime was initialized, False when running
    single-process (no coordination configured — the common dev case).
    Idempotent."""
    global _initialized
    if _initialized:
        return True
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    env_np = os.environ.get("JAX_NUM_PROCESSES")
    num_processes = num_processes if num_processes is not None else (
        int(env_np) if env_np else None
    )
    env_pid = os.environ.get("JAX_PROCESS_ID")
    process_id = process_id if process_id is not None else (
        int(env_pid) if env_pid else None
    )
    if coordinator_address is None:
        return False  # single-process
    kwargs = dict(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    jax.distributed.initialize(**kwargs)
    _initialized = True
    return True


def global_mesh():
    """1-D ray-parallel mesh over every device of every process (after
    `init()`, `jax.devices()` is global)."""
    return make_mesh()


def process_info() -> dict:
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }
