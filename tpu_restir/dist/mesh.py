"""Device mesh setup for tile-sharded rendering.

The renderer's data parallelism (SURVEY.md §2.2 P6 / §5.8): pixel rows
shard over a 1-D mesh; scene/BVH/light tables replicate in device
memory. This replaces the reference's OpenMP scanline loops.

Multi-host: `init_distributed()` brings up jax.distributed (one process
per host: every process runs the same program and `jax.devices()` shows
the global device set). The 1-D row mesh then spans all hosts; halo
ppermutes between row-neighbors and the gradient psum are XLA
collectives (NCCL on GPUs, over NVLink within a host). Failure
recovery is restart-from-checkpoint (SURVEY.md §5.3/§5.4): all renderer
state is an array pytree (io/checkpoint.py), so a respawned job resumes
the accumulation.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

_initialized = False


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Initialize jax.distributed for multi-host meshes.

    No-ops when already initialized or when running single-process with
    no coordinator configured (the common single-host case). Arguments
    default to the standard JAX cluster-environment auto-detection
    (e.g. Slurm); without a detected cluster pass all three."""
    global _initialized
    if _initialized:
        return
    import os

    has_env = (coordinator_address is not None
               or os.environ.get("JAX_COORDINATOR_ADDRESS")
               or os.environ.get("COORDINATOR_ADDRESS"))
    if not has_env and num_processes in (None, 1):
        return  # single-process
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    _initialized = True


def make_mesh(n_devices: int | None = None, axis: str = "tiles") -> Mesh:
    """1-D row mesh over the first n (global) devices. In multi-host runs
    jax.devices() is the global list, so the mesh spans hosts; each
    process addresses only its local shard of any row-sharded array."""
    devs = jax.devices()
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    return Mesh(np.array(devs[:n]), (axis,))
