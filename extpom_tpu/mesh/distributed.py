"""Multi-process (multi-host) execution support.

The reference is fundamentally a multi-process program: ``initialize_mpi``
assigns ranks (parallel_mpi.f:6-20), ``distribute_mpi`` fixes the 2-D rank
grid and per-rank tile geometry (parallel_mpi.f:34-122), and every I/O call
is a collective with per-rank hyperslabs (io_pnetcdf.F:272-275).  The JAX
equivalents:

* :func:`init_distributed` — ``jax.distributed.initialize`` (MPI_Init
  analogue); each process then sees the GLOBAL device set and builds the
  same mesh.
* :func:`make_global` — build a globally-sharded ``jax.Array`` from
  host-replicated numpy data: each process materializes only its
  addressable shards (the distribute_mpi tile-ownership analogue; no
  host ever holds a remote shard).
* :func:`process_barrier` — sync point for ordered multi-host I/O.

On CPU (tests) the backend uses gloo collectives; on GPU hosts the same
calls ride NCCL over NVLink and the network.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Initialize the JAX distributed runtime (initialize_mpi analogue,
    parallel_mpi.f:6-20).  Arguments default to the standard environment
    variables (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID); a no-op when already initialized or single-process.
    """
    coordinator_address = (coordinator_address
                           or os.environ.get("JAX_COORDINATOR_ADDRESS"))
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("JAX_PROCESS_ID", "0"))
    if num_processes <= 1 or coordinator_address is None:
        return
    # NB: probing jax.process_count() here would itself initialize the XLA
    # backend; use the distributed client state instead
    from jax._src import distributed as _dist
    if getattr(_dist.global_state, "client", None) is not None:
        return                           # already initialized
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def make_global(arr: np.ndarray, mesh: Mesh, spec: P) -> jax.Array:
    """Globally-sharded array from host-replicated data.

    Every process calls this with the SAME numpy array (grid/IC generation
    is deterministic and replicated, like the reference's rank-replicated
    namelist read); each materializes only its addressable shards."""
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(arr.shape, sharding,
                                        lambda idx: np.asarray(arr[idx]))


def process_barrier(name: str = "extpom") -> None:
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices(name)
