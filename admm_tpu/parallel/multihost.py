"""Multi-host cluster initialization.

The reference's communication backend is a single-machine MATLAB worker
pool (gcp; admm.m:347-356).  One process drives every GPU of its host:
the distributed solvers' collectives become NCCL all-reduces over the
host's NVLink, which joins every card to every other at the same rate,
so a mesh is shaped by the algorithm alone (shards, or lanes x shards).
Past one host the equivalent is jax.distributed: every process calls
``initialize_cluster()`` before touching devices, after which
``jax.devices()`` spans all hosts and the distributed solvers in this
package (consensus, transpose reduction, sliced prox) work unchanged —
their meshes simply cover more devices.
"""

from __future__ import annotations

from typing import Optional

import jax


def initialize_cluster(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> int:
    """Initialize jax.distributed (a no-op for one process, which already
    sees every GPU of its host).  Returns the global device count.

    Nothing on a plain GPU host describes the cluster to JAX: pass the
    coordinator address (``host:port``), the process count and this
    process's id explicitly.
    """
    if num_processes is not None and num_processes > 1 or coordinator_address:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    return len(jax.devices())


def global_mesh(axis_name: str = "shards"):
    """A 1-D mesh over every device in the cluster (call after
    ``initialize_cluster``)."""
    from .mesh import make_mesh

    return make_mesh(axis_name=axis_name)
