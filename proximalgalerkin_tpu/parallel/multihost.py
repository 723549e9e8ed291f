"""Multi-host initialization — the `jax.distributed` wiring.

SURVEY.md §2.3: the reference scales across nodes with OpenMPI
(`mpirun`-launched ranks, PETSc ghost vectors over the interconnect); the
device-native equivalent is one JAX process per host, connected through
`jax.distributed.initialize`, after which `jax.devices()` spans every
host's chips and the same `shard_map`/`psum`/`ppermute` code of
parallel/dofpart.py runs unchanged with XLA routing intra-host collectives
over the device interconnect (NVLink) and inter-host ones over the network.

Like the reference's MPI paths (never exercised by its CI, SURVEY §4), the
multi-host bring-up cannot run on single-host CI hardware — but unlike the
reference we smoke-test it: tests/test_multihost.py launches two real OS
processes with one CPU device each, initializes the distributed runtime,
and psums across them (the CPU stand-in for two accelerator hosts).
"""

from __future__ import annotations

import os
from typing import Optional

import jax


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   local_device_ids=None) -> tuple:
    """Initialize the cross-host runtime. Where a cluster manager
    describes the job the three arguments are auto-detected (call with no
    arguments); otherwise pass them explicitly or via the standard environment
    (JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, JAX_PROCESS_ID —
    mirroring how mpirun feeds OMPI_COMM_WORLD_RANK to the reference).

    Returns (process_index, process_count, devices) after initialization;
    `devices` spans ALL hosts.
    """
    kw = {}
    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is not None:
        kw["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kw["num_processes"] = num_processes
    if process_id is not None:
        kw["process_id"] = process_id
    if local_device_ids is not None:
        kw["local_device_ids"] = local_device_ids
    jax.distributed.initialize(**kw)
    return jax.process_index(), jax.process_count(), jax.devices()


def is_coordinator() -> bool:
    """The multi-host analogue of the reference's rank-0 guards
    (obstacle_pg.py:32-40): IO and printing happen on one host."""
    return jax.process_index() == 0
