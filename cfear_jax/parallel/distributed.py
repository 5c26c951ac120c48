"""Multi-host execution: jax.distributed bring-up + global meshes.

The reference's only "distribution" is a bash process fleet writing to a
shared filesystem (SURVEY.md §2.3). Here multi-host runs are first-class:

- `initialize(...)`: wraps `jax.distributed.initialize` (coordinator address
  + process count from args or env: CFEAR_COORDINATOR, CFEAR_NUM_PROCESSES,
  CFEAR_PROCESS_ID, CFEAR_LOCAL_DEVICE_IDS).
- `global_mesh(...)`: a mesh over ALL processes' devices. Odometry batches
  and the edge-sharded pose-graph backend both use one `data` axis: the
  cards of a host are joined all to all, so the mesh follows the algorithm
  (sequences never communicate; edge shards psum every CG iteration).
  `axes=("host", "data")` splits the axis per process where several hosts
  are joined by a slower network.
- `shard_jobs(...)`: deterministic host assignment of (sequence, config)
  jobs — the `job_nr % NR_WORKERS` rule of the reference's fleet.

Tested with real multi-process CPU runs (tests/test_multihost.py spawns two
jax.distributed processes and checks a cross-host psum and an edge-sharded
pose-graph solve).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None) -> None:
    """Bring up jax.distributed (no-op when single-process).

    `local_device_ids` (or CFEAR_LOCAL_DEVICE_IDS, comma-separated) gives
    this process its own cards when several processes share a host;
    otherwise every process would reserve memory on every card."""
    coordinator = coordinator or os.environ.get("CFEAR_COORDINATOR")
    if coordinator is None:
        return
    num_processes = num_processes or int(
        os.environ.get("CFEAR_NUM_PROCESSES", "1"))
    process_id = process_id if process_id is not None else int(
        os.environ.get("CFEAR_PROCESS_ID", "0"))
    if local_device_ids is None and os.environ.get("CFEAR_LOCAL_DEVICE_IDS"):
        local_device_ids = [int(v) for v in
                            os.environ["CFEAR_LOCAL_DEVICE_IDS"].split(",")]
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=local_device_ids)


def global_mesh(axes: Tuple[str, ...] = ("data",),
                shape: Optional[Tuple[int, ...]] = None) -> Mesh:
    """Mesh over all global devices (across every process)."""
    devs = np.asarray(jax.devices())
    if shape is None:
        shape = (len(devs),) if len(axes) == 1 else None
    if shape is None:
        n_host = jax.process_count()
        shape = (n_host, len(devs) // n_host)
    return Mesh(devs.reshape(shape), axes)


def shard_jobs(jobs: Sequence, n_workers: Optional[int] = None,
               worker: Optional[int] = None):
    """Deterministic job assignment (reference `utils/worker` semantics)."""
    n_workers = n_workers or max(jax.process_count(), 1)
    worker = worker if worker is not None else jax.process_index()
    return [j for i, j in enumerate(jobs) if i % n_workers == worker]
