"""Process groups across hosts.

Port of `sparktts_tpu/parallel/multihost.py`.  JAX calls
`jax.distributed.initialize()` on every host and builds a mesh whose outer
axis spans hosts (data parallel over the data-center network: cheap
collectives only) and whose inner axis stays within one host (tensor
parallel: the bandwidth-hungry collectives ride the host's own links).
Here every rank joins one `torch.distributed` process group at a
coordinator's `tcp://` address, and `make_multihost_mesh` lays the ranks
out host-major so that no tp row crosses a host.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import numpy as np
import torch.distributed as dist

from sparktts_tpu_torch.parallel.mesh import DEFAULT_TIMEOUT_S, Mesh, _mesh_from_grid

logger = logging.getLogger(__name__)


def initialize_distributed(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    backend: str = "nccl",
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> None:
    """Join the job's process group: `coordinator_address` is rank 0's
    "host:port" (or a full "tcp://host:port"), `backend` "nccl" for the
    card and "gloo" for the CPU, named by the caller (nothing is detected:
    no cluster tells a process its rank).  Every collective fails after
    `timeout_s` rather than wait forever for a rank that died."""
    address = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=address, rank=process_id,
                            world_size=num_processes,
                            timeout=datetime.timedelta(seconds=timeout_s))
    logger.info("distributed: process %d/%d over %s (%s)", process_id, num_processes, address,
                backend)


def make_multihost_mesh(tp: Optional[int] = None, local_size: Optional[int] = None,
                        device=None, timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """(dp, tp) mesh over every rank with each tp row inside one host.

    Ranks are numbered host-major (rank = host * local_size + local rank,
    as a launcher that starts `local_size` processes a host numbers them),
    so rows of `tp` consecutive ranks stay within a host when tp divides
    `local_size` (default: $LOCAL_WORLD_SIZE, else the whole world).  dp =
    world / tp spans the hosts.  Default tp: 2 on an even local size.
    `device` and `timeout_s` as in `make_mesh` (default: the rank's local
    card).  Collective, as `make_mesh`."""
    world = dist.get_world_size()
    if local_size is None:
        local_size = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if tp is None:
        tp = 2 if local_size % 2 == 0 and local_size > 1 else 1
    assert local_size % tp == 0, f"tp={tp} must divide the ranks of a host ({local_size})"
    assert world % local_size == 0, f"{world} ranks are not whole hosts of {local_size}"
    grid = np.arange(world).reshape(-1, tp, 1)
    return _mesh_from_grid(grid, device, timeout_s)
