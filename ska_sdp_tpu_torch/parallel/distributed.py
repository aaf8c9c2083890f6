"""Process-group initialisation and the 2-D mesh (port of
``ska_sdp_tpu/parallel/distributed.py``).

Every process runs the same program on one device.  The cluster is
described by the reference's own environment: ``SKA_SDP_TPU_COORDINATOR``
(``host:port`` of rank 0's rendezvous), ``SKA_SDP_TPU_NPROCS`` and
``SKA_SDP_TPU_PROC_ID``, or the same three as arguments.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh, resolve_device


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device=None) -> torch.device:
    """Create the default process group and return this rank's device.

    NCCL on the card, gloo on the CPU (``device="cpu"``).  With a
    coordinator (argument or ``SKA_SDP_TPU_COORDINATOR``) the ranks meet at
    ``tcp://{coordinator}``; without one the group is a world of one on a
    ``dist.HashStore``, whose collectives still run.  Raises if a group
    already exists."""
    coordinator = coordinator or os.environ.get("SKA_SDP_TPU_COORDINATOR")
    if coordinator:
        num_processes = num_processes or int(
            os.environ["SKA_SDP_TPU_NPROCS"])
        process_id = process_id if process_id is not None else int(
            os.environ["SKA_SDP_TPU_PROC_ID"])
        where = dict(init_method=f"tcp://{coordinator}")
    else:
        num_processes, process_id = 1, 0
        where = dict(store=dist.HashStore())
    dev = resolve_device(device, process_id)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            world_size=num_processes, rank=process_id,
                            **where)
    return dev


def make_host_vis_mesh(per_host: Optional[int] = None, device=None) -> Mesh:
    """2-D ``("host", "vis")`` mesh over every rank: ``per_host`` ranks a
    host (default 1: a process holds one device), so ``world/per_host``
    hosts.  A reduction over both axes is an all-reduce over the world."""
    flat = make_mesh(device=device)
    per_host = per_host or 1
    if flat.size % per_host:
        raise ValueError(f"{flat.size} ranks do not form hosts of "
                         f"{per_host}")
    return Mesh(flat.group, flat.rank, flat.size, flat.device,
                ("host", "vis"), (flat.size // per_host, per_host))
