"""Process-group setup of a multi-process run (port of
`arttts_tpu/parallel/distributed.py`).

One process drives one device, as the reference's NCCL DDP trainer does
(`train_v1_1_dist.py`): every process is a "host" of the JAX package's
multi-host contract. Under a launcher:

    python -m torch.distributed.run --nproc_per_node=N \
        -m arttts_tpu_torch.cli.train --mesh ...

each rank calls

    host = init_distributed()              # no-op in a single process
    mesh = make_mesh()                     # parallel/mesh.py
    loader = DataLoader(..., host_id=host.process_index,
                        num_hosts=host.process_count)

The only environment read is the launcher's rendezvous contract (`RANK`,
`WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`), and only when
the caller passes no rendezvous arguments.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

log = logging.getLogger("arttts_tpu_torch.distributed")


@dataclasses.dataclass(frozen=True)
class HostInfo:
    process_index: int
    process_count: int
    local_devices: int
    global_devices: int


def _rank_device(device, local_rank: int) -> torch.device:
    """The device a rank drives: `device`, or `cuda:{local_rank}` when None.
    Raises for a CUDA device that does not exist: ranks never share a card
    unless the caller names it."""
    dev = torch.device(f"cuda:{local_rank}" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank device {dev} asked for, but no CUDA device is available")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"rank device {dev} asked for, but this host has "
                               f"{torch.cuda.device_count()} CUDA device(s)")
    return dev


def init_distributed(backend: Optional[str] = None, init_method: Optional[str] = None,
                     world_size: Optional[int] = None, rank: Optional[int] = None,
                     device=None) -> HostInfo:
    """Join the process group of a multi-process run and make this rank's
    device the current one.

    With no rendezvous arguments (`init_method`, `world_size`, `rank`) the
    launcher's environment is read (`init_method` "env://"); without one
    either, this is a single process and nothing happens. `device` defaults
    to `cuda:{LOCAL_RANK}` (`cuda:{rank}` with explicit arguments); the
    backend to "nccl" on a CUDA device and "gloo" on the CPU. Returns the
    process topology for per-rank batching. A process that has joined a
    group already keeps it (the JAX package warns and goes on likewise)."""
    if dist.is_initialized():
        log.warning("the process group is initialized already; keeping it")
        world = dist.get_world_size()
        return HostInfo(process_index=dist.get_rank(), process_count=world, local_devices=1,
                        global_devices=world)
    if init_method is None and world_size is None and rank is None:
        if "WORLD_SIZE" not in os.environ:
            return HostInfo(process_index=0, process_count=1, local_devices=1, global_devices=1)
        init_method = "env://"
        world_size, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        local_rank = int(os.environ["LOCAL_RANK"])
    elif init_method is None or world_size is None or rank is None:
        raise ValueError("init_method, world_size and rank go together")
    else:
        local_rank = rank
    dev = _rank_device(device, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    # NCCL binds the rank to its device; gloo takes tensors wherever they are
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            device_id=dev if backend == "nccl" else None)
    log.info("rank %d/%d on %s over %s", rank, world_size, dev, backend)
    return HostInfo(process_index=rank, process_count=world_size, local_devices=1,
                    global_devices=world_size)
