"""The ("data", "model") grid of a multi-process run (port of
`arttts_tpu/parallel/mesh.py`).

The JAX package lays one SPMD program over a device mesh and lets XLA
insert the collectives. Here one process drives one device, so a mesh is
the process group's ranks laid out as (n_data, n_model), rank = data *
n_model + model, with one sub-group per row and per column:

  data   - batch sharding (DP): each rank keeps its contiguous rows of the
           global batch (`shard_batch`, or `DataLoader(host_id,
           num_hosts)` batching only those rows) and the step all-reduces gradients over this axis (`train/step.py`).
  model  - sequence parallelism: each rank keeps a contiguous chunk of the
           diffusion state's frame axis (`models/unet2d_sp.py`,
           `infer/sampler.py`).

A single process without a process group is the 1 x 1 mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from arttts_tpu_torch.core.device import resolve

@dataclasses.dataclass(frozen=True)
class Mesh:
    """`shape` {"data": n_data, "model": n_model}; `coords` this rank's
    position on each axis; `groups` the sub-group along each axis through
    this rank (None for an axis of size 1); `device` this rank's device."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, Optional[dist.ProcessGroup]]
    device: torch.device


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, device_type: str = "cuda") -> Mesh:
    """Lay the process group's ranks out as an (n_data, n_model) mesh (every
    rank must call this with the same arguments: it creates the
    sub-groups). The device is the current CUDA device for "cuda" (raises
    without a card), else `device_type`."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} != {world} processes")
    device = resolve(device_type)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    grid = np.arange(world).reshape(n_data, n_model)
    coords = {"data": rank // n_model, "model": rank % n_model}
    groups: Dict[str, Optional[dist.ProcessGroup]] = {}
    for axis, lines in (("data", grid.T), ("model", grid)):
        groups[axis] = None
        if lines.shape[1] == world > 1:
            groups[axis] = dist.group.WORLD
        elif lines.shape[1] > 1:
            for ranks in lines:  # every rank creates every group, in one order
                g = dist.new_group([int(r) for r in ranks])
                if rank in ranks:
                    groups[axis] = g
    return Mesh(shape={"data": n_data, "model": n_model}, coords=coords, groups=groups,
                device=device)


def local_slice(mesh: Mesh, axis: str, n: int) -> slice:
    """This rank's contiguous share of `n` items split over `axis`."""
    k = mesh.shape[axis]
    if n % k:
        raise ValueError(f"{n} items do not split over a {axis} axis of {k}")
    i = mesh.coords[axis]
    return slice(i * (n // k), (i + 1) * (n // k))


def shard_batch(mesh: Mesh, batch) -> Dict[str, torch.Tensor]:
    """A whole global batch (arrays with the batch first) -> this rank's
    rows, on its device."""
    return {k: torch.as_tensor(v)[local_slice(mesh, "data", len(v))].to(mesh.device)
            for k, v in batch.items()}


def replicate(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast `module`'s parameters and buffers from rank 0 to every
    rank of the mesh, in one flat buffer per dtype. Returns the module."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return module
    tensors = [t.data for t in (*module.parameters(), *module.buffers())]
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        same = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.broadcast(flat, src=0)
        offset = 0
        for t in same:
            t.copy_(flat[offset: offset + t.numel()].view_as(t))
            offset += t.numel()
    return module


class Collectives:
    """The collectives along one mesh axis, each one `all_reduce` (gloo
    takes CUDA tensors for `all_reduce` but not for `send` / `recv`, so two
    ranks can share one card; the same code runs over NCCL across cards).
    A neighbour exchange or a gather is an all-reduced slot buffer, zero
    but for each rank's own slot: exact, a sum of zeros and one value.
    `calls` and `bytes` count the all-reduces issued and their buffers."""

    def __init__(self, mesh: Mesh, axis: str):
        self.group = mesh.groups[axis]
        self.n = mesh.shape[axis]
        self.index = mesh.coords[axis]
        self.calls = 0
        self.bytes = 0

    def _reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        if self.n == 1:
            return t
        dist.all_reduce(t, op=op, group=self.group)
        self.calls += 1
        self.bytes += t.numel() * t.element_size()
        return t

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the axis (in place on `t`, which is returned)."""
        return self._reduce(t)

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """The maximum over the axis (in place on `t`, which is returned)."""
        return self._reduce(t, dist.ReduceOp.MAX)

    def halos(self, x: torch.Tensor, left: int, right: int):
        """The last `left` frames of the left neighbour's chunk and the first
        `right` of the right neighbour's (last axis of `x`), zeros at the
        sequence's ends, where an unsharded convolution reads its zero
        padding. Returns (from_left, from_right)."""
        buf = x.new_zeros((self.n, *x.shape[:-1], left + right))
        if left:
            buf[self.index, ..., :left] = x[..., -left:]
        if right:
            buf[self.index, ..., left:] = x[..., :right]
        self._reduce(buf)
        zeros = buf.new_zeros(buf.shape[1:])
        from_left = buf[self.index - 1] if self.index > 0 else zeros
        from_right = buf[self.index + 1] if self.index < self.n - 1 else zeros
        return from_left[..., :left], from_right[..., left:]

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' chunks of `x` concatenated on `dim`, on every rank."""
        buf = x.new_zeros((self.n, *x.shape))
        buf[self.index] = x
        return torch.cat(self._reduce(buf).unbind(0), dim=dim)
