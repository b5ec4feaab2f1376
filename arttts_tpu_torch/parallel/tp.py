"""Tensor parallelism over the mesh's "model" axis (port of
`arttts_tpu/parallel/tp.py`).

The JAX package lays each parameter and its Adam moments out sharded on
their last axis and lets GSPMD partition every matmul and convolution.
DTensor's convolution strategy takes only a replicated weight, so here the
same layout is sharded storage, gathered at use:

- `tp_sharding(mesh, model)`: the JAX package's one shape rule. A
  parameter whose JAX leaf has at least 2 dims, and whose last axis divides
  by the "model" axis size n and is at least 2n, is sharded; every other
  one is replicated. The JAX leaf is the one the weight bridge
  (`utils/from_jax.py`) reads the tensor from, so the rule reads that
  leaf's last axis, not the torch module's output channels (`_jax_last_axis`).
- `shard_tp(mesh, model, optimizer=None)`: rank m of a model row keeps
  only its 1/n share of each sharded parameter, as the `original` of a
  `torch.nn.utils.parametrize` parametrization (`_Gathered`). Adam built
  over the result keeps its moments at the shard's shape; those of an
  `optimizer` built before are cut to it. Per-rank parameter and Adam
  memory falls by about 1/n.
- `gathered(model)`: inside it every sharded weight reads whole. The
  shards are gathered in one all-reduce per dtype (`_GatherAll`: each rank
  fills its slot of a zero buffer, as `parallel/mesh.py:Collectives`
  gathers, so ranks can share one card over gloo). Its backward keeps this
  rank's slice of each full gradient and needs no collective: every rank
  of a model row holds the same rows and computes the same gradient.
- `TensorParallel.reduce_gradients`: after the backward, one more
  all-reduce over the row gives every rank the row's first rank's
  gradients of the replicated parameters (so the row stays bit for bit
  equal even where a kernel's reductions are not deterministic) and sums
  the shards' squared norms, which the step's global norm and
  per-submodule clip need (`train/step.py`).
- `tp_state_dict(model)`: the full state dict under the reference's names,
  as a sharded JAX array reads whole.
- `replicate_tp(mesh, model)`: the layout of the JAX trainer's state over a
  "model" axis over 1, every parameter whole on every rank of the row. The
  same `reduce_gradients` keeps the row in lockstep: on the card the
  backward's reductions are not deterministic (cuDNN), and two ranks that
  each stepped on their own gradients drift apart in the last bits.

Adam's update is elementwise, so updating a shard equals slicing the full
update: the sharded step computes the single-device step.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn.utils import parametrize

from arttts_tpu_torch.models.wav2vec2 import SelfAttention
from arttts_tpu_torch.parallel.mesh import Collectives, Mesh


def _jax_last_axis(module: nn.Module, name: str, t: torch.Tensor,
                   mha_heads: Optional[int]) -> Optional[Tuple[int, int]]:
    """(the size of the JAX leaf's last axis, the torch dim that holds it)
    for parameter `name` of `module`, or None where the leaf has under 2
    dims. The bridge's layouts (`utils/from_jax.py`):

      flax Dense / Conv kernels (in, out), (k, in/g, out), (kh, kw, in, out)
        -> Linear / Conv weights, out on dim 0;
      flax MHA query/key/value kernels (D, H, dh) and biases (H, dh)
        -> Linear (H*dh, D) and (H*dh,): the last axis dh lies within dim 0;
      everything else keeps its layout: embeddings (V, D),
        ConvTranspose*dTorch weights (their last axis the kernel width), the
        relative position tables, LSTM weights; and 1-D leaves.

    (WavLM's `gru_rel_pos_const`, (H,) there and (1, H, 1, 1) here, reads
    as a last axis of 1: replicated by either reading.)"""
    if mha_heads is not None:
        return t.shape[0] // mha_heads, 0
    if name == "weight" and isinstance(module, (nn.Linear, nn.Conv1d, nn.Conv2d)):
        return t.shape[0], 0
    if t.dim() >= 2:
        return t.shape[-1], t.dim() - 1
    return None


def tp_sharding(mesh: Mesh, model: nn.Module) -> Dict[str, Optional[int]]:
    """For each parameter of `model` (an unsharded model, by the names of
    `named_parameters()`): the torch dim it is stored split on under the
    JAX rule at the mesh's "model" axis size, or None (replicated)."""
    n = mesh.shape.get("model", 1)
    mha = {id(getattr(m, p)): m.num_heads for m in model.modules()
           if isinstance(m, SelfAttention) for p in ("q_proj", "k_proj", "v_proj")}
    out: Dict[str, Optional[int]] = {}
    for mod_name, module in model.named_modules():
        for name, t in module.named_parameters(recurse=False):
            last = _jax_last_axis(module, name, t, mha.get(id(module)))
            sharded = n > 1 and last is not None and last[0] % n == 0 and last[0] >= 2 * n
            out[f"{mod_name}.{name}" if mod_name else name] = last[1] if sharded else None
    return out


class _Entry:
    """One sharded parameter: its module and name, the dim it is split on,
    its full shape and its offset in the flat buffer of its dtype."""

    def __init__(self, module, name, dim, full_shape, offset):
        self.module, self.name, self.dim = module, name, dim
        self.full_shape, self.offset = full_shape, offset

    @property
    def shard(self) -> nn.Parameter:
        return self.module.parametrizations[self.name].original


class TensorParallel:
    """The layout of one model over a mesh's "model" axis: `shard_tp`'s
    shards (`entries`, shared with the model's `_Gathered`
    parametrizations), or none for `replicate_tp`. `comm.calls` and
    `comm.bytes` count its all-reduces and their bytes."""

    def __init__(self, mesh: Mesh, keys: List[str]):
        self.comm = Collectives(mesh, "model")
        self.n, self.index = self.comm.n, self.comm.index
        self.keys = keys  # the unsharded model's state-dict keys, in order
        self.entries: List[_Entry] = []
        self.sizes: Dict[torch.dtype, int] = {}  # a shard buffer's elements, by dtype
        self.full: Optional[Tuple[torch.Tensor, ...]] = None

    def local(self, t: torch.Tensor, e: _Entry) -> torch.Tensor:
        """This rank's share of a full-shaped `t`."""
        k = e.full_shape[e.dim] // self.n
        return t.narrow(e.dim, self.index * k, k).contiguous()

    def gather(self, shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The full tensors of `shards` (in entry order): one all-reduce of
        a (n, elements) buffer per dtype, zero but for this rank's row."""
        fulls: List[Optional[torch.Tensor]] = [None] * len(shards)
        for dtype, size in self.sizes.items():
            mine = [i for i, s in enumerate(shards) if s.dtype == dtype]
            buf = shards[mine[0]].new_zeros((self.n, size))
            buf[self.index] = torch.cat([shards[i].reshape(-1) for i in mine])
            self.comm.sum(buf)
            for i in mine:
                e, s = self.entries[i], shards[i]
                pieces = buf[:, e.offset: e.offset + s.numel()].unbind(0)
                fulls[i] = torch.cat([p.view(s.shape) for p in pieces], dim=e.dim)
        return fulls

    def reduce_gradients(self, model: nn.Module,
                         groups: Sequence[Sequence[nn.Parameter]]) -> torch.Tensor:
        """After the backward: give every rank of the model row its first
        rank's gradients of the replicated parameters (in place; the same
        numbers wherever the backward is deterministic), and return each
        group's sum of squared gradients, the shards' summed over the row.
        One float32 all-reduce: the replicated gradients (zero but on the
        row's first rank) and the shards' squares."""
        shard_ids = {id(e.shard) for e in self.entries}
        rep = [p.grad for p in model.parameters()
               if id(p) not in shard_ids and p.grad is not None]
        dev = next(model.parameters()).device

        def sq(params, sharded: bool) -> torch.Tensor:
            return sum((torch.sum(p.grad.float() ** 2) for p in params
                        if p.grad is not None and (id(p) in shard_ids) == sharded),
                       torch.zeros((), device=dev))

        shard_sq = torch.stack([sq(ps, True) for ps in groups])
        buf = torch.cat([*(g.reshape(-1).float() for g in rep), shard_sq])
        if self.index:
            buf[: buf.numel() - len(groups)] = 0
        self.comm.sum(buf)
        offset = 0
        for g in rep:
            g.copy_(buf[offset: offset + g.numel()].view_as(g))
            offset += g.numel()
        return buf[offset:] + torch.stack([sq(ps, False) for ps in groups])


class _Gathered(nn.Module):
    """The parametrization of one sharded parameter: its `original` is this
    rank's shard; read inside `gathered(model)` it is the full tensor."""

    def __init__(self, tp: TensorParallel, i: int):
        super().__init__()
        self.tp, self.i = tp, i

    def forward(self, shard: torch.Tensor) -> torch.Tensor:
        if self.tp.full is None:
            raise RuntimeError("a tensor-parallel weight is read outside `gathered(model)`")
        return self.tp.full[self.i]

    def right_inverse(self, full: torch.Tensor) -> torch.Tensor:
        return self.tp.local(full, self.tp.entries[self.i])


class _GatherAll(torch.autograd.Function):
    """shards -> full tensors (one all-reduce per dtype); the backward keeps
    this rank's slice of each full gradient."""

    @staticmethod
    def forward(ctx, tp, *shards):
        ctx.tp = tp
        return tuple(tp.gather(shards))

    @staticmethod
    def backward(ctx, *grads):
        tp = ctx.tp
        return (None, *(tp.local(g, e) for g, e in zip(grads, tp.entries)))


def tensor_parallel(model: nn.Module) -> Optional[TensorParallel]:
    """The `TensorParallel` of a model `shard_tp` or `replicate_tp` laid
    out over a model axis over 1, else None."""
    return getattr(model, "_tensor_parallel", None)


def replicate_tp(mesh: Mesh, model: nn.Module) -> nn.Module:
    """Keep `model` whole on every rank of the mesh's model row, in
    lockstep: `train_step` gives the row its first rank's gradients (one
    all-reduce of them a step), so the ranks take the same update wherever
    the backward's bits differ. Every rank of the mesh calls this. Returns
    `model`; a mesh with a "model" axis of 1 leaves it as it is."""
    if mesh.shape.get("model", 1) > 1:
        if tensor_parallel(model) is not None:
            raise ValueError("the model is laid out over the model axis already")
        model._tensor_parallel = TensorParallel(mesh, list(model.state_dict().keys()))
    return model


def shard_tp(mesh: Mesh, model: nn.Module,
             optimizer: Optional[torch.optim.Optimizer] = None) -> nn.Module:
    """Keep only this rank's share of each parameter `tp_sharding` shards
    (rank m of the model row: the m-th of n equal slices on its dim); the
    replicated ones stay whole. `optimizer`'s state tensors of a sharded
    parameter (Adam's moments) are cut to the shard too. Every rank of the
    mesh calls this on the same model. Shard before wrapping the model in
    DDP. Returns `model`; a mesh with a "model" axis of 1 leaves it as it
    is."""
    layout = tp_sharding(mesh, model)
    if all(d is None for d in layout.values()):
        return model
    if tensor_parallel(model) is not None:
        raise ValueError("the model is laid out over the model axis already")
    tp = TensorParallel(mesh, list(model.state_dict().keys()))
    model._tensor_parallel = tp
    modules = dict(model.named_modules())
    for key, dim in layout.items():
        if dim is None:
            continue
        mod_name, _, name = key.rpartition(".")
        module = modules[mod_name]
        p = getattr(module, name)
        full_shape = tuple(p.shape)
        tp.entries.append(_Entry(module, name, dim, full_shape, tp.sizes.get(p.dtype, 0)))
        tp.sizes[p.dtype] = tp.sizes.get(p.dtype, 0) + p.numel() // tp.n
        if optimizer is not None:
            state = optimizer.state.get(p, {})
            for k, v in state.items():
                if torch.is_tensor(v) and tuple(v.shape) == full_shape:
                    state[k] = tp.local(v, tp.entries[-1])
        parametrize.register_parametrization(module, name, _Gathered(tp, len(tp.entries) - 1),
                                             unsafe=True)
    return model


@contextlib.contextmanager
def gathered(model: nn.Module):
    """Every sharded weight of `model` reads whole inside this block (one
    gather; gradients reach the shards). Nothing happens for a model
    `shard_tp` did not shard. Every rank of the model row enters it."""
    tp = tensor_parallel(model)
    if tp is None or not tp.entries:
        yield
        return
    tp.full = _GatherAll.apply(tp, *(e.shard for e in tp.entries))
    try:
        yield
    finally:
        tp.full = None


def tp_state_dict(model: nn.Module) -> "OrderedDict[str, torch.Tensor]":
    """`model.state_dict()` with every sharded parameter whole, under the
    unsharded model's keys and in its order (a collective over the model
    row; the plain state dict for an unsharded model)."""
    tp = tensor_parallel(model)
    if tp is None or not tp.entries:
        return model.state_dict()
    sd = model.state_dict()
    names = {id(m): n for n, m in model.named_modules()}
    with torch.no_grad():
        fulls = tp.gather([e.shard.detach() for e in tp.entries])
    for e, full in zip(tp.entries, fulls):
        prefix = names[id(e.module)]
        prefix = f"{prefix}." if prefix else ""
        sd[f"{prefix}{e.name}"] = full
        del sd[f"{prefix}parametrizations.{e.name}.original"]
    return OrderedDict((k, sd[k]) for k in tp.keys)
