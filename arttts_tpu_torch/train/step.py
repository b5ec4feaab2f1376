"""One training step (port of `arttts_tpu/train/step.py`).

The JAX package jits the whole step: encoder forward, alignment (MAS, or
the durations' path for GradTTArtic), segment cut, U-Net forward and
backward, per-submodule clip, Adam. Here the same step runs eagerly:
autograd differentiates the module path (`models/encoder.py`,
`models/unet2d.py`, `models/unet1d.py`), exactly the functions the JAX
step differentiates, and MAS runs on kernel K6. No kernel of this path
needs a backward: MAS is outside the gradient, and the serving kernels
K1-K5 are not on it. The loss is the model family's
(`train/losses.py:loss_for_model`); the batch's "spk" and "durations"
reach it when present.

A decoder with `compute_dtype="bfloat16"` trains as the JAX package trains
it: its module path casts the float32 parameters at each use, so autograd
gives float32 gradients and Adam's moments stay float32; the time
embedding's phases stay float32. The 1D decoder ignores the field.

The metrics stay on the device: nothing in a step waits for the card.

Data parallelism (`ddp=data_parallel(model, loss_fn, group)`): each rank
holds its rows of the global batch and the step computes what the JAX
sharded step computes, the loss of the global batch. The loss parts divide
by counts of the whole batch (`train/losses.py:loss_denominators`), so the
ranks all-reduce their counts first; each rank then backpropagates
world_size * (its numerators / the global counts), and DDP's gradient mean
is the global loss's gradient. The reported parts are all-reduced, the
same on every rank, and the clip and the norm act on the all-reduced
gradients, so every rank takes the same update.

Tensor parallelism (a model `parallel/tp.py:shard_tp` sharded over the
mesh's "model" axis, with or without `ddp` over its "data" axis): the
forward and backward run inside `gathered(model)`, one gather of the
shards, and each rank keeps its slice of the full gradient. The global
norm and the per-submodule clip need the squares of whole gradients, so
the shards' squares are summed over the model row first, and the row
takes its first rank's gradients of the replicated parameters
(`TensorParallel.reduce_gradients`); Adam then updates each shard, which
equals slicing the full update. A model `replicate_tp` laid out whole over
the row takes its first rank's gradients the same way.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from arttts_tpu_torch.parallel.tp import gathered, tensor_parallel
from arttts_tpu_torch.train.losses import grad_tts_loss, loss_denominators
from arttts_tpu_torch.utils.profiling import span

# The reference clips only the encoder and decoder parameter groups; the
# speaker modules (GradTTArtic's speaker encoding layer, the embedding table
# of other multi-speaker models) are never clipped (the JAX package's
# `_UNCLIPPED_SUBMODULES`: `spk_encoder`, `spk_table`).
UNCLIPPED_SUBMODULES = ("spk_enc", "spk_emb")


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (`optax.global_norm`)."""
    return torch.sqrt(sum(torch.sum(g**2) for g in tensors))


def clip_gradients(model: torch.nn.Module, max_norm: float) -> torch.Tensor:
    """The norm of all gradients (before the clip); then each top-level
    submodule's gradients (the port's `encoder` and `decoder`) clipped to
    global norm `max_norm`, in place, with the scale min(1, max_norm /
    (norm + 1e-6)): the reference clips its encoder and decoder
    separately, never with one global clip, and leaves the speaker modules
    (`UNCLIPPED_SUBMODULES`) unclipped. For a model laid out over a model
    row (`parallel/tp.py`) the squares are of whole gradients: the shards'
    are summed over the row, in the one all-reduce that gives the row its
    first rank's gradients of the replicated parameters."""
    def with_grads(params):
        return [p for p in params if p.grad is not None]

    clipped = [with_grads(child.parameters()) for name, child in model.named_children()
               if name not in UNCLIPPED_SUBMODULES]
    groups = [with_grads(model.parameters())] + [ps for ps in clipped if ps]
    tp = tensor_parallel(model)
    if tp is None:
        squares = [sum(torch.sum(p.grad**2) for p in ps) for ps in groups]
    else:
        squares = tp.reduce_gradients(model, groups)
    for params, sq in zip(groups[1:], squares[1:]):
        scale = torch.clamp(max_norm / (torch.sqrt(sq) + 1e-6), max=1.0)
        for p in params:
            p.grad.mul_(scale)
    return torch.sqrt(squares[0])


def make_optimizer(model: torch.nn.Module, learning_rate: float) -> torch.optim.Adam:
    """Adam with `optax.adam`'s defaults (betas 0.9, 0.999; eps 1e-8)."""
    return torch.optim.Adam(model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def _loss(loss_fn, model, generator, batch, out_size, pinned=None, denominators=None):
    return loss_fn(model, generator, batch["x"], batch["x_lengths"], batch["y"],
                   batch["y_lengths"], spk=batch.get("spk"), durations=batch.get("durations"),
                   out_size=out_size, pinned=pinned, denominators=denominators)


class StepLoss(torch.nn.Module):
    """The step's loss as a module. DDP prepares its gradient all-reduce in
    the `forward` of the module it wraps, and the losses call
    `model.encode` and the decoder rather than `model.forward`."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable):
        super().__init__()
        self.model = model
        self.loss_fn = loss_fn

    def forward(self, batch, generator, out_size, pinned, denominators):
        return _loss(self.loss_fn, self.model, generator, batch, out_size, pinned, denominators)


def data_parallel(model: torch.nn.Module, loss_fn: Callable,
                  group: Optional[dist.ProcessGroup] = None) -> DistributedDataParallel:
    """`model`'s loss under DDP over `group` (None: the default group); the
    model's parameters are broadcast from the group's first rank. Every
    preset's model gives every parameter a gradient, so DDP looks for no
    unused ones."""
    dev = next(model.parameters()).device
    return DistributedDataParallel(StepLoss(model, loss_fn),
                                   device_ids=[dev.index] if dev.type == "cuda" else None,
                                   process_group=group)


def train_step(model, optimizer, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator], out_size: Optional[int],
               grad_clip_norm: float = 1.0, loss_fn: Callable = grad_tts_loss,
               ddp: Optional[DistributedDataParallel] = None) -> Dict[str, torch.Tensor]:
    """One optimizer step of `loss_fn` on a batch of tensors on the model's
    device ({"x", "x_lengths", "y", "y_lengths"[, "spk", "durations"]}; with
    "pinned_t", "pinned_z", "pinned_offsets" the loss's draws are those).
    Puts the model in training mode. Returns the loss parts, `total_loss`
    and `grad_norm` (the norm of all gradients before the clip), as device
    scalars. `ddp` (`data_parallel(model, loss_fn, group)`): `batch` is this
    rank's rows of a global batch, and the step is the global batch's. A
    model `shard_tp` sharded steps on its shards. The module note has both.
    The step is an `arttts.train.step` span holding `arttts.train.loss`,
    `arttts.train.backward`, `arttts.train.clip` and
    `arttts.train.optimizer` (`utils/profiling.py:span`)."""
    with span("arttts.train.step"):
        model.train()
        pinned = None
        if "pinned_t" in batch:
            pinned = (batch["pinned_t"], batch["pinned_z"], batch["pinned_offsets"])
        optimizer.zero_grad(set_to_none=True)
        with gathered(model):
            if ddp is None:
                with span("arttts.train.loss"):
                    total, parts = _loss(loss_fn, model, generator, batch, out_size, pinned)
                with span("arttts.train.backward"):
                    total.backward()
            else:
                with span("arttts.train.loss"):
                    dens = loss_denominators(batch["x_lengths"], batch["y_lengths"], out_size,
                                             model.config.n_feats)
                    dist.all_reduce(dens, group=ddp.process_group)
                    total, parts = ddp(batch, generator, out_size, pinned, dens)
                with span("arttts.train.backward"):
                    (dist.get_world_size(ddp.process_group) * total).backward()
                    # this rank's shares of the global parts -> the global parts
                    names = list(parts)
                    shares = torch.stack([parts[k].detach() for k in names])
                    dist.all_reduce(shares, group=ddp.process_group)
                    parts = dict(zip(names, shares.unbind()))
                    total = shares.sum()
        with span("arttts.train.clip"):
            grad_norm = clip_gradients(model, grad_clip_norm)
        with span("arttts.train.optimizer"):
            optimizer.step()
    metrics = {k: v.detach() for k, v in parts.items()}
    metrics["total_loss"] = total.detach()
    metrics["grad_norm"] = grad_norm
    return metrics


@torch.no_grad()
def eval_step(model, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator],
              loss_fn: Callable = grad_tts_loss) -> Dict[str, torch.Tensor]:
    """Validation loss of `loss_fn` on the full sequences (no segment cut),
    the encoder deterministic, no gradient. The model's mode is restored
    after."""
    was_training = model.training
    model.eval()
    try:
        total, parts = _loss(loss_fn, model, generator, batch, None)
    finally:
        model.train(was_training)
    metrics = dict(parts)
    metrics["total_loss"] = total
    return metrics
