"""K4: one whole HiFi-GAN MRF stage as a hand-written CUDA kernel, with its
plain PyTorch version.

Replaces the TPU kernel `_mrf_kernel` behind
`arttts_tpu/ops/mrf_pallas.py:mrf_stage` (:432). The function is the sum
over a stage's branches of `models/hifigan.py:ResBlock` (or, with `film`,
`FiLMResBlock`), divided by the branch count:

    xb = x ; per round (dilation d):
        xt = conv(k, d)(lrelu(xb)) + b1 ; xt = conv(k, 1)(lrelu(xt)) + b2
        [xt = xt * a + b]  (FiLM, per utterance and channel)
        xb = xb + xt
    out = sum over branches of xb / n_branches

with SAME zero padding at the tensor's own frame range (a padded bucket is
vocoded with its zero frames, as on the module path). Layout (B, C, T)
float32, C in {32, 64, 128}, kernel sizes 3, 7 and 11. The C=256 stage stays
on the modules, as in the JAX package (`mrf_supported` there).

The note at the top of `csrc/mrf.cu` says what bounds the kernel on the
H100 and how it is tiled: one launch per (branch, round), both dilated
convolutions as implicit GEMMs on the tensor cores in 3xTF32, each round's
intermediate kept in shared memory, the branch sum added in a fixed order.
The kernel reads each branch's weights in torch's Conv1d layout
(C_out, C_in, k), as `stage_weights` stacks them: no copy or re-layout per
call. It takes conv1 halos (k - 1) * dilation of up to `MAX_HALO` frames.

`bf16=True` is the JAX kernel's opt-in bf16 mode (`mrf_stage`'s `bf16`,
`mrf_pallas.py:441`): the weights and each leaky-ReLU'd conv input are
rounded to bf16 (to nearest, ties to even; `:130-131`, `:315-319`) and every
product is summed in float32; biases and FiLM stay float32. On the card it
is a bf16 `mma.sync` mode of the same kernel. The port has no environment
switch for it: the caller passes `bf16`.

On CPU tensors `mrf_stage` runs the plain version; on CUDA tensors the
kernel; anything else raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from arttts_tpu_torch.ops import _build
from arttts_tpu_torch.ops.resblock2d import check_operand, round_bf16

LRELU_SLOPE = 0.1
CHANNELS = (32, 64, 128)
KERNEL_SIZES = (3, 7, 11)
MAX_HALO = 64  # frames of conv1's input halo, (k - 1) * dilation: csrc/mrf.cu's kMaxHalo


@dataclasses.dataclass(frozen=True)
class MRFBranch:
    """One ResBlock of a stage, its rounds stacked: conv weights in the
    Conv1d layout (out, in, k), one per round."""

    w1: torch.Tensor  # (n_rounds, C, C, k), dilation dilations[r]
    b1: torch.Tensor  # (n_rounds, C)
    w2: torch.Tensor  # (n_rounds, C, C, k), dilation 1
    b2: torch.Tensor  # (n_rounds, C)
    dilations: Tuple[int, ...]


def _conv(m: nn.Module) -> nn.Conv1d:
    """A ResBlock's Conv1d, or the Conv1d of a SPARC block's
    Sequential(LeakyReLU, Conv1d)."""
    return m[-1] if isinstance(m, nn.Sequential) else m


def stage_weights(blocks: Sequence[nn.Module]) -> Tuple[MRFBranch, ...]:
    """One stage's `ResBlock`/`FiLMResBlock` modules -> the branches
    `mrf_stage` takes (the counterpart of the JAX `pack_mrf_weights`)."""
    out = []
    for blk in blocks:
        c1 = [_conv(m) for m in blk.convs1]
        c2 = [_conv(m) for m in blk.convs2]
        out.append(MRFBranch(
            w1=torch.stack([c.weight for c in c1]), b1=torch.stack([c.bias for c in c1]),
            w2=torch.stack([c.weight for c in c2]), b2=torch.stack([c.bias for c in c2]),
            dilations=tuple(c.dilation[0] for c in c1),
        ))
    return tuple(out)


def mrf_supported(channels: int, kernel_sizes: Sequence[int]) -> bool:
    """Whether K4 takes a stage of this width and these branch kernels."""
    return channels in CHANNELS and all(k in KERNEL_SIZES for k in kernel_sizes)


def _conv1d(x, w, b, dilation):
    return F.conv1d(x, w, b, padding=dilation * (w.shape[-1] - 1) // 2, dilation=dilation)


def _conv1d_bf16(x, w, b, dilation):
    return _conv1d(round_bf16(x), round_bf16(w), b, dilation)


def stage_with_products(x: torch.Tensor, weights: Sequence[MRFBranch],
                        film: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                        conv=_conv1d) -> torch.Tensor:
    """`mrf_stage_plain`'s computation with its convolutions given as a
    function (input, weight (C_out, C_in, k), bias, dilation) -> output with
    SAME zero padding. The tests hand it an emulation of the kernel's
    arithmetic."""
    out = None
    for j, br in enumerate(weights):
        xb = x
        for r, d in enumerate(br.dilations):
            xt = conv(F.leaky_relu(xb, LRELU_SLOPE), br.w1[r], br.b1[r], d)
            xt = conv(F.leaky_relu(xt, LRELU_SLOPE), br.w2[r], br.b2[r], 1)
            if film is not None:
                xt = xt * film[0][j, r][:, :, None] + film[1][j, r][:, :, None]
            xb = xb + xt
        out = xb if out is None else out + xb
    return out / len(weights)


def mrf_stage_plain(x: torch.Tensor, weights: Sequence[MRFBranch],
                    film: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    bf16: bool = False) -> torch.Tensor:
    """The plain PyTorch version of `mrf_stage` (same arguments)."""
    if x.is_cuda:
        mrf_stage_plain.cuda_calls += 1
    return stage_with_products(x, weights, film, _conv1d_bf16 if bf16 else _conv1d)


mrf_stage_plain.cuda_calls = 0


def mrf_stage(x: torch.Tensor, weights: Sequence[MRFBranch],
              film: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              bf16: bool = False) -> torch.Tensor:
    """One whole MRF stage: (B, C, T) -> (B, C, T).

    `weights`: one `MRFBranch` per branch (`stage_weights`). `film`: an
    optional (a, b) pair, each (n_branches, n_rounds, B, C). `bf16`: the
    JAX kernel's bf16 mode."""
    if x.device.type == "cpu":
        return mrf_stage_plain(x, weights, film, bf16)
    if x.device.type != "cuda":
        raise ValueError(f"mrf_stage runs on cpu or cuda tensors, not {x.device}")
    return _mrf_stage_cuda(_build.library("mrf"), x, weights, film, bf16)


mrf_stage.launches = 0
mrf_stage.film_launches = 0  # the launches among them in FiLM mode
mrf_stage.bf16_launches = 0  # ... and in the bf16 mode


def _mrf_stage_cuda(lib, x, weights, film, bf16=False):
    if x.ndim != 3:
        raise ValueError(f"x: want (B, C, T), got {tuple(x.shape)}")
    B, C, T = x.shape
    dev = x.device
    check_operand(x, (B, C, T), dev, "x")
    if C not in CHANNELS:
        raise ValueError(f"channels must be one of {CHANNELS}, got {C}")
    n_br = len(weights)
    if n_br == 0:
        raise ValueError("mrf_stage needs at least one branch")
    n_rounds = len(weights[0].dilations)
    for j, br in enumerate(weights):
        k = br.w1.shape[-1]
        if k not in KERNEL_SIZES:
            raise ValueError(f"branch {j}: kernel size must be one of {KERNEL_SIZES}, got {k}")
        if len(br.dilations) != n_rounds or min(br.dilations) < 1:
            raise ValueError(f"branch {j}: want {n_rounds} dilations >= 1, got {br.dilations}")
        if (k - 1) * max(br.dilations) > MAX_HALO:
            raise ValueError(f"branch {j}: halo (k - 1) * dilation must be <= {MAX_HALO} "
                             f"frames, got k={k}, dilations {br.dilations}")
        for name in ("w1", "w2"):
            check_operand(getattr(br, name), (n_rounds, C, C, k), dev, f"branch {j} {name}")
        for name in ("b1", "b2"):
            check_operand(getattr(br, name), (n_rounds, C), dev, f"branch {j} {name}")
    if film is not None:
        for t, name in zip(film, ("film a", "film b")):
            check_operand(t, (n_br, n_rounds, B, C), dev, name)

    p = _build.ptr
    s = _build.stream(x)
    out = torch.empty_like(x)
    tmp = [torch.empty_like(x) for _ in range(min(2, n_rounds - 1))]
    mrf_stage.launches += 1
    mrf_stage.film_launches += film is not None
    mrf_stage.bf16_launches += bool(bf16)
    fn = _build.launcher("mrf_round", bf16)
    for j, br in enumerate(weights):
        k = br.w1.shape[-1]
        src = x
        for r, d in enumerate(br.dilations):
            last = r == n_rounds - 1
            dst = out if last else tmp[r % 2]
            fa = film[0][j, r] if film is not None else None
            fb = film[1][j, r] if film is not None else None
            scale = 1.0 / n_br if last and j == n_br - 1 else 1.0
            _build.call(lib, fn, p(src), p(br.w1[r]), p(br.b1[r]), p(br.w2[r]),
                        p(br.b2[r]), p(fa), p(fb), p(dst), B, C, k, T, d,
                        int(last and j > 0), scale, s)
            src = dst
    return out
