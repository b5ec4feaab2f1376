"""K2 and K3: the U-Net's stride-2 boundary convolutions as hand-written
CUDA kernels, with their plain PyTorch versions.

- `downsample2d` (K2) replaces the TPU kernels behind
  `arttts_tpu/ops/updown_pallas.py:downsample2d_to_real64` (:137, C=64) and
  `downsample2d_wide` (:362, C=128): `models/unet2d.py:Downsample2d`, a 3x3
  conv with stride 2 and padding 1, plus bias, on the masked input.
- `conv_transpose2d` (K3) replaces those behind `conv_transpose2d_wide`
  (:498, C=128) and `conv_transpose2d_from_real64` (:561, C=64):
  `models/convs.py:ConvTranspose2dTorch(k=4, s=2, p=1)`, torch semantics,
  weight in torch layout (in, out, kh, kw), on the masked input.

Layout (B, C, H, T) float32; `lengths` (B,) int32 counts the valid frames of
the input. Both kernels are implicit GEMMs on the tensor cores in 3xTF32
(float32 accuracy); they take torch-layout weights as they are. The note at
the top of `csrc/updown.cu` says how they are tiled and staged. The CUDA
side takes input channels in multiples of 8 and output channels in
multiples of 64.

`bf16=True` is the JAX kernels' default mode (`updown_pallas.py:108`,
`:249`): the masked input and the weights are rounded to bf16 (to nearest,
ties to even) and every product is summed in float32; the bias stays
float32. On the card it is a bf16 `mma.sync` mode of the same kernels.

On CPU tensors the wrappers run the plain version; on CUDA tensors the
kernel; anything else raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from arttts_tpu_torch.ops import _build
from arttts_tpu_torch.ops.resblock2d import check_operand, frame_mask, round_bf16


def _operand_pair(x, lengths, w, bf16):
    """The products' operands: the masked input and the weight, rounded to
    bf16 in the bf16 mode."""
    xm = x * frame_mask(lengths, x.shape[-1], x.dtype)
    return (round_bf16(xm), round_bf16(w)) if bf16 else (xm, w)


def downsample2d_plain(x, lengths, w, b, bf16: bool = False):
    """Plain version of `downsample2d`."""
    if x.is_cuda:
        downsample2d_plain.cuda_calls += 1
    return F.conv2d(*_operand_pair(x, lengths, w, bf16), b, stride=2, padding=1)


downsample2d_plain.cuda_calls = 0


def conv_transpose2d_plain(x, lengths, w, b, bf16: bool = False):
    """Plain version of `conv_transpose2d`."""
    if x.is_cuda:
        conv_transpose2d_plain.cuda_calls += 1
    return F.conv_transpose2d(*_operand_pair(x, lengths, w, bf16), b, stride=2, padding=1)


conv_transpose2d_plain.cuda_calls = 0


def _check_channels(c_in, c_out):
    if c_out % 64:
        raise ValueError(f"output channels must be a multiple of 64, got {c_out}")
    if c_in % 8:
        raise ValueError(f"input channels must be a multiple of 8, got {c_in}")


def _operands(x, lengths, w, b, w_shape, c_out):
    B, _, H, T = x.shape
    dev = x.device
    check_operand(x, x.shape, dev, "x")
    check_operand(lengths, (B,), dev, "lengths", torch.int32)
    check_operand(w, w_shape, dev, "weight")
    check_operand(b, (c_out,), dev, "bias")
    return B, H, T


def downsample2d(x: torch.Tensor, lengths: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor, bf16: bool = False) -> torch.Tensor:
    """(B, Cin, H, T) -> (B, Cout, ceil(H/2), ceil(T/2)); w (Cout, Cin, 3, 3)."""
    if x.device.type == "cpu":
        return downsample2d_plain(x, lengths, w, b, bf16)
    if x.device.type != "cuda":
        raise ValueError(f"downsample2d runs on cpu or cuda tensors, not {x.device}")
    return _downsample2d_cuda(_build.library("updown"), x, lengths, w, b, bf16)


downsample2d.launches = 0
downsample2d.bf16_launches = 0  # the launches among them in the bf16 mode


def _downsample2d_cuda(lib, x, lengths, w, b, bf16=False):
    c_out, c_in = w.shape[0], x.shape[1]
    _check_channels(c_in, c_out)
    B, H, T = _operands(x, lengths, w, b, (c_out, c_in, 3, 3), c_out)
    out = torch.empty((B, c_out, (H + 1) // 2, (T + 1) // 2), device=x.device)
    downsample2d.launches += 1
    downsample2d.bf16_launches += bool(bf16)
    p = _build.ptr
    _build.call(lib, _build.launcher("downsample3x3s2", bf16), p(x), p(lengths), p(w), p(b),
                p(out), B, c_in, c_out, H, T, _build.stream(x))
    return out


def conv_transpose2d(x: torch.Tensor, lengths: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor, bf16: bool = False) -> torch.Tensor:
    """(B, Cin, H, T) -> (B, Cout, 2H, 2T); w torch layout (Cin, Cout, 4, 4)."""
    if x.device.type == "cpu":
        return conv_transpose2d_plain(x, lengths, w, b, bf16)
    if x.device.type != "cuda":
        raise ValueError(f"conv_transpose2d runs on cpu or cuda tensors, not {x.device}")
    return _conv_transpose2d_cuda(_build.library("updown"), x, lengths, w, b, bf16)


conv_transpose2d.launches = 0
conv_transpose2d.bf16_launches = 0


def _conv_transpose2d_cuda(lib, x, lengths, w, b, bf16=False):
    c_in, c_out = w.shape[0], w.shape[1]
    _check_channels(c_in, c_out)
    B, H, T = _operands(x, lengths, w, b, (x.shape[1], c_out, 4, 4), c_out)
    out = torch.empty((B, c_out, 2 * H, 2 * T), device=x.device)
    conv_transpose2d.launches += 1
    conv_transpose2d.bf16_launches += bool(bf16)
    p = _build.ptr
    _build.call(lib, _build.launcher("convt4x4s2", bf16), p(x), p(lengths), p(w), p(b), p(out), B,
                c_in, c_out, H, T, _build.stream(x))
    return out
