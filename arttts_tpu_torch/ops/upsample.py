"""K5: HiFi-GAN's stride-2 upsample, leaky ReLU + ConvTranspose1d, as a
hand-written CUDA kernel, with its plain PyTorch version.

Replaces the TPU kernel `_ups_kernel` behind
`arttts_tpu/ops/upsample_pallas.py:upsample_packed` (:135): lrelu(x, 0.1),
then ConvTranspose1d with kernel 2 * stride in torch semantics, plus bias,
(B, Cin, T) -> (B, Cout, T_out). The TPU kernel's lane packing and its
probed packed matrix (`build_packed_ups_matrix`) are not carried over: the
kernel evaluates the two input frames each output frame reads. Both
paddings in use work: the mel vocoder's (k - u) // 2 and SPARC's
u // 2 + u % 2 with output padding u % 2.

The kernel takes stride 2, kernel 4, Cout a multiple of 32 and Cin up to
`MAX_C_IN` (`upsample_supported`); the x8 upsamples stay
`ConvTranspose1dTorch`, as XLA computes them in the JAX package. It runs
both phases of the upsample as one implicit GEMM on the tensor cores in
3xTF32 (float32 accuracy, `TOL_KERNEL`), reading the weight in torch's
(Cin, Cout, 4) layout as it is; the note at the top of
`csrc/upsample1d.cu` says what bounds it on the H100 and how it is tiled.

On CPU tensors `upsample1d` runs the plain version; on CUDA tensors the
kernel; anything else raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from arttts_tpu_torch.ops import _build
from arttts_tpu_torch.ops.resblock2d import check_operand

LRELU_SLOPE = 0.1
MAX_C_IN = 256  # csrc/upsample1d.cu's kMaxCin: a block's input window must fit


def upsample_supported(stride: int, kernel_size: int, c_in: int, c_out: int) -> bool:
    """Whether K5 takes an upsample of this stride, kernel and widths."""
    return (stride == 2 and kernel_size == 2 * stride and c_out % 32 == 0
            and 1 <= c_in <= MAX_C_IN)


def upsample1d_plain(x, w, b, stride: int, padding: int, output_padding: int = 0):
    """Plain version of `upsample1d`."""
    if x.is_cuda:
        upsample1d_plain.cuda_calls += 1
    return F.conv_transpose1d(F.leaky_relu(x, LRELU_SLOPE), w, b, stride, padding,
                              output_padding)


upsample1d_plain.cuda_calls = 0


def upsample1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int, padding: int,
               output_padding: int = 0) -> torch.Tensor:
    """(B, Cin, T) -> (B, Cout, (T - 1) * stride - 2 * padding + k + output_padding);
    w torch layout (Cin, Cout, k)."""
    if x.device.type == "cpu":
        return upsample1d_plain(x, w, b, stride, padding, output_padding)
    if x.device.type != "cuda":
        raise ValueError(f"upsample1d runs on cpu or cuda tensors, not {x.device}")
    return _upsample1d_cuda(_build.library("upsample1d"), x, w, b, stride, padding,
                            output_padding)


upsample1d.launches = 0


def _upsample1d_cuda(lib, x, w, b, stride, padding, output_padding):
    if x.ndim != 3 or w.ndim != 3:
        raise ValueError(f"x, weight: want 3 dims, got {tuple(x.shape)}, {tuple(w.shape)}")
    B, c_in, T = x.shape
    c_out, k = w.shape[1], w.shape[2]
    if not upsample_supported(stride, k, c_in, c_out):
        raise ValueError(f"upsample1d takes stride 2, kernel 4, Cout a multiple of 32 and "
                         f"Cin <= {MAX_C_IN}, got stride {stride}, kernel {k}, Cin {c_in}, "
                         f"Cout {c_out}")
    if not 0 <= output_padding < stride or padding < 0:
        raise ValueError(f"padding {padding}, output_padding {output_padding} out of range")
    dev = x.device
    check_operand(x, (B, c_in, T), dev, "x")
    check_operand(w, (c_in, c_out, k), dev, "weight")
    check_operand(b, (c_out,), dev, "bias")
    if w.data_ptr() % 16:
        raise ValueError("weight: the kernel copies it 16 bytes at a time; want it 16-byte "
                         "aligned")
    t_out = (T - 1) * stride - 2 * padding + k + output_padding
    if t_out <= 0:
        raise ValueError(f"no output frames for T={T}, padding {padding}")
    out = torch.empty((B, c_out, t_out), device=dev)
    upsample1d.launches += 1
    p = _build.ptr
    _build.call(lib, "upsample1d", p(x), p(w), p(b), p(out), B, c_in, c_out, T, stride,
                padding, output_padding, _build.stream(x))
    return out
