"""K6: Monotonic Alignment Search (MAS) as a hand-written CUDA kernel, with
its plain PyTorch version and the NumPy oracle.

Replaces the TPU kernel `_mas_kernel` behind
`arttts_tpu/ops/mas_pallas.py:mas_pallas` (:180), which the JAX package's
`maximum_path` (`arttts_tpu/ops/mas.py:149-188`) runs off the CPU. The
training loss runs it once per step on the stop-gradient log-prior:

- a forward max-plus DP over the frames y, one column of text positions
  at a time, inside the band the lengths allow;
- a decision bit per cell (step to the previous text position or not);
- a backtrace from the last text position to a 0/1 path (B, T_x, T_y).

Semantics are the reference's Cython DP (`core.pyx`), band, `x == y` and
`x == 0` rules and the strict `<` of the backtrace included:
`mas_reference_numpy` transcribes it, and the kernel and the plain version
equal it bit for bit (only max and add in float32).

The TPU kernel's VMEM ceiling, above which the JAX wrapper sends large
problems to its scan, is not carried over: the kernel runs at every size
up to `MAX_T_X` text positions, one warp an utterance up to 1,024 and
several warps beyond, with its decision words in shared memory where they
fit and in device memory where they do not. A second launch writes the
path from the backtrace's text index per frame. The note at the top of
`csrc/mas.cu` says what bounds it and how it is laid out.

On CPU tensors `maximum_path` runs the plain version; on CUDA tensors the
kernel; anything else raises.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from arttts_tpu_torch.ops import _build
from arttts_tpu_torch.ops.resblock2d import check_operand

MAX_NEG_VAL = -1e9
MAX_T_X = 16384  # csrc/mas.cu: at most 16 warps of 32 x 32 positions an utterance


def mas_reference_numpy(
    value: np.ndarray,
    t_xs: np.ndarray,
    t_ys: np.ndarray,
    max_neg_val: float = MAX_NEG_VAL,
) -> np.ndarray:
    """Batched Viterbi-style MAS on the host, a transcription of the
    reference's Cython DP. value: (B, T_x, T_y) float32.

    Returns int32 paths (B, T_x, T_y). Mutates a copy of `value`.
    """
    value = value.astype(np.float32).copy()
    b, T_x, T_y = value.shape
    paths = np.zeros((b, T_x, T_y), dtype=np.int32)
    for i in range(b):
        t_x, t_y = int(t_xs[i]), int(t_ys[i])
        v = value[i]
        for y in range(t_y):
            for x in range(max(0, t_x + y - t_y), min(t_x, y + 1)):
                v_cur = max_neg_val if x == y else v[x, y - 1]
                if x == 0:
                    v_prev = 0.0 if y == 0 else max_neg_val
                else:
                    v_prev = v[x - 1, y - 1]
                v[x, y] = max(v_cur, v_prev) + v[x, y]
        index = t_x - 1
        for y in range(t_y - 1, -1, -1):
            paths[i, index, y] = 1
            if index != 0 and (
                index == y or v[index, y - 1] < v[index - 1, y - 1]
            ):
                index -= 1
    return paths


def maximum_path_plain(value: torch.Tensor, t_xs: torch.Tensor,
                       t_ys: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the kernel: value (B, T_x, T_y) float32,
    already masked; t_xs, t_ys (B,) ints. Returns the float32 path.

    A loop over the frames with one (B, T_x) column update each, and a
    backtrace loop gathering one decision per utterance and frame."""
    if value.is_cuda:
        maximum_path_plain.cuda_calls += 1
    B, T_x, T_y = value.shape
    dev = value.device
    xs = torch.arange(T_x, device=dev)[None, :]
    t_x = t_xs.long()[:, None]
    t_y = t_ys.long()[:, None]
    neg = torch.tensor(MAX_NEG_VAL, dtype=value.dtype, device=dev)
    prev = value.new_zeros(B, T_x)
    dec = torch.empty(B, T_x, T_y, dtype=torch.bool, device=dev)
    for y in range(T_y):
        in_band = (xs >= (t_x + y - t_y).clamp(min=0)) & (xs < t_x.clamp(max=y + 1))
        v_cur = torch.where(xs == y, neg, prev)
        shifted = F.pad(prev[:, :-1], (1, 0), value=MAX_NEG_VAL)  # prev[x - 1]
        v_prev = torch.where(xs == 0, 0.0 if y == 0 else MAX_NEG_VAL, shifted)
        # decision of frame y, from column y - 1 after its update
        dec[:, :, y] = (xs != 0) & ((xs == y) | ((y > 0) & (prev < shifted)))
        v_in = value[:, :, y]
        prev = torch.where(in_band, torch.maximum(v_cur, v_prev) + v_in, v_in)

    bidx = torch.arange(B, device=dev)
    index = (t_xs.long() - 1).clamp(min=0)
    path = value.new_zeros(B, T_x, T_y)
    for y in range(T_y - 1, -1, -1):
        active = t_ys > y
        path[bidx, index, y] = active.to(value.dtype)
        index = torch.where(active & dec[bidx, index, y], index - 1, index)
    return path


maximum_path_plain.cuda_calls = 0


def maximum_path(value: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The reference wrapper's contract: mask the log-prior, take each
    utterance's (t_x, t_y) from the mask, run MAS, return a float path.

    value: (B, T_x, T_y) log-prior; mask: (B, T_x, T_y) 0/1. The lengths
    stay on the tensors' device: nothing here waits for the card."""
    value = value * mask
    t_xs = mask[:, :, 0].sum(1).to(torch.int32)
    t_ys = mask[:, 0, :].sum(1).to(torch.int32)
    if value.device.type == "cpu":
        path = maximum_path_plain(value.float(), t_xs, t_ys)
    elif value.device.type == "cuda":
        path = _maximum_path_cuda(_build.library("mas"), value.float(), t_xs, t_ys)
    else:
        raise ValueError(f"maximum_path runs on cpu or cuda tensors, not {value.device}")
    return path.to(value.dtype)


maximum_path.launches = 0


def _maximum_path_cuda(lib, value, t_xs, t_ys):
    if value.ndim != 3:
        raise ValueError(f"value: want (B, T_x, T_y), got {tuple(value.shape)}")
    B, T_x, T_y = value.shape
    if min(B, T_x, T_y) < 1:
        raise ValueError(f"value: want B, T_x, T_y >= 1, got {tuple(value.shape)}")
    if T_x > MAX_T_X:
        raise ValueError(f"T_x {T_x} exceeds the kernel's {MAX_T_X}")
    dev = value.device
    check_operand(value, (B, T_x, T_y), dev, "value")
    check_operand(t_xs, (B,), dev, "t_xs", torch.int32)
    check_operand(t_ys, (B,), dev, "t_ys", torch.int32)
    n_words = lib.mas_dec_words(B, T_x, T_y)
    if n_words < 0:
        raise ValueError(f"value: (B, T_x, T_y) = {tuple(value.shape)} needs more decision "
                         f"words than the kernel counts")
    path = torch.empty_like(value)
    idx = torch.empty((B, T_y), dtype=torch.int32, device=dev)  # text index per frame
    dec = torch.empty((max(n_words, 1),), dtype=torch.int32, device=dev)
    maximum_path.launches += 1
    p = _build.ptr
    _build.call(lib, "mas_path", p(value), p(t_xs), p(t_ys), p(dec), p(idx), p(path), B, T_x,
                T_y, _build.stream(value))
    return path
