"""Shape and mask helpers (port of `arttts_tpu/ops/shape.py`).

Sequences keep the JAX package's `(B, T, C)` layout at public functions;
masks are `(B, T)` here and callers add the trailing axis.
"""

from __future__ import annotations

from typing import Optional

import torch


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """`(B,) int -> (B, max_length) bool`; True where index < length."""
    pos = torch.arange(max_length, device=lengths.device, dtype=lengths.dtype)
    return pos[None, :] < lengths[:, None]


def fix_len_compatibility(length: int, num_downsamplings_in_unet: int = 2) -> int:
    """Round `length` up to a multiple of 2**num_downsamplings (U-Net compat)."""
    factor = 2**num_downsamplings_in_unet
    return ((int(length) + factor - 1) // factor) * factor


def generate_path(duration: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Integer durations `(B, T_x)` -> 0/1 monotonic path `(B, T_x, T_y)`;
    row i covers frames [cum_dur[i-1], cum_dur[i]), times `mask`."""
    cum = torch.cumsum(duration, dim=1)
    pos = torch.arange(mask.shape[-1], device=duration.device, dtype=cum.dtype)
    path = (pos[None, None, :] < cum[:, :, None]).to(mask.dtype)
    prev = torch.nn.functional.pad(path, (0, 0, 1, 0))[:, :-1]
    return (path - prev) * mask


def duration_loss(logw: torch.Tensor, logw_hat: torch.Tensor, lengths: torch.Tensor,
                  denominator: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MSE between log-durations, normalised by the total token count
    (`denominator` when given: a data-parallel step's global count)."""
    den = torch.sum(lengths) if denominator is None else denominator
    return torch.sum((logw - logw_hat) ** 2) / den
