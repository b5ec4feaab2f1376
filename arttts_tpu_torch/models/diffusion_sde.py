"""VP-SDE diffusion math (port of `arttts_tpu/models/diffusion_sde.py`).

Linear schedule beta(t) = beta_min + (beta_max - beta_min) * t with the
closed-form forward diffusion toward the encoder prior mu. The Euler sampler
that uses the schedule is `arttts_tpu_torch/infer/sampler.py`; the training
loss uses the rest. Tensors are (B, T, C), masks (B, T, 1); every draw
takes an explicit `torch.Generator` on the tensors' device.
"""

from __future__ import annotations

from typing import Optional

import torch


def get_noise(t, beta_min: float, beta_max: float, cumulative: bool = False):
    """beta(t), or its integral from 0 to t when cumulative."""
    if cumulative:
        return beta_min * t + 0.5 * (beta_max - beta_min) * (t**2)
    return beta_min + (beta_max - beta_min) * t


def forward_diffusion(generator: Optional[torch.Generator], x0, mask, mu, t,
                      beta_min: float, beta_max: float, z: Optional[torch.Tensor] = None):
    """Closed-form q(x_t | x_0): the mean decays x0 toward mu, the variance
    is 1 - exp(-cum_noise). `z` overrides the Gaussian draw (the parity
    tests pin it); `generator` may then be None.

    Returns (xt, z), both masked, shaped like x0."""
    time = t[:, None, None]
    cum_noise = get_noise(time, beta_min, beta_max, cumulative=True)
    mean = x0 * torch.exp(-0.5 * cum_noise) + mu * (1.0 - torch.exp(-0.5 * cum_noise))
    variance = 1.0 - torch.exp(-cum_noise)
    if z is None:
        z = torch.randn(x0.shape, generator=generator, dtype=x0.dtype, device=x0.device)
    xt = mean + z * torch.sqrt(variance)
    return xt * mask, z * mask


def diffusion_loss_from_estimate(noise_estimate, z, mask, t, n_feats: int,
                                 beta_min: float, beta_max: float, denominator=None):
    """Lambda-weighted score matching:
    || sqrt(1 - exp(-cum_noise)) * estimate + z ||^2 / (sum(mask) * n_feats),
    or over `denominator` when given (a data-parallel step's global count)."""
    time = t[:, None, None]
    cum_noise = get_noise(time, beta_min, beta_max, cumulative=True)
    weighted = noise_estimate * torch.sqrt(1.0 - torch.exp(-cum_noise))
    den = torch.sum(mask) * n_feats if denominator is None else denominator
    return torch.sum((weighted + z) ** 2) / den


def sample_t(generator: torch.Generator, batch: int, offset: float = 1e-5,
             dtype=torch.float32, device="cpu"):
    """t ~ U(0, 1), clamped to [offset, 1 - offset]."""
    t = torch.rand(batch, generator=generator, dtype=dtype, device=device)
    return torch.clamp(t, offset, 1.0 - offset)
