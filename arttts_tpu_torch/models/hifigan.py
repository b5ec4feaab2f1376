"""HiFi-GAN mel vocoder on the module path (port of
`arttts_tpu/models/hifigan.py:HiFiGANGenerator`, `ResBlock`, `leaky_relu`).

The MRF stages run as plain PyTorch convolutions: the JAX package's own
configuration with `ARTTTS_DISABLE_MRF_PALLAS=1`. Their Hopper kernel
(`mrf_stage`, with `upsample_packed`) is the next slice of the port.

State-dict names are jik876's `Generator` with weight norm folded
(`conv_pre`, `ups.{i}`, `resblocks.{n}.convs1.{c}`, `convs2.{c}`,
`conv_post`), the names `arttts_tpu/utils/torch_convert.py` reads. The
public forward keeps the JAX layout: mel (B, T, 80) -> wav (B, T*256, 1).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from arttts_tpu_torch.core.device import resolve
from arttts_tpu_torch.models.convs import ConvTranspose1dTorch

LRELU_SLOPE = 0.1


def leaky_relu(x, slope: float = LRELU_SLOPE):
    return F.leaky_relu(x, slope)


class ResBlock(nn.Module):
    """MRF residual block: per dilation, lrelu -> dilated conv -> lrelu ->
    conv -> + residual."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations: Tuple[int, ...] = (1, 3, 5)):
        super().__init__()
        self.convs1 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, dilation=d,
                      padding=d * (kernel_size - 1) // 2)
            for d in dilations
        )
        self.convs2 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, padding=(kernel_size - 1) // 2)
            for _ in dilations
        )

    def forward(self, x):
        for c1, c2 in zip(self.convs1, self.convs2):
            x = c2(leaky_relu(c1(leaky_relu(x)))) + x
        return x


class HiFiGANGenerator(nn.Module):
    """Stock mel->wav generator; defaults follow the reference's
    `hifigan-config.json` (512 initial channels, rates (8, 8, 2, 2), kernels
    (16, 16, 4, 4), MRF kernels (3, 7, 11) x dilations (1, 3, 5))."""

    def __init__(self, upsample_rates=(8, 8, 2, 2), upsample_kernel_sizes=(16, 16, 4, 4),
                 upsample_initial_channel: int = 512, resblock_kernel_sizes=(3, 7, 11),
                 resblock_dilation_sizes=((1, 3, 5), (1, 3, 5), (1, 3, 5)), n_mels: int = 80):
        super().__init__()
        self.num_kernels = len(resblock_kernel_sizes)
        c0 = upsample_initial_channel
        self.conv_pre = nn.Conv1d(n_mels, c0, 7, padding=3)
        self.ups = nn.ModuleList(
            ConvTranspose1dTorch(c0 // 2**i, c0 // 2 ** (i + 1), k, u, padding=(k - u) // 2)
            for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes))
        )
        self.resblocks = nn.ModuleList(
            ResBlock(c0 // 2 ** (i + 1), rk, tuple(rd))
            for i in range(len(upsample_rates))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes)
        )
        self.conv_post = nn.Conv1d(c0 // 2 ** len(upsample_rates), 1, 7, padding=3)

    def forward(self, mel):
        """mel (B, T, 80) -> wav (B, T * prod(rates), 1) in [-1, 1]."""
        x = self.conv_pre(mel.transpose(1, 2))
        n = self.num_kernels
        for i, up in enumerate(self.ups):
            x = up(leaky_relu(x))
            x = sum(self.resblocks[i * n + j](x) for j in range(n)) / n
        x = self.conv_post(F.leaky_relu(x, 0.01))  # torch LeakyReLU() default slope
        return torch.tanh(x).transpose(1, 2)


def build_vocoder(device="cuda", seed: int = 1, **kwargs) -> HiFiGANGenerator:
    """A HiFiGANGenerator with random weights drawn from `seed` (on the
    CPU), moved to `device`, in eval mode."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        voc = HiFiGANGenerator(**kwargs)
    return voc.to(resolve(device)).eval()
