"""Plain reference of the two vocoders: HiFi-GAN V1 (Kong et al. 2020,
arXiv:2010.05646; mel -> 22.05 kHz wav) and SPARC's FiLM HiFi-GAN (Cho et
al. 2024, arXiv:2406.12998; 14 articulatory channels + a speaker vector ->
16 kHz wav), as plain convolutions in float32, weight norm folded. Also
the fixed-window chunked vocoding the port stitches long tracks with.
State-dict names are the port's; the module imports nothing of it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LRELU = 0.1


def lrelu(x, slope=LRELU):
    return F.leaky_relu(x, slope)


class ResBlock(nn.Module):
    def __init__(self, c, k, dilations):
        super().__init__()
        self.convs1 = nn.ModuleList(nn.Conv1d(c, c, k, dilation=d, padding=d * (k - 1) // 2)
                                    for d in dilations)
        self.convs2 = nn.ModuleList(nn.Conv1d(c, c, k, padding=(k - 1) // 2) for _ in dilations)

    def forward(self, x):
        for c1, c2 in zip(self.convs1, self.convs2):
            x = c2(lrelu(c1(lrelu(x)))) + x
        return x


class HiFiGAN(nn.Module):
    def __init__(self, rates, kernels, c0, rk, rd, n_mels):
        super().__init__()
        self.n = len(rk)
        self.conv_pre = nn.Conv1d(n_mels, c0, 7, padding=3)
        self.ups = nn.ModuleList(
            nn.ConvTranspose1d(c0 // 2 ** i, c0 // 2 ** (i + 1), k, u, padding=(k - u) // 2)
            for i, (u, k) in enumerate(zip(rates, kernels)))
        self.resblocks = nn.ModuleList(ResBlock(c0 // 2 ** (i + 1), k, tuple(d))
                                       for i in range(len(rates)) for k, d in zip(rk, rd))
        self.conv_post = nn.Conv1d(c0 // 2 ** len(rates), 1, 7, padding=3)

    def forward(self, mel):
        """(B, T, 80) -> (B, T * 256)."""
        x = self.conv_pre(mel.transpose(1, 2))
        for i, up in enumerate(self.ups):
            x = up(lrelu(x))
            x = sum(self.resblocks[i * self.n + j](x) for j in range(self.n)) / self.n
        return torch.tanh(self.conv_post(F.leaky_relu(x, 0.01)))[:, 0]


class SoftClamp(nn.Module):
    def forward(self, x):
        return torch.tanh(x * 0.2) / 0.2


class FiLMResBlock(nn.Module):
    def __init__(self, c, k, dilations, e):
        super().__init__()
        self.convs1 = nn.ModuleList(
            nn.Sequential(nn.LeakyReLU(LRELU),
                          nn.Conv1d(c, c, k, dilation=d, padding=d * (k - 1) // 2))
            for d in dilations)
        self.convs2 = nn.ModuleList(
            nn.Sequential(nn.LeakyReLU(LRELU), nn.Conv1d(c, c, k, padding=(k - 1) // 2))
            for _ in dilations)
        self.films = nn.ModuleList(
            nn.Sequential(nn.Linear(e, c), nn.ReLU(), nn.Identity(), nn.Linear(c, 2 * c),
                          SoftClamp())
            for _ in dilations)

    def forward(self, x, spk):
        for c1, c2, film in zip(self.convs1, self.convs2, self.films):
            f = film(spk)
            C = f.shape[-1] // 2
            x = c2(c1(x)) * f[:, :C, None] + f[:, C:, None] + x
        return x


class SparcGenerator(nn.Module):
    def __init__(self, c_in, c0, k, scales, kernels, rk, rd, e, pitch_axis,
                 pitch_offset, pitch_rescale):
        super().__init__()
        self.n = len(rk)
        self.pitch = (pitch_axis, pitch_offset, pitch_rescale)
        pad = (k - 1) // 2
        self.input_conv = nn.Conv1d(c_in, c0, k, padding=pad)
        self.upsamples = nn.ModuleList(
            nn.Sequential(nn.LeakyReLU(LRELU),
                          nn.ConvTranspose1d(c0 // 2 ** i, c0 // 2 ** (i + 1), kk, u,
                                             padding=u // 2 + u % 2, output_padding=u % 2))
            for i, (u, kk) in enumerate(zip(scales, kernels)))
        self.blocks = nn.ModuleList(FiLMResBlock(c0 // 2 ** (i + 1), kk, tuple(d), e)
                                    for i in range(len(scales)) for kk, d in zip(rk, rd))
        self.output_conv = nn.Sequential(nn.LeakyReLU(0.01),
                                         nn.Conv1d(c0 // 2 ** len(scales), 1, k, padding=pad),
                                         nn.Tanh())

    def forward(self, c, spk):
        c = c.transpose(1, 2).clone()
        p, off, scale = self.pitch
        c[:, p] = (c[:, p] - off) * scale
        x = self.input_conv(c)
        for i, up in enumerate(self.upsamples):
            x = up(x)
            x = sum(self.blocks[i * self.n + j](x, spk) for j in range(self.n)) / self.n
        return self.output_conv(x)[:, 0]


class SpeakerMLP(nn.Module):
    def __init__(self, c_in, c_out):
        super().__init__()
        self.spk_fc = nn.Sequential(nn.Linear(c_in, c_in), nn.GELU(), nn.Identity(),
                                    nn.Linear(c_in, c_out))

    def forward(self, x):
        return self.spk_fc(x)


class SpkSparc(nn.Module):
    def __init__(self, v: dict):
        super().__init__()
        self.spk_ft = SpeakerMLP(v["spk_ft_size"], v["spk_emb_size"])
        self.generator = SparcGenerator(
            v["in_channels"], v["channels"], v["kernel_size"], v["upsample_scales"],
            v["upsample_kernel_sizes"], v["resblock_kernel_sizes"], v["resblock_dilations"],
            v["spk_emb_size"], v["pitch_axis"], v["pitch_offset"], v["pitch_rescale"])

    def forward(self, c, spk_ft):
        return self.generator(c, self.spk_ft(spk_ft))


def build_vocoder(v: dict) -> nn.Module:
    """The configuration file's "vocoder" group -> its module."""
    if v["kind"] == "hifigan":
        return HiFiGAN(v["upsample_rates"], v["upsample_kernel_sizes"],
                       v["upsample_initial_channel"], v["resblock_kernel_sizes"],
                       v["resblock_dilation_sizes"], v["n_mels"])
    return SpkSparc(v)


def vocode_windows(apply_fn, feats: np.ndarray, chunk: int, halo: int, win_batch: int,
                   hop: int = 256) -> np.ndarray:
    """A (T, C) track -> (T*hop,) wav through windows of one shape
    (chunk + 2*halo frames): a track no longer than a window is placed
    flush left and flush right and stitched T - min(halo, T // 2) frames in;
    a longer one is cut into chunks, each kept away from window edges that
    are not the track's own. `apply_fn` maps (B, W, C) to (B, W*hop) numpy."""
    T, C = feats.shape
    W = chunk + 2 * halo
    if T <= W:
        m = min(halo, T // 2)
        batch = np.zeros((2, W, C), feats.dtype)
        batch[0, :T] = feats
        batch[1, W - T:] = feats
        wav = apply_fn(batch)
        return np.concatenate([wav[0, : (T - m) * hop], wav[1, (W - m) * hop:]])
    n = -(-T // chunk)
    out = np.empty(T * hop, feats.dtype)
    starts = [min(max(i * chunk - halo, 0), T - W) for i in range(n)]
    for g0 in range(0, n, win_batch):
        grp = [feats[s: s + W] for s in starts[g0: g0 + win_batch]]
        nb = len(grp)
        grp += [np.zeros((W, C), feats.dtype)] * (win_batch - nb)
        wav = apply_fn(np.stack(grp))
        for j in range(nb):
            i = g0 + j
            k = min(chunk, T - i * chunk)
            l0 = i * chunk - starts[i]
            out[i * chunk * hop: (i * chunk + k) * hop] = wav[j, l0 * hop: (l0 + k) * hop]
    return out
