"""Plain reference of the text / phone-feature encoder of Grad-TTS
(Popov et al. 2021) as the port runs it: a masked conv prenet, a
relative-position transformer (glow-tts), the mean projection and the
duration predictor. Layout (B, C, T) inside, (B, T, C) at `Encoder.forward`.

A frozen copy of the module path the port serves and trains, written for
this benchmark; it imports nothing of the port. State-dict names are the
port's, so one set of seeded tensors loads into both. Dropout draws its
masks from the `torch.Generator` handed down, in the order the module path
draws them, so a training step replays the program's masks exactly.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    pos = torch.arange(max_length, device=lengths.device, dtype=lengths.dtype)
    return pos[None, :] < lengths[:, None]


def dropout(x, p: float, training: bool, generator: Optional[torch.Generator]):
    """Inverted dropout: keep with probability 1 - p, scaled by 1 / (1 - p)."""
    if not training or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


class ChannelLayerNorm(nn.Module):
    def __init__(self, channels: int, eps: float = 1e-4):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        y = F.layer_norm(x.transpose(1, -1), (x.shape[1],), self.gamma, self.beta, self.eps)
        return y.transpose(1, -1)


class ConvReluNorm(nn.Module):
    def __init__(self, c_in, hidden, c_out, kernel, n_layers, p_dropout):
        super().__init__()
        self.p_dropout = p_dropout
        self.conv_layers = nn.ModuleList(
            nn.Conv1d(c_in if i == 0 else hidden, hidden, kernel, padding=kernel // 2)
            for i in range(n_layers))
        self.norm_layers = nn.ModuleList(ChannelLayerNorm(hidden) for _ in range(n_layers))
        self.proj = nn.Conv1d(hidden, c_out, 1)

    def forward(self, x, x_mask, generator=None):
        h = x
        for conv, norm in zip(self.conv_layers, self.norm_layers):
            h = torch.relu(norm(conv(h * x_mask)))
            h = dropout(h, self.p_dropout, self.training, generator)
        return (x + self.proj(h)) * x_mask


class DurationPredictor(nn.Module):
    def __init__(self, c_in, filters, kernel, p_dropout):
        super().__init__()
        self.p_dropout = p_dropout
        self.conv_1 = nn.Conv1d(c_in, filters, kernel, padding=kernel // 2)
        self.norm_1 = ChannelLayerNorm(filters)
        self.conv_2 = nn.Conv1d(filters, filters, kernel, padding=kernel // 2)
        self.norm_2 = ChannelLayerNorm(filters)
        self.proj = nn.Conv1d(filters, 1, 1)

    def forward(self, x, x_mask, generator=None):
        h = self.norm_1(torch.relu(self.conv_1(x * x_mask)))
        h = dropout(h, self.p_dropout, self.training, generator)
        h = self.norm_2(torch.relu(self.conv_2(h * x_mask)))
        h = dropout(h, self.p_dropout, self.training, generator)
        return self.proj(h * x_mask) * x_mask


def _rel_to_abs(x):
    b, h, l, _ = x.shape
    x = F.pad(x, (0, 1)).reshape(b, h, l * 2 * l)
    x = F.pad(x, (0, l - 1)).reshape(b, h, l + 1, 2 * l - 1)
    return x[:, :, :l, l - 1:]


def _abs_to_rel(x):
    b, h, l, _ = x.shape
    x = F.pad(x, (0, l - 1)).reshape(b, h, l * l + l * (l - 1))
    x = F.pad(x, (l, 0)).reshape(b, h, l, 2 * l)
    return x[:, :, :, 1:]


class RelPositionMultiHeadAttention(nn.Module):
    def __init__(self, channels, n_heads, window_size, p_dropout):
        super().__init__()
        self.p_dropout = p_dropout
        self.n_heads = n_heads
        self.k_channels = channels // n_heads
        self.window_size = window_size
        self.conv_q = nn.Conv1d(channels, channels, 1)
        self.conv_k = nn.Conv1d(channels, channels, 1)
        self.conv_v = nn.Conv1d(channels, channels, 1)
        self.conv_o = nn.Conv1d(channels, channels, 1)
        self.emb_rel_k = nn.Parameter(torch.zeros(1, 2 * window_size + 1, self.k_channels))
        self.emb_rel_v = nn.Parameter(torch.zeros(1, 2 * window_size + 1, self.k_channels))

    def _expand_rel(self, emb, length):
        w = self.window_size
        pad = max(length - (w + 1), 0)
        start = max((w + 1) - length, 0)
        return F.pad(emb, (0, 0, pad, pad))[:, start:start + 2 * length - 1]

    def forward(self, x, attn_mask, generator=None):
        B, C, L = x.shape
        H, D = self.n_heads, self.k_channels

        def heads(t):
            return t.reshape(B, H, D, L).transpose(2, 3)

        q, k, v = heads(self.conv_q(x)), heads(self.conv_k(x)), heads(self.conv_v(x))
        scores = q @ k.transpose(-1, -2) / math.sqrt(D)
        rel_logits = torch.einsum("bhld,gmd->bhlm", q, self._expand_rel(self.emb_rel_k, L))
        scores = scores + _rel_to_abs(rel_logits) / math.sqrt(D)
        scores = scores.masked_fill(attn_mask == 0, -1e4)
        p_attn = torch.softmax(scores, dim=-1)
        p_attn = dropout(p_attn, self.p_dropout, self.training, generator)
        out = p_attn @ v
        out = out + torch.einsum("bhlm,gmd->bhld", _abs_to_rel(p_attn),
                                 self._expand_rel(self.emb_rel_v, L))
        return self.conv_o(out.transpose(2, 3).reshape(B, C, L))


class FFN(nn.Module):
    def __init__(self, channels, filters, kernel, p_dropout):
        super().__init__()
        self.p_dropout = p_dropout
        self.conv_1 = nn.Conv1d(channels, filters, kernel, padding=kernel // 2)
        self.conv_2 = nn.Conv1d(filters, channels, kernel, padding=kernel // 2)

    def forward(self, x, x_mask, generator=None):
        h = torch.relu(self.conv_1(x * x_mask))
        h = dropout(h, self.p_dropout, self.training, generator)
        return self.conv_2(h * x_mask) * x_mask


class TransformerEncoder(nn.Module):
    def __init__(self, channels, filters, n_heads, n_layers, kernel, window, p_dropout):
        super().__init__()
        self.p_dropout = p_dropout
        self.attn_layers = nn.ModuleList(
            RelPositionMultiHeadAttention(channels, n_heads, window, p_dropout)
            for _ in range(n_layers))
        self.norm_layers_1 = nn.ModuleList(ChannelLayerNorm(channels) for _ in range(n_layers))
        self.ffn_layers = nn.ModuleList(FFN(channels, filters, kernel, p_dropout)
                                        for _ in range(n_layers))
        self.norm_layers_2 = nn.ModuleList(ChannelLayerNorm(channels) for _ in range(n_layers))

    def forward(self, x, x_mask, generator=None):
        attn_mask = x_mask[:, :, :, None] * x_mask[:, :, None, :]
        p, on = self.p_dropout, self.training
        for attn, n1, ffn, n2 in zip(self.attn_layers, self.norm_layers_1, self.ffn_layers,
                                     self.norm_layers_2):
            x = x * x_mask
            x = n1(x + dropout(attn(x, attn_mask, generator), p, on, generator))
            x = n2(x + dropout(ffn(x, x_mask, generator), p, on, generator))
        return x * x_mask


class Encoder(nn.Module):
    """`enc` is the configuration file's "encoder" group."""

    def __init__(self, enc: dict, n_feats: int, n_spks: int, spk_emb_dim: int):
        super().__init__()
        self.kind = enc["kind"]
        self.n_channels = enc["n_channels"]
        if self.kind == "text":
            self.emb = nn.Embedding(enc["n_vocab"], enc["n_channels"])
            width = enc["n_channels"]
        else:
            width = enc["n_input_feats"]
        self.prenet = ConvReluNorm(width, enc["n_channels"], width, enc["prenet_kernel"],
                                   enc["prenet_layers"], enc["prenet_dropout"])
        self.n_spks = n_spks
        if n_spks > 1:
            width += spk_emb_dim
        self.encoder = TransformerEncoder(width, enc["filter_channels"], enc["n_heads"],
                                          enc["n_layers"], enc["kernel_size"],
                                          enc["window_size"], enc["dropout"])
        self.proj_m = nn.Conv1d(width, n_feats, 1)
        self.proj_w = (DurationPredictor(width, enc["filter_channels_dp"], enc["kernel_size"],
                                         enc["dropout"])
                       if enc["use_duration_predictor"] else None)

    def forward(self, x, x_lengths, generator=None, spk=None):
        """-> mu (B, T, F), logw (B, T, 1), mask (B, T, 1)."""
        if self.kind == "text":
            h = (self.emb(x) * math.sqrt(self.n_channels)).transpose(1, 2)
        else:
            h = x.float().transpose(1, 2)
        x_mask = sequence_mask(x_lengths, h.shape[2]).to(h.dtype)[:, None, :]
        h = self.prenet(h, x_mask, generator)
        if self.n_spks > 1:
            h = torch.cat([h, spk[:, :, None].expand(-1, -1, h.shape[2])], dim=1)
        h = self.encoder(h, x_mask, generator)
        mu = self.proj_m(h) * x_mask
        if self.proj_w is None:
            logw = torch.zeros_like(x_mask)
        else:
            logw = self.proj_w(h.detach(), x_mask, generator)
        return mu.transpose(1, 2), logw.transpose(1, 2), x_mask.transpose(1, 2)
