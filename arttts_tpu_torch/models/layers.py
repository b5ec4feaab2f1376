"""Encoder building blocks (port of `arttts_tpu/models/layers.py`).

PyTorch idiom inside: `(B, C, T)` tensors and `Conv1d`s, masks `(B, 1, T)`
multiplied in where the JAX modules multiply them. Parameter names are the
reference glow-tts state-dict names (`conv_layers.{i}`, `norm_layers.{i}`
with `gamma`/`beta`, `attn_layers.{i}.conv_q`, ...), which
`arttts_tpu/utils/torch_convert_acoustic.py:convert_encoder` reads.

Dropout acts where the JAX modules apply `nn.Dropout`, and only in training
mode (`module.train()`): its masks come from the `torch.Generator` passed
down the forward calls, never from the global generator. In eval mode every
forward is the same arithmetic as without dropout.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout as flax's `nn.Dropout`: keep with probability 1 - p
    and scale what is kept by 1 / (1 - p). The identity in eval mode or at
    p = 0; in training it draws its mask from `generator`."""
    if not training or p == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training mode needs a torch.Generator")
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the channel axis of (B, C, T), eps 1e-4."""

    def __init__(self, channels: int, eps: float = 1e-4):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        y = F.layer_norm(x.transpose(1, -1), (x.shape[1],), self.gamma, self.beta, self.eps)
        return y.transpose(1, -1)


class ConvReluNorm(nn.Module):
    """Masked conv prenet with a zero-initialised residual projection."""

    def __init__(self, in_channels, hidden_channels, out_channels, kernel_size=5, n_layers=3,
                 p_dropout: float = 0.5):
        super().__init__()
        self.p_dropout = p_dropout
        self.conv_layers = nn.ModuleList(
            nn.Conv1d(in_channels if i == 0 else hidden_channels, hidden_channels,
                      kernel_size, padding=kernel_size // 2)
            for i in range(n_layers)
        )
        self.norm_layers = nn.ModuleList(ChannelLayerNorm(hidden_channels) for _ in range(n_layers))
        self.proj = nn.Conv1d(hidden_channels, out_channels, 1)
        nn.init.zeros_(self.proj.weight)
        nn.init.zeros_(self.proj.bias)

    def forward(self, x, x_mask, generator=None):
        h = x
        for conv, norm in zip(self.conv_layers, self.norm_layers):
            h = torch.relu(norm(conv(h * x_mask)))
            h = dropout(h, self.p_dropout, self.training, generator)
        return (x + self.proj(h)) * x_mask


class DurationPredictor(nn.Module):
    """Two masked convs with ReLU + LayerNorm, then a 1-channel projection."""

    def __init__(self, in_channels, filter_channels, kernel_size=3, p_dropout: float = 0.1):
        super().__init__()
        self.p_dropout = p_dropout
        self.conv_1 = nn.Conv1d(in_channels, filter_channels, kernel_size, padding=kernel_size // 2)
        self.norm_1 = ChannelLayerNorm(filter_channels)
        self.conv_2 = nn.Conv1d(filter_channels, filter_channels, kernel_size,
                                padding=kernel_size // 2)
        self.norm_2 = ChannelLayerNorm(filter_channels)
        self.proj = nn.Conv1d(filter_channels, 1, 1)

    def forward(self, x, x_mask, generator=None):
        h = self.norm_1(torch.relu(self.conv_1(x * x_mask)))
        h = dropout(h, self.p_dropout, self.training, generator)
        h = self.norm_2(torch.relu(self.conv_2(h * x_mask)))
        h = dropout(h, self.p_dropout, self.training, generator)
        return self.proj(h * x_mask) * x_mask


def _rel_to_abs(x):
    """(B, H, L, 2L-1) relative-keyed logits -> (B, H, L, L) absolute."""
    b, h, l, _ = x.shape
    x = F.pad(x, (0, 1)).reshape(b, h, l * 2 * l)
    x = F.pad(x, (0, l - 1)).reshape(b, h, l + 1, 2 * l - 1)
    return x[:, :, :l, l - 1:]


def _abs_to_rel(x):
    """(B, H, L, L) attention weights -> (B, H, L, 2L-1) relative-keyed."""
    b, h, l, _ = x.shape
    x = F.pad(x, (0, l - 1)).reshape(b, h, l * l + l * (l - 1))
    x = F.pad(x, (l, 0)).reshape(b, h, l, 2 * l)
    return x[:, :, :, 1:]


class RelPositionMultiHeadAttention(nn.Module):
    """Self-attention with a windowed relative-position bias shared by the
    heads (window 4); out-of-window offsets contribute zero."""

    def __init__(self, channels, out_channels, n_heads, window_size: Optional[int] = 4,
                 p_dropout: float = 0.0):
        super().__init__()
        self.p_dropout = p_dropout
        self.n_heads = n_heads
        self.k_channels = channels // n_heads
        self.window_size = window_size
        self.conv_q = nn.Conv1d(channels, channels, 1)
        self.conv_k = nn.Conv1d(channels, channels, 1)
        self.conv_v = nn.Conv1d(channels, channels, 1)
        self.conv_o = nn.Conv1d(channels, out_channels, 1)
        for conv in (self.conv_q, self.conv_k, self.conv_v, self.conv_o):
            nn.init.xavier_uniform_(conv.weight)
            nn.init.zeros_(conv.bias)
        if window_size is not None:
            std = self.k_channels**-0.5
            self.emb_rel_k = nn.Parameter(torch.randn(1, 2 * window_size + 1, self.k_channels) * std)
            self.emb_rel_v = nn.Parameter(torch.randn(1, 2 * window_size + 1, self.k_channels) * std)

    def _expand_rel(self, emb, length):
        """Centre-crop or zero-pad the (2w+1) table to 2*length-1 entries."""
        w = self.window_size
        pad = max(length - (w + 1), 0)
        start = max((w + 1) - length, 0)
        padded = F.pad(emb, (0, 0, pad, pad))
        return padded[:, start:start + 2 * length - 1]

    def forward(self, x, attn_mask=None, generator=None):
        B, C, L = x.shape
        H, D = self.n_heads, self.k_channels

        def heads(t):  # (B, C, L) -> (B, H, L, D)
            return t.reshape(B, H, D, L).transpose(2, 3)

        q, k, v = heads(self.conv_q(x)), heads(self.conv_k(x)), heads(self.conv_v(x))
        scores = q @ k.transpose(-1, -2) / math.sqrt(D)
        if self.window_size is not None:
            rel_k = self._expand_rel(self.emb_rel_k, L)
            rel_logits = torch.einsum("bhld,gmd->bhlm", q, rel_k)
            scores = scores + _rel_to_abs(rel_logits) / math.sqrt(D)
        if attn_mask is not None:
            scores = scores.masked_fill(attn_mask == 0, -1e4)
        p_attn = torch.softmax(scores, dim=-1)
        p_attn = dropout(p_attn, self.p_dropout, self.training, generator)
        out = p_attn @ v
        if self.window_size is not None:
            rel_v = self._expand_rel(self.emb_rel_v, L)
            out = out + torch.einsum("bhlm,gmd->bhld", _abs_to_rel(p_attn), rel_v)
        return self.conv_o(out.transpose(2, 3).reshape(B, C, L))


class FFN(nn.Module):
    """Masked two-conv feed-forward."""

    def __init__(self, in_channels, out_channels, filter_channels, kernel_size=3,
                 p_dropout: float = 0.0):
        super().__init__()
        self.p_dropout = p_dropout
        self.conv_1 = nn.Conv1d(in_channels, filter_channels, kernel_size, padding=kernel_size // 2)
        self.conv_2 = nn.Conv1d(filter_channels, out_channels, kernel_size,
                                padding=kernel_size // 2)

    def forward(self, x, x_mask, generator=None):
        h = torch.relu(self.conv_1(x * x_mask))
        h = dropout(h, self.p_dropout, self.training, generator)
        return self.conv_2(h * x_mask) * x_mask


class TransformerEncoder(nn.Module):
    """Post-norm transformer stack with relative-position attention."""

    def __init__(self, hidden_channels, filter_channels, n_heads, n_layers, kernel_size=3,
                 window_size: Optional[int] = 4, p_dropout: float = 0.0):
        super().__init__()
        self.p_dropout = p_dropout
        self.attn_layers = nn.ModuleList(
            RelPositionMultiHeadAttention(hidden_channels, hidden_channels, n_heads, window_size,
                                          p_dropout)
            for _ in range(n_layers)
        )
        self.norm_layers_1 = nn.ModuleList(ChannelLayerNorm(hidden_channels) for _ in range(n_layers))
        self.ffn_layers = nn.ModuleList(
            FFN(hidden_channels, hidden_channels, filter_channels, kernel_size, p_dropout)
            for _ in range(n_layers)
        )
        self.norm_layers_2 = nn.ModuleList(ChannelLayerNorm(hidden_channels) for _ in range(n_layers))

    def forward(self, x, x_mask, generator=None):
        attn_mask = x_mask[:, :, :, None] * x_mask[:, :, None, :]  # (B, 1, L, L)
        p, on = self.p_dropout, self.training
        for attn, n1, ffn, n2 in zip(self.attn_layers, self.norm_layers_1, self.ffn_layers,
                                     self.norm_layers_2):
            x = x * x_mask
            x = n1(x + dropout(attn(x, attn_mask, generator), p, on, generator))
            x = n2(x + dropout(ffn(x, x_mask, generator), p, on, generator))
        return x * x_mask
