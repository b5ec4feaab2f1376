"""wav2vec 2.0 encoder for UTMOS MOS scoring (port of
`arttts_tpu/models/wav2vec2.py`): post-LN wav2vec2-base.

  raw wav -> 7 strided convs (512 ch, no bias; GroupNorm(512, 512) on conv 0
  only; exact GELU) -> LayerNorm -> Linear 512 -> 768 -> + grouped
  positional conv (k=128, groups=16, padding 64, the last frame dropped,
  GELU) -> LayerNorm -> 12 post-LN transformer blocks (12 heads, FFN 3072).

Module names are fairseq's, as the UTMOS checkpoint stores them under
`feature_extractors.0.ssl_model.` (`feature_extractor.conv_layers.{i}.0`,
`.conv_layers.0.2`, `layer_norm`, `post_extract_proj`, `encoder.pos_conv.0`,
`encoder.layer_norm`, `encoder.layers.{i}.self_attn.{q,k,v,out}_proj`,
`self_attn_layer_norm`, `fc1`, `fc2`, `final_layer_norm`; the map of
`arttts_tpu/utils/torch_convert_utmos.py:convert_wav2vec2`), so a reference
checkpoint loads with `load_state_dict` once its weight norm is folded
(`utils/reference_weights.py`).

Attention is plain matmul and softmax in float32, as flax's
`MultiHeadDotProductAttention` computes it (the query scaled by
1/sqrt(d_head) before the product). The convolutions and matmuls are
PyTorch's; the JAX package has no Pallas kernel on this path.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    conv_layers: Tuple[Tuple[int, int, int], ...] = (
        (512, 10, 5),
        (512, 3, 2),
        (512, 3, 2),
        (512, 3, 2),
        (512, 3, 2),
        (512, 2, 2),
        (512, 2, 2),
    )
    hidden_dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_dim: int = 3072
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16
    layer_norm_eps: float = 1e-5


def num_frames(conv_layers, num_samples: int) -> int:
    """Frames a valid strided conv stack makes of `num_samples` samples."""
    n = num_samples
    for _, k, s in conv_layers:
        n = (n - k) // s + 1
    return n


class SamePad(nn.Module):
    """Drops the trailing frame that an even kernel with k // 2 padding
    adds (fairseq's `SamePad`)."""

    def __init__(self, kernel_size: int):
        super().__init__()
        self.remove = 1 if kernel_size % 2 == 0 else 0

    def forward(self, x):
        return x[:, :, :-self.remove] if self.remove else x


class SelfAttention(nn.Module):
    """Unmasked self-attention over (B, T, D), flax's arithmetic: the query
    scaled by 1/sqrt(d_head), softmax in float32."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, T, D = x.shape
        H = self.num_heads
        q = self.q_proj(x).view(B, T, H, D // H) / math.sqrt(D // H)
        k = self.k_proj(x).view(B, T, H, D // H)
        v = self.v_proj(x).view(B, T, H, D // H)
        probs = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k).float(), dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.to(x.dtype), v).reshape(B, T, D)
        return self.out_proj(out)


class TransformerLayer(nn.Module):
    """Post-LN block (wav2vec2 base, layer_norm_first=False)."""

    def __init__(self, c: Wav2Vec2Config):
        super().__init__()
        self.self_attn = SelfAttention(c.hidden_dim, c.num_heads)
        self.self_attn_layer_norm = nn.LayerNorm(c.hidden_dim, eps=c.layer_norm_eps)
        self.fc1 = nn.Linear(c.hidden_dim, c.ffn_dim)
        self.fc2 = nn.Linear(c.ffn_dim, c.hidden_dim)
        self.final_layer_norm = nn.LayerNorm(c.hidden_dim, eps=c.layer_norm_eps)

    def forward(self, x):
        x = self.self_attn_layer_norm(x + self.self_attn(x))
        return self.final_layer_norm(x + self.fc2(F.gelu(self.fc1(x))))


class ConvFeatureExtraction(nn.Module):
    """fairseq's "default" extractor: (conv, dropout, GroupNorm, GELU) for
    conv 0, (conv, dropout, GELU) for the others; no conv bias."""

    def __init__(self, c: Wav2Vec2Config):
        super().__init__()
        layers, c_in = [], 1
        for i, (dim, k, stride) in enumerate(c.conv_layers):
            mods = [nn.Conv1d(c_in, dim, k, stride=stride, bias=False), nn.Dropout(0.0)]
            if i == 0:
                mods.append(nn.GroupNorm(dim, dim, eps=c.layer_norm_eps))
            layers.append(nn.Sequential(*mods, nn.GELU()))
            c_in = dim
        self.conv_layers = nn.ModuleList(layers)

    def forward(self, wav):
        x = wav[:, None, :]
        for layer in self.conv_layers:
            x = layer(x)
        return x.transpose(1, 2)  # (B, frames, C)


class TransformerEncoder(nn.Module):
    def __init__(self, c: Wav2Vec2Config):
        super().__init__()
        k = c.pos_conv_kernel
        self.pos_conv = nn.Sequential(
            nn.Conv1d(c.hidden_dim, c.hidden_dim, k, padding=k // 2, groups=c.pos_conv_groups),
            SamePad(k), nn.GELU())
        self.layer_norm = nn.LayerNorm(c.hidden_dim, eps=c.layer_norm_eps)
        self.layers = nn.ModuleList(TransformerLayer(c) for _ in range(c.num_layers))

    def forward(self, x):
        x = x + self.pos_conv(x.transpose(1, 2)).transpose(1, 2)
        x = self.layer_norm(x)
        for layer in self.layers:
            x = layer(x)
        return x


class Wav2Vec2Encoder(nn.Module):
    """wav (B, num_samples) 16 kHz in [-1, 1] -> (B, frames, hidden_dim)."""

    def __init__(self, config: Wav2Vec2Config = Wav2Vec2Config()):
        super().__init__()
        self.config = config
        c_feat = config.conv_layers[-1][0]
        self.feature_extractor = ConvFeatureExtraction(config)
        self.layer_norm = nn.LayerNorm(c_feat, eps=config.layer_norm_eps)
        self.post_extract_proj = nn.Linear(c_feat, config.hidden_dim)
        self.encoder = TransformerEncoder(config)

    def forward(self, wav):
        x = self.post_extract_proj(self.layer_norm(self.feature_extractor(wav)))
        return self.encoder(x)

    def num_frames(self, num_samples: int) -> int:
        return num_frames(self.config.conv_layers, num_samples)
