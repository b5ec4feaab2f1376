"""WavLM encoder, the SSL backbone of the SPARC articulatory encoder (port
of `arttts_tpu/models/wavlm.py`).

  raw wav -> strided conv feature extractor (512 ch) -> LayerNorm -> Linear
  -> (x frame_mask) + grouped positional conv -> N transformer layers with
  gated relative-position bias attention -> hidden states.

Both variants: WavLM-Large (pre-LN blocks, a LayerNorm per conv, conv bias)
and WavLM-Base (post-LN, one GroupNorm on conv 0, no conv bias). Module
names are HuggingFace's (`feature_extractor.conv_layers.{i}.conv` /
`.layer_norm`, `feature_projection.{layer_norm,projection}`,
`encoder.pos_conv_embed.conv`, `encoder.layer_norm`,
`encoder.layers.{i}.attention.{q,k,v,out}_proj`, `gru_rel_pos_linear`,
`gru_rel_pos_const`, `rel_attn_embed` (layer 0 only), `layer_norm`,
`feed_forward.{intermediate_dense,output_dense}`, `final_layer_norm`; the
map of `arttts_tpu/utils/torch_convert_wavlm.py`), so a
`transformers.WavLMModel` state dict loads through
`utils/reference_weights.py:load_hf_wavlm`.

The relative-position buckets are computed in NumPy float64, exactly as
`relative_position_buckets` computes them (a float32 log can move a bucket
at a boundary), and cached per (T, device); the bias is gathered from the
embedding on each forward. Scores of masked keys are set to float32's
minimum; the softmax runs in float32. `tap_layer=i` returns the stream
entering layer i and runs no layer from i on; the final LayerNorm of the
pre-LN variant runs only with `tap_layer=None`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from arttts_tpu_torch.models.wav2vec2 import SamePad, num_frames


@dataclasses.dataclass(frozen=True)
class WavLMConfig:
    conv_layers: Tuple[Tuple[int, int, int], ...] = (
        (512, 10, 5),
        (512, 3, 2),
        (512, 3, 2),
        (512, 3, 2),
        (512, 3, 2),
        (512, 2, 2),
        (512, 2, 2),
    )
    hidden_dim: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    ffn_dim: int = 4096
    num_buckets: int = 320
    max_distance: int = 800
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16
    # WavLM-Large: pre-LN blocks, per-conv LayerNorm, conv bias.
    stable_layer_norm: bool = True
    conv_norm: str = "layer"  # "layer" (Large) | "group" (Base)
    conv_bias: bool = True
    layer_norm_eps: float = 1e-5

    @staticmethod
    def large() -> "WavLMConfig":
        return WavLMConfig()

    @staticmethod
    def base() -> "WavLMConfig":
        return WavLMConfig(hidden_dim=768, num_layers=12, num_heads=12, ffn_dim=3072,
                           stable_layer_norm=False, conv_norm="group", conv_bias=False)


def relative_position_buckets(length: int, num_buckets: int, max_distance: int) -> np.ndarray:
    """(T, T) int32 bucket ids of the T5-style log-spaced relative-position
    embedding (a copy of the JAX package's, NumPy float64)."""
    half = num_buckets // 2
    rel = np.arange(length)[None, :] - np.arange(length)[:, None]  # mem - ctx
    out = np.where(rel > 0, half, 0).astype(np.int64)
    mag = np.abs(rel)
    max_exact = half // 2
    with np.errstate(divide="ignore"):
        log_pos = max_exact + (
            np.log(np.maximum(mag, 1) / max_exact)
            / math.log(max_distance / max_exact)
            * (half - max_exact)
        ).astype(np.int64)
    out += np.where(mag < max_exact, mag, np.minimum(log_pos, half - 1))
    return out.astype(np.int32)


class ConvLayer(nn.Module):
    """conv -> (LayerNorm over channels | GroupNorm(C, C) | nothing) -> GELU."""

    def __init__(self, c_in: int, dim: int, k: int, stride: int, bias: bool, norm: str,
                 eps: float):
        super().__init__()
        self.conv = nn.Conv1d(c_in, dim, k, stride=stride, bias=bias)
        self.norm = norm
        if norm == "layer":
            self.layer_norm = nn.LayerNorm(dim, eps=eps)
        elif norm == "group":
            self.layer_norm = nn.GroupNorm(dim, dim, eps=eps)

    def forward(self, x):  # (B, C, T)
        x = self.conv(x)
        if self.norm == "layer":
            x = self.layer_norm(x.transpose(1, 2)).transpose(1, 2)
        elif self.norm == "group":
            x = self.layer_norm(x)
        return F.gelu(x)


class FeatureExtractor(nn.Module):
    def __init__(self, c: WavLMConfig):
        super().__init__()
        layers, c_in = [], 1
        for i, (dim, k, stride) in enumerate(c.conv_layers):
            norm = "layer" if c.conv_norm == "layer" else ("group" if i == 0 else "none")
            layers.append(ConvLayer(c_in, dim, k, stride, c.conv_bias, norm, c.layer_norm_eps))
            c_in = dim
        self.conv_layers = nn.ModuleList(layers)

    def forward(self, wav):
        x = wav[:, None, :]
        for layer in self.conv_layers:
            x = layer(x)
        return x.transpose(1, 2)  # (B, frames, C)


class FeatureProjection(nn.Module):
    def __init__(self, c: WavLMConfig):
        super().__init__()
        c_feat = c.conv_layers[-1][0]
        self.layer_norm = nn.LayerNorm(c_feat, eps=c.layer_norm_eps)
        self.projection = nn.Linear(c_feat, c.hidden_dim)

    def forward(self, x):
        return self.projection(self.layer_norm(x))


class PosConvEmbed(nn.Module):
    def __init__(self, c: WavLMConfig):
        super().__init__()
        k = c.pos_conv_kernel
        self.conv = nn.Conv1d(c.hidden_dim, c.hidden_dim, k, padding=k // 2,
                              groups=c.pos_conv_groups)
        self.pad = SamePad(k)

    def forward(self, x):  # (B, T, D)
        return F.gelu(self.pad(self.conv(x.transpose(1, 2)))).transpose(1, 2)


class GatedRelPosAttention(nn.Module):
    """scores = q.k / sqrt(d) + gate(x) * rel_bias; the bias is a per-head
    embedding of the bucketed relative positions (owned by layer 0, shared
    by all), each layer gating it per position with sigmoid gates of its
    own hidden states."""

    def __init__(self, c: WavLMConfig, has_rel_embed: bool):
        super().__init__()
        D, H = c.hidden_dim, c.num_heads
        self.c = c
        self.q_proj = nn.Linear(D, D)
        self.k_proj = nn.Linear(D, D)
        self.v_proj = nn.Linear(D, D)
        self.out_proj = nn.Linear(D, D)
        self.gru_rel_pos_linear = nn.Linear(D // H, 8)
        self.gru_rel_pos_const = nn.Parameter(torch.ones(1, H, 1, 1))
        if has_rel_embed:
            self.rel_attn_embed = nn.Embedding(c.num_buckets, H)
            nn.init.normal_(self.rel_attn_embed.weight, std=0.02)
        self._buckets: Dict[tuple, torch.Tensor] = {}

    def position_bias(self, T: int, device) -> torch.Tensor:
        """(H, T, T) bias of layer 0's embedding."""
        key = (T, torch.device(device))
        if key not in self._buckets:
            self._buckets[key] = torch.from_numpy(relative_position_buckets(
                T, self.c.num_buckets, self.c.max_distance).astype(np.int64)).to(device)
        return self.rel_attn_embed(self._buckets[key]).permute(2, 0, 1)

    def forward(self, x, pos_bias, key_mask):
        B, T, D = x.shape
        H = self.c.num_heads
        dh = D // H
        if pos_bias is None:
            pos_bias = self.position_bias(T, x.device)
        q = self.q_proj(x).view(B, T, H, dh)
        k = self.k_proj(x).view(B, T, H, dh)
        v = self.v_proj(x).view(B, T, H, dh)
        gp = self.gru_rel_pos_linear(x.view(B, T, H, dh)).view(B, T, H, 2, 4).sum(-1)
        gates = torch.sigmoid(gp)  # (B, T, H, 2)
        gate = gates[..., 0] * (gates[..., 1] * self.gru_rel_pos_const.view(H) - 1.0) + 2.0
        gated_bias = gate.permute(0, 2, 1)[..., None] * pos_bias[None]  # (B, H, Tq, Tk)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh) + gated_bias
        if key_mask is not None:
            scores = scores.masked_fill(~key_mask[:, None, None, :],
                                        torch.finfo(scores.dtype).min)
        probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, T, D)
        return self.out_proj(out), pos_bias


class FeedForward(nn.Module):
    def __init__(self, c: WavLMConfig):
        super().__init__()
        self.intermediate_dense = nn.Linear(c.hidden_dim, c.ffn_dim)
        self.output_dense = nn.Linear(c.ffn_dim, c.hidden_dim)

    def forward(self, x):
        return self.output_dense(F.gelu(self.intermediate_dense(x)))


class WavLMLayer(nn.Module):
    def __init__(self, c: WavLMConfig, has_rel_embed: bool):
        super().__init__()
        self.stable = c.stable_layer_norm
        self.attention = GatedRelPosAttention(c, has_rel_embed)
        self.layer_norm = nn.LayerNorm(c.hidden_dim, eps=c.layer_norm_eps)
        self.feed_forward = FeedForward(c)
        self.final_layer_norm = nn.LayerNorm(c.hidden_dim, eps=c.layer_norm_eps)

    def forward(self, x, pos_bias, key_mask):
        if self.stable:  # pre-LN (Large)
            a, pos_bias = self.attention(self.layer_norm(x), pos_bias, key_mask)
            x = x + a
            return x + self.feed_forward(self.final_layer_norm(x)), pos_bias
        a, pos_bias = self.attention(x, pos_bias, key_mask)  # post-LN (Base)
        x = self.layer_norm(x + a)
        return self.final_layer_norm(x + self.feed_forward(x)), pos_bias


class Encoder(nn.Module):
    def __init__(self, c: WavLMConfig):
        super().__init__()
        self.pos_conv_embed = PosConvEmbed(c)
        self.layer_norm = nn.LayerNorm(c.hidden_dim, eps=c.layer_norm_eps)
        self.layers = nn.ModuleList(WavLMLayer(c, i == 0) for i in range(c.num_layers))


class WavLMEncoder(nn.Module):
    """wav (B, T_samples) -> hidden states (B, frames, D); `frame_mask`
    (B, frames) marks the valid frames of a padded batch."""

    def __init__(self, config: WavLMConfig = WavLMConfig()):
        super().__init__()
        self.config = config
        self.feature_extractor = FeatureExtractor(config)
        self.feature_projection = FeatureProjection(config)
        self.encoder = Encoder(config)

    def forward(self, wav, frame_mask: Optional[torch.Tensor] = None,
                tap_layer: Optional[int] = None):
        c, enc = self.config, self.encoder
        h = self.feature_projection(self.feature_extractor(wav))
        if frame_mask is not None:
            h = h * frame_mask[:, :, None].to(h.dtype)
        h = h + enc.pos_conv_embed(h)
        if not c.stable_layer_norm:
            h = enc.layer_norm(h)
        key_mask = None if frame_mask is None else frame_mask.bool()
        pos_bias = None
        for layer in enc.layers[: c.num_layers if tap_layer is None else tap_layer]:
            h, pos_bias = layer(h, pos_bias, key_mask)
        if tap_layer is None and c.stable_layer_norm:
            h = enc.layer_norm(h)
        return h

    def num_frames(self, num_samples: int) -> int:
        return num_frames(self.config.conv_layers, num_samples)
