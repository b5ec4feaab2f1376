"""Text / IPA-trait encoder with optional duration prediction (port of
`arttts_tpu/models/encoder.py:Encoder`).

`config.kind` selects the input:
- "text": symbol ids, a learned embedding scaled by sqrt(C);
- "ipa_trait": float trait rows `(B, T, n_input_feats)`, no embedding; the
  prenet keeps the input's width so its residual holds.
Then: masked prenet -> (with n_spks > 1) the speaker embedding tiled over
T and concatenated on the channels -> relative-position transformer at
that width -> `proj_m` (mu) and, when `use_duration_predictor`, the
duration predictor `proj_w`, which sees the transformer's features
detached (as the JAX encoder's `stop_gradient` and the reference's
`text_encoder.py:433`). Aligned-input models (the v6 family) have no
`proj_w`: their logw is zero. Dropout rates are `EncoderConfig.dropout`
(transformer, duration predictor) and `prenet_dropout`. Public layout is
the JAX package's: mu `(B, T, n_feats)`, logw and mask `(B, T, 1)`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from arttts_tpu_torch.core.config import EncoderConfig
from arttts_tpu_torch.models.layers import ConvReluNorm, DurationPredictor, TransformerEncoder
from arttts_tpu_torch.ops.shape import sequence_mask


class Encoder(nn.Module):
    def __init__(self, config: EncoderConfig, n_feats: int, n_spks: int = 1,
                 spk_emb_dim: int = 64):
        super().__init__()
        c = config
        if c.kind not in ("text", "ipa_trait"):
            raise ValueError(f"unknown encoder kind {c.kind!r}")
        self.kind = c.kind
        self.n_channels = c.n_channels
        if c.kind == "text":
            self.emb = nn.Embedding(c.n_vocab, c.n_channels)
            nn.init.normal_(self.emb.weight, 0.0, c.n_channels**-0.5)
            width = c.n_channels
        else:
            width = c.n_input_feats
        self.prenet = ConvReluNorm(width, c.n_channels, width, c.prenet_kernel,
                                   c.prenet_layers, c.prenet_dropout)
        self.n_spks = n_spks
        if n_spks > 1:
            width += spk_emb_dim
        self.encoder = TransformerEncoder(width, c.filter_channels, c.n_heads, c.n_layers,
                                          c.kernel_size, c.window_size, c.dropout)
        self.proj_m = nn.Conv1d(width, n_feats, 1)
        self.proj_w = (DurationPredictor(width, c.filter_channels_dp, c.kernel_size, c.dropout)
                       if c.use_duration_predictor else None)

    def forward(self, x, x_lengths, generator=None, spk: Optional[torch.Tensor] = None):
        """x: (B, T) symbol ids or (B, T, n_input_feats) traits; spk: (B, E)
        speaker embedding (n_spks > 1). Returns (mu (B,T,F), logw (B,T,1),
        mask (B,T,1)). `generator` draws the dropout masks in training mode."""
        if self.kind == "text":
            h = (self.emb(x) * math.sqrt(self.n_channels)).transpose(1, 2)  # (B, C, T)
        else:
            h = x.float().transpose(1, 2)
        x_mask = sequence_mask(x_lengths, h.shape[2]).to(h.dtype)[:, None, :]
        h = self.prenet(h, x_mask, generator)
        if self.n_spks > 1:
            if spk is None:
                raise ValueError("a multi-speaker encoder needs speaker embeddings")
            h = torch.cat([h, spk[:, :, None].expand(-1, -1, h.shape[2])], dim=1)
        h = self.encoder(h, x_mask, generator)
        mu = self.proj_m(h) * x_mask
        if self.proj_w is None:
            logw = torch.zeros_like(x_mask)
        else:
            logw = self.proj_w(h.detach(), x_mask, generator)
        return mu.transpose(1, 2), logw.transpose(1, 2), x_mask.transpose(1, 2)
