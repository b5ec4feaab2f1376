"""Text encoder with duration prediction (port of the `kind="text"` branch
of `arttts_tpu/models/encoder.py:Encoder`).

Symbol embedding scaled by sqrt(C) -> masked prenet -> relative-position
transformer -> `proj_m` (mu) and the duration predictor `proj_w`, which
sees the transformer's features detached (as the JAX encoder's
`stop_gradient` and the reference's `text_encoder.py:433`): the duration
loss trains the predictor only. Dropout rates are `EncoderConfig.dropout`
(transformer, duration predictor) and `prenet_dropout`. Public layout is
the JAX package's: mu `(B, T, n_feats)`, logw and mask `(B, T, 1)`.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from arttts_tpu_torch.core.config import EncoderConfig
from arttts_tpu_torch.models.layers import ConvReluNorm, DurationPredictor, TransformerEncoder
from arttts_tpu_torch.ops.shape import sequence_mask


class TextEncoder(nn.Module):
    def __init__(self, config: EncoderConfig, n_feats: int):
        super().__init__()
        c = config
        if c.kind != "text" or not c.use_duration_predictor:
            raise NotImplementedError(
                "the port serves the text encoder with a duration predictor only"
            )
        self.n_channels = c.n_channels
        self.emb = nn.Embedding(c.n_vocab, c.n_channels)
        nn.init.normal_(self.emb.weight, 0.0, c.n_channels**-0.5)
        self.prenet = ConvReluNorm(c.n_channels, c.n_channels, c.n_channels,
                                   c.prenet_kernel, c.prenet_layers, c.prenet_dropout)
        self.encoder = TransformerEncoder(c.n_channels, c.filter_channels, c.n_heads,
                                          c.n_layers, c.kernel_size, c.window_size, c.dropout)
        self.proj_m = nn.Conv1d(c.n_channels, n_feats, 1)
        self.proj_w = DurationPredictor(c.n_channels, c.filter_channels_dp, c.kernel_size,
                                        c.dropout)

    def forward(self, x, x_lengths, generator=None):
        """x: (B, T) symbol ids; returns (mu (B,T,F), logw (B,T,1), mask (B,T,1)).
        `generator` draws the dropout masks in training mode."""
        h = (self.emb(x) * math.sqrt(self.n_channels)).transpose(1, 2)  # (B, C, T)
        x_mask = sequence_mask(x_lengths, x.shape[1]).to(h.dtype)[:, None, :]
        h = self.prenet(h, x_mask, generator)
        h = self.encoder(h, x_mask, generator)
        mu = self.proj_m(h) * x_mask
        logw = self.proj_w(h.detach(), x_mask, generator)
        return mu.transpose(1, 2), logw.transpose(1, 2), x_mask.transpose(1, 2)
