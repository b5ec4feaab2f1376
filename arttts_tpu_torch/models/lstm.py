"""Bidirectional LSTM of UTMOS's judge-conditioned head (port of
`arttts_tpu/models/lstm.py`).

`torch.nn.LSTM` stores what the JAX module stores: `weight_ih_l0` (4H, I),
`weight_hh_l0` (4H, H), `bias_ih_l0`, `bias_hh_l0` and their `_reverse`
twins, gate order (i, f, g, o), so the reference's weights and the JAX
package's parameters copy over unchanged. On the card it runs cuDNN's LSTM
(the JAX package has no kernel here either: a `lax.scan`).
"""

from __future__ import annotations

from torch import nn


class BiLSTM(nn.LSTM):
    """Single-layer bidirectional LSTM over (B, T, I): (B, T, 2H), the
    forward direction's states then the backward's."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__(input_size, hidden_size, num_layers=1, batch_first=True,
                         bidirectional=True)

    def forward(self, x):
        return super().forward(x)[0]
