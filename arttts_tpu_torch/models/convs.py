"""Transposed convolutions in torch semantics (port of
`arttts_tpu/models/convs.py:ConvTranspose1dTorch` / `ConvTranspose2dTorch`).

The JAX package writes them as input-dilated convolutions with flipped
kernels to match torch; here they are torch's own layers, weight layout
(in, out, k[, k]) as the JAX modules store it. XLA computed these outside
any Pallas kernel, so they stay plain PyTorch calls. (The U-Net's 4x4
stride-2 instance runs as the hand-written kernel K3 on the serving path,
`ops/updown.py`, and the vocoders' stride-2, k=4 instances as K5,
`ops/upsample.py`; these modules are their plain counterparts.)
"""

from __future__ import annotations

from torch import nn


class ConvTranspose1dTorch(nn.ConvTranspose1d):
    """`nn.ConvTranspose1d`; inputs (B, C, T)."""


class ConvTranspose2dTorch(nn.ConvTranspose2d):
    """`nn.ConvTranspose2d`; inputs (B, C, H, W)."""
