"""GradTTS acoustic model (port of `arttts_tpu/models/tts.py:GradTTSModel`
for the single-speaker text encoder and the 2D U-Net decoder).

The module holds the parameters and the submodule forwards; sampling is
`arttts_tpu_torch/infer/sampler.py`, the training loss
`arttts_tpu_torch/train/losses.py` (in training mode, with the encoder's
dropout drawn from the generator `encode` is given). State-dict names are
the reference's: `encoder.*` and `decoder.estimator.*`.
"""

from __future__ import annotations

import torch
from torch import nn

from arttts_tpu_torch.core.config import ModelConfig
from arttts_tpu_torch.core.device import resolve
from arttts_tpu_torch.models.encoder import TextEncoder
from arttts_tpu_torch.models.unet2d import GradLogPEstimator2d


class Diffusion(nn.Module):
    """Holds the score estimator (the reference's `decoder`)."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        d = config.decoder
        if d.kind != "unet2d" or d.compute_dtype != "float32":
            raise NotImplementedError("the port serves the float32 2D U-Net decoder only")
        self.estimator = GradLogPEstimator2d(
            dim=d.dim, dim_mults=tuple(d.dim_mults), groups=d.groups, n_spks=config.n_spks,
            spk_emb_dim=config.spk_emb_dim, n_feats=config.n_feats, pe_scale=d.pe_scale,
            masked_norm=d.masked_norm,
        )


class GradTTSModel(nn.Module):
    """Text encoder + diffusion score estimator."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.config = config
        self.encoder = TextEncoder(config.encoder, config.n_feats)
        self.decoder = Diffusion(config)

    def encode(self, x, x_lengths, generator=None):
        """(mu_x (B, T, F), logw (B, T, 1), x_mask (B, T, 1)); `generator`
        draws the dropout masks in training mode."""
        return self.encoder(x, x_lengths, generator)

    def estimate_noise(self, xt, mask, mu, t):
        """Score-network forward on the module path (B, T, F)."""
        return self.decoder.estimator(xt, mask, mu, t)


def build_model(config: ModelConfig, device="cuda", seed: int = 0) -> GradTTSModel:
    """A GradTTSModel with random weights drawn from `seed` (on the CPU, so
    the weights do not depend on the device), moved to `device`, in eval mode
    (serving); the trainer switches it to training mode."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = GradTTSModel(config)
    return model.to(resolve(device)).eval()
