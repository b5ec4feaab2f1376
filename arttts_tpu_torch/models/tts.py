"""GradTTS / ArtTTS / AttentionTTS / GradTTArtic acoustic model (port of
`arttts_tpu/models/tts.py:GradTTSModel`: the text and ipa_trait encoders,
the speaker paths, and the 2D U-Net, 1D U-Net and preblock decoders).

The module holds the parameters and the submodule forwards; sampling is
`arttts_tpu_torch/infer/sampler.py`, the training loss
`arttts_tpu_torch/train/losses.py` (in training mode, with the encoder's
dropout drawn from the generator `encode` is given). State-dict names are
the reference's: `encoder.*`, `decoder.estimator.*`, and for the speaker
`spk_enc.spk_fc.{0,3}` (GradTTArtic's 1024-d pre-embedding MLP) or
`spk_emb` (the embedding table of other multi-speaker models).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from arttts_tpu_torch.core.config import ModelConfig
from arttts_tpu_torch.core.device import resolve
from arttts_tpu_torch.models.encoder import Encoder
from arttts_tpu_torch.models.hifigan import SpeakerFT
from arttts_tpu_torch.models.unet1d import GradLogPEstimator1d
from arttts_tpu_torch.models.unet2d import GradLogPEstimator2d


# 1024-d SSL speaker pre-embedding -> 64-d embedding
# (model_ms/spk_encoder.py:13-24): the same MLP, with the same state-dict
# names (`spk_fc.0`, `spk_fc.3`), as the SPARC vocoder's speaker layer
SpeakerEncodingLayer = SpeakerFT


class Diffusion(nn.Module):
    """Holds the score estimator (the reference's `decoder`)."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        d = config.decoder
        kw = dict(dim=d.dim, dim_mults=tuple(d.dim_mults), groups=d.groups,
                  n_spks=config.n_spks, spk_emb_dim=config.spk_emb_dim,
                  n_feats=config.n_feats, pe_scale=d.pe_scale, masked_norm=d.masked_norm)
        if d.kind in ("unet2d", "unet1d_preblock"):
            # the reference's Diffusion1DPreblock keeps the 2D U-Net body and
            # prepends the (1, 9) channel-attention PreBlock
            self.estimator = GradLogPEstimator2d(
                **kw, use_preblock=d.kind == "unet1d_preblock",
                preblock_kernel=d.preblock_kernel, compute_dtype=d.compute_dtype)
        elif d.kind == "unet1d":
            # float32 whatever `compute_dtype` says, as the JAX 1D decoder
            self.estimator = GradLogPEstimator1d(**kw)
        else:
            raise ValueError(f"unknown decoder kind {d.kind!r}")


class GradTTSModel(nn.Module):
    """Encoder + diffusion score estimator (+ speaker embedding)."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        c = config
        self.config = c
        self.encoder = Encoder(c.encoder, c.n_feats, c.n_spks, c.spk_emb_dim)
        self.decoder = Diffusion(c)
        if c.name == "grad_ttartic":
            self.spk_enc = SpeakerEncodingLayer(c.spk_preemb_dim, c.spk_emb_dim)
        elif c.n_spks > 1:
            self.spk_emb = nn.Embedding(c.n_spks, c.spk_emb_dim)

    def embed_speaker(self, spk) -> Optional[torch.Tensor]:
        """spk: int ids (B,) for the embedding-table path, or float
        pre-embeddings (B, spk_preemb_dim) for grad_ttartic; None otherwise."""
        if spk is None:
            return None
        if self.config.name == "grad_ttartic":
            return self.spk_enc(spk.float())
        if self.config.n_spks > 1:
            return self.spk_emb(spk)
        return None

    def encode(self, x, x_lengths, spk=None, generator=None):
        """(mu_x (B, T, F), logw (B, T, 1), x_mask (B, T, 1)); spk is a raw
        speaker input; `generator` draws the dropout masks in training mode."""
        return self.encoder(x, x_lengths, generator, self.embed_speaker(spk))

    def estimate_noise(self, xt, mask, mu, t, spk=None):
        """Score-network forward on the module path (B, T, F); spk is a raw
        speaker input."""
        return self.decoder.estimator(xt, mask, mu, t, self.embed_speaker(spk))


def build_model(config: ModelConfig, device="cuda", seed: int = 0) -> GradTTSModel:
    """A GradTTSModel with random weights drawn from `seed` (on the CPU, so
    the weights do not depend on the device), moved to `device`, in eval mode
    (serving); the trainer switches it to training mode."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = GradTTSModel(config)
    return model.to(resolve(device)).eval()
