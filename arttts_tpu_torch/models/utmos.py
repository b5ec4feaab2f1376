"""UTMOS MOS predictor (port of `arttts_tpu/models/utmos.py`, the reference's
UTMOS strong learner): wav2vec2-base SSL features + DomainEmbedding(3, 128)
+ judge-conditioned BiLSTM (3000 judges, judge_dim 128, hidden 512 a
direction) + MLP projection 1024 -> 2048 ReLU -> 1. The score is the frame
mean x 2 + 3 with domain 0 and judge 288.

Module names are the lightning checkpoint's (`feature_extractors.0.ssl_model.*`,
`feature_extractors.1.embedding`, `output_layers.0.{judge_embedding,
decoder_rnn}`, `output_layers.1.net.{0,3}`; the map of
`arttts_tpu/utils/torch_convert_utmos.py:convert_utmos`). Dropout 0.3 acts
only in training mode; `build_utmos` returns the module in eval mode.
"""

from __future__ import annotations

import torch
from torch import nn

from arttts_tpu_torch.core.device import resolve
from arttts_tpu_torch.models.lstm import BiLSTM
from arttts_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Encoder

JUDGE_ID = 288  # the fixed judge of the reference's scoring protocol (score.py:53-61)


class SSLModel(nn.Module):
    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        self.ssl_model = Wav2Vec2Encoder(config)


class DomainEmbedding(nn.Module):
    def __init__(self, n_domains: int, dim: int):
        super().__init__()
        self.embedding = nn.Embedding(n_domains, dim)


class LDConditioner(nn.Module):
    def __init__(self, input_dim: int, num_judges: int, judge_dim: int, hidden: int):
        super().__init__()
        self.judge_embedding = nn.Embedding(num_judges, judge_dim)
        self.decoder_rnn = BiLSTM(input_dim + judge_dim, hidden)


class Projection(nn.Module):
    def __init__(self, input_dim: int, hidden: int):
        super().__init__()
        self.net = nn.Sequential(nn.Linear(input_dim, hidden), nn.ReLU(), nn.Dropout(0.3),
                                 nn.Linear(hidden, 1))


class UTMOSPredictor(nn.Module):
    def __init__(self, ssl_config: Wav2Vec2Config = Wav2Vec2Config(), n_domains: int = 3,
                 domain_dim: int = 128, num_judges: int = 3000, judge_dim: int = 128,
                 lstm_hidden: int = 512, projection_hidden: int = 2048):
        super().__init__()
        self.feature_extractors = nn.ModuleList([
            SSLModel(ssl_config), DomainEmbedding(n_domains, domain_dim)])
        self.output_layers = nn.ModuleList([
            LDConditioner(ssl_config.hidden_dim + domain_dim, num_judges, judge_dim,
                          lstm_hidden),
            Projection(2 * lstm_hidden, projection_hidden)])

    def forward(self, wav, domains, judge_ids):
        """wav (B, num_samples) 16 kHz; domains, judge_ids (B,) int ->
        per-frame scores (B, frames, 1)."""
        ssl = self.feature_extractors[0].ssl_model(wav)  # (B, T, 768)
        B, T, _ = ssl.shape
        cond = self.output_layers[0]
        dom = self.feature_extractors[1].embedding(domains)
        judge = cond.judge_embedding(judge_ids)
        feats = torch.cat([ssl, dom[:, None, :].expand(B, T, -1),
                           judge[:, None, :].expand(B, T, -1)], dim=-1)
        return self.output_layers[1].net(cond.decoder_rnn(feats))

    def score(self, wav):
        """MOS scores (B,): frame mean x 2 + 3, domain 0, judge 288."""
        B = wav.shape[0]
        domains = torch.zeros(B, dtype=torch.long, device=wav.device)
        judges = torch.full((B,), JUDGE_ID, dtype=torch.long, device=wav.device)
        return self(wav, domains, judges).mean(dim=1)[:, 0] * 2.0 + 3.0


def build_utmos(device="cuda", seed: int = 2, **kwargs) -> UTMOSPredictor:
    """A UTMOSPredictor with random weights drawn from `seed` (on the CPU),
    moved to `device`, in eval mode."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = UTMOSPredictor(**kwargs)
    return model.to(resolve(device)).eval()
