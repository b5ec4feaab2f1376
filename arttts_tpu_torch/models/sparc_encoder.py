"""The SPARC articulatory encoder (port of `arttts_tpu/models/sparc_encoder.py`):
acoustic-to-articulatory inversion, source features and a speaker
pre-embedding, the contract of the external coder's `encode(wav,
concat=True)`.

  * EMA channels: a linear probe (`ema_probe`, 1024 -> 12) over WavLM-Large
    stopped at its tap layer (9 of 24);
  * pitch and loudness: YIN and log-RMS (`audio/pitch.py`) on the wav padded
    by (1024 - 400) / 2 = 312 samples a side, so their frame centres fall on
    WavLM's 320-sample grid, then trimmed or edge-padded to its frame count;
  * speaker pre-embedding: the (masked) time mean of the tapped features.

Output: features (B, N, 14) = [EMA x 12, pitch, loudness] (zero on masked
frames) and spk (B, 1024). The backbone loads from a HF WavLM checkpoint
(`utils/reference_weights.py:load_hf_wavlm`), the probe from an npz
(`load_probe_npz`); without them the weights are random, drawn from a seed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from arttts_tpu_torch.audio.pitch import PitchConfig, frame_loudness, track_pitch
from arttts_tpu_torch.core.device import resolve
from arttts_tpu_torch.models.wavlm import WavLMConfig, WavLMEncoder

WAVLM_RECEPTIVE_FIELD = 400  # samples of one WavLM frame (hop 320)


@dataclasses.dataclass(frozen=True)
class SparcEncoderConfig:
    wavlm: WavLMConfig = WavLMConfig.large()
    tap_layer: int = 9
    n_ema: int = 12
    pitch: PitchConfig = PitchConfig()

    @property
    def frame_rate(self) -> int:
        return 50


def _align_pad(wav: torch.Tensor, c: SparcEncoderConfig) -> torch.Tensor:
    pad = (c.pitch.frame_length - WAVLM_RECEPTIVE_FIELD) // 2
    return torch.nn.functional.pad(wav, (pad, pad))


def _fit_frames(x: torch.Tensor, n: int) -> torch.Tensor:
    """Trim or edge-pad (B, N') to exactly (B, n)."""
    if x.shape[1] >= n:
        return x[:, :n]
    return torch.cat([x, x[:, -1:].expand(-1, n - x.shape[1])], dim=1)


class SparcEncoder(nn.Module):
    """wav (B, T_samples) -> (features (B, n_frames, 14), spk (B, D))."""

    def __init__(self, config: SparcEncoderConfig = SparcEncoderConfig()):
        super().__init__()
        self.config = config
        self.wavlm = WavLMEncoder(config.wavlm)
        self.ema_probe = nn.Linear(config.wavlm.hidden_dim, config.n_ema)

    def forward(self, wav, frame_mask: Optional[torch.Tensor] = None):
        c = self.config
        feats = self.wavlm(wav, frame_mask=frame_mask, tap_layer=c.tap_layer)  # (B, N, D)
        ema = self.ema_probe(feats)
        n = feats.shape[1]
        padded = _align_pad(wav, c)
        f0, _ = track_pitch(padded, c.pitch)
        loud = frame_loudness(padded, c.pitch.frame_length, c.pitch.hop)
        features = torch.cat([ema, _fit_frames(f0, n)[..., None],
                              _fit_frames(loud, n)[..., None]], dim=-1)
        if frame_mask is None:
            return features, feats.mean(dim=1)
        m = frame_mask[:, :n, None].to(feats.dtype)
        spk = (feats * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
        return features * m, spk

    def num_frames(self, num_samples: int) -> int:
        return self.wavlm.num_frames(num_samples)


def load_probe_npz(path: str) -> Dict[str, torch.Tensor]:
    """The (D, 12) EMA probe exported from a sparc checkpoint as an npz with
    `weight` (12, D) or `kernel` (D, 12) and an optional `bias` (12,) ->
    the `ema_probe` state dict."""
    data = np.load(path)
    if "kernel" in data:
        weight = np.asarray(data["kernel"], np.float32).T
    else:
        weight = np.asarray(data["weight"], np.float32)
    bias = (np.asarray(data["bias"], np.float32) if "bias" in data.files
            else np.zeros((weight.shape[0],), np.float32))
    return {"weight": torch.from_numpy(np.ascontiguousarray(weight)),
            "bias": torch.from_numpy(bias)}


def build_encoder(hf_wavlm_state_dict: Optional[dict] = None,
                  config: SparcEncoderConfig = SparcEncoderConfig(),
                  probe: Optional[Dict[str, torch.Tensor]] = None,
                  generator: Optional[torch.Generator] = None,
                  device="cuda") -> SparcEncoder:
    """A `SparcEncoder` on `device` in eval mode: random weights drawn (on
    the CPU) from a seed taken from `generator` (seed 0 when None), then the
    HF WavLM backbone and the probe where given."""
    from arttts_tpu_torch.utils.reference_weights import load_hf_wavlm

    dev = resolve(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        enc = SparcEncoder(config)
    if hf_wavlm_state_dict is not None:
        load_hf_wavlm(enc.wavlm, hf_wavlm_state_dict)
    if probe is not None:
        enc.ema_probe.load_state_dict(probe)
    return enc.to(dev).eval()


def build_encoder_params(hf_wavlm_state_dict: Optional[dict] = None,
                         config: SparcEncoderConfig = SparcEncoderConfig(),
                         probe: Optional[Dict[str, torch.Tensor]] = None,
                         generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """`build_encoder`'s weights as a `SparcEncoder` state dict on the CPU."""
    return build_encoder(hf_wavlm_state_dict, config, probe, generator, "cpu").state_dict()
