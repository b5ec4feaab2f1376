"""Segment-crop dataset of real audio for HiFi-GAN training (port of
`arttts_tpu/data/vocoder_dataset.py`, the reference's `MelDataset`,
`hifi-gan/meldataset.py:115-246`).

Random fixed-size audio segments paired with log-mel inputs: peak
normalisation, a zero pad for short clips, and a fine-tuning mode that
crops frame-aligned segments from precomputed (acoustic-model output) mels
in `base_mels_dir/<stem>.npy` (the audio is peak-normalised only outside
fine-tuning, as the JAX dataset's default config does). The crops are drawn on the host from a numpy
`Generator` in exactly the JAX package's order (the indices, then one
`integers` call a crop), so one seed gives the same crops bit for bit. A
batch's input mel is one call of `audio/mel.py:MelSpectrogram` on `device`
(default "cuda", no fallback). Decoded wavs are kept in a small LRU cache.
"""

from __future__ import annotations

import dataclasses
import os
from collections import OrderedDict
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from arttts_tpu_torch.audio.io import load_wav
from arttts_tpu_torch.audio.mel import MelConfig, MelSpectrogram
from arttts_tpu_torch.core.device import resolve

CACHE_ITEMS = 8  # LRU of decoded wavs


@dataclasses.dataclass(frozen=True)
class VocoderDataConfig:
    """Segment and crop policy (the reference's hifi-gan `config_v1.json`
    and `meldataset.py`)."""

    segment_size: int = 8192  # samples; a multiple of hop_length
    sample_rate: int = 22050  # a wav at another rate raises
    fine_tuning: bool = False
    base_mels_dir: Optional[str] = None  # fine-tuning: acoustic-output mels


class VocoderSegmentDataset:
    """Random segment crops of real audio, with the batch's mel on `device`.

    `sample_batch` returns {"wav": (B, S, 1), "mel": (B, S / hop, n_mels)},
    float32 tensors on `device`: the batch `VocoderGAN.train_step` takes.
    In fine-tuning mode the mel comes from `base_mels_dir/<stem>.npy`
    (frame-major (T, n_mels), or channel-major) and the wav crop is
    frame-aligned to it; otherwise it is computed from the cropped wavs."""

    def __init__(self, wav_paths: Sequence[str], config: VocoderDataConfig = VocoderDataConfig(),
                 mel_config: MelConfig = MelConfig(), device="cuda"):
        if config.segment_size % mel_config.hop_length:
            raise ValueError("segment_size must be a multiple of hop_length")
        self.device = resolve(device)
        self.paths = list(wav_paths)
        self.config = config
        self.mel_config = mel_config
        self.mel = MelSpectrogram(mel_config, self.device)
        self._cache: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self.seg_frames = config.segment_size // mel_config.hop_length

    def __len__(self) -> int:
        return len(self.paths)

    def _audio(self, path: str) -> np.ndarray:
        cached = self._cache.get(path)
        if cached is not None:
            self._cache.move_to_end(path)
            return cached
        wav, rate = load_wav(path)
        if rate != self.config.sample_rate:
            raise ValueError(f"{path}: rate {rate} != expected {self.config.sample_rate}")
        if not self.config.fine_tuning:  # |max| normalised to 0.95
            peak = np.abs(wav).max()
            if peak > 0:
                wav = wav / peak * 0.95
        self._cache[path] = wav
        while len(self._cache) > CACHE_ITEMS:
            self._cache.popitem(last=False)
        return wav

    def _base_mel(self, path: str) -> np.ndarray:
        stem = os.path.splitext(os.path.basename(path))[0]
        mel = np.load(os.path.join(self.config.base_mels_dir, stem + ".npy"))
        if mel.ndim == 3:
            mel = mel[0]
        n_mels = self.mel_config.n_mels
        if mel.shape[0] == n_mels and mel.shape[1] != n_mels:
            mel = mel.T  # a channel-major dump
        return mel.astype(np.float32)  # (T, n_mels)

    def _crop(self, idx: int, rng: np.random.Generator):
        """One (wav segment, mel or None) crop, a short clip zero-padded."""
        cfg = self.config
        hop = self.mel_config.hop_length
        wav = self._audio(self.paths[idx])
        seg = cfg.segment_size
        if not cfg.fine_tuning:
            if len(wav) >= seg:
                start = int(rng.integers(0, len(wav) - seg + 1))
                return wav[start:start + seg], None
            return np.pad(wav, (0, seg - len(wav))), None
        mel = self._base_mel(self.paths[idx])
        if len(wav) >= seg and mel.shape[0] > self.seg_frames:
            m0 = int(rng.integers(0, mel.shape[0] - self.seg_frames))
            mel_c = mel[m0:m0 + self.seg_frames]
            wav_c = wav[m0 * hop:(m0 + self.seg_frames) * hop]
            if len(wav_c) < seg:  # the mel runs past the audio's end
                wav_c = np.pad(wav_c, (0, seg - len(wav_c)))
            return wav_c, mel_c
        mel_c = np.zeros((self.seg_frames, mel.shape[1]), np.float32)
        mel_c[: min(self.seg_frames, mel.shape[0])] = mel[: self.seg_frames]
        wav_c = np.pad(wav[:seg], (0, max(0, seg - len(wav))))
        return wav_c, mel_c

    def sample_batch(self, batch_size: int, rng: np.random.Generator) -> Dict[str, torch.Tensor]:
        idx = rng.integers(0, len(self.paths), size=batch_size)
        return self._assemble(idx, rng)

    def _assemble(self, indices, rng) -> Dict[str, torch.Tensor]:
        wavs, mels = [], []
        for i in indices:
            w, m = self._crop(int(i), rng)
            wavs.append(w)
            mels.append(m)
        wav = torch.from_numpy(np.stack(wavs).astype(np.float32)).to(self.device)  # (B, S)
        if self.config.fine_tuning:
            mel = torch.from_numpy(np.stack(mels)).to(self.device)
        else:  # one call for the batch; no inference tensor, so autograd may save it
            with torch.no_grad():
                mel = self.mel.differentiable(wav)
        return {"wav": wav[:, :, None], "mel": mel}

    def batches(self, batch_size: int, seed: int = 1234,
                drop_last: bool = True) -> Iterator[Dict[str, torch.Tensor]]:
        """One epoch of shuffled batches (the reference shuffles once, seed 1234)."""
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(self.paths))
        stop = len(order) - (len(order) % batch_size) if drop_last else len(order)
        for k in range(0, stop, batch_size):
            yield self._assemble(order[k:k + batch_size], rng)
