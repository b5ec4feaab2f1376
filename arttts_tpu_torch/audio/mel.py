"""STFT + log-mel spectrogram on tensors (port of `arttts_tpu/audio/mel.py`).

Equivalent of the reference's `mel_spectrogram`
(`hifi-gan/meldataset.py:51-95`): reflect-pad by `(n_fft - hop)/2`,
non-centered STFT with a periodic Hann window, magnitude
`sqrt(re^2 + im^2 + 1e-9)`, a Slaney-normalized librosa-style mel filterbank
(fmin 0, fmax 8000), and `log(clamp(x, 1e-5))` dynamic-range compression.

The JAX package writes the DFT as two real matmuls for the TPU's matrix
unit; here it is `torch.stft` (no TPU kernel covers this module). The
filterbank is the same NumPy construction, computed in float64 and cast.
The extractor lives on `device` (default "cuda", no fallback).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from arttts_tpu_torch.core.device import resolve


def _hz_to_mel_slaney(freq: np.ndarray) -> np.ndarray:
    """Slaney mel scale: linear below 1 kHz, logarithmic above."""
    freq = np.asarray(freq, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mels = freq / f_sp
    log_region = freq >= min_log_hz
    mels = np.where(
        log_region,
        min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz) / logstep,
        mels,
    )
    return mels


def _mel_to_hz_slaney(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    freqs = f_sp * mels
    log_region = mels >= min_log_mel
    freqs = np.where(
        log_region, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs
    )
    return freqs


def mel_filterbank(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    fmin: float,
    fmax: float,
) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, shape (n_mels, n_fft//2+1).

    Matches `librosa.filters.mel(..., htk=False, norm="slaney")`, which is what
    the reference's `librosa_mel_fn` resolves to (`meldataset.py:59-62`).
    """
    n_freqs = n_fft // 2 + 1
    fftfreqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    mel_pts = np.linspace(
        _hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2
    )
    hz_pts = _mel_to_hz_slaney(mel_pts)  # (n_mels + 2,)

    fdiff = np.diff(hz_pts)  # (n_mels + 1,)
    ramps = hz_pts[:, None] - fftfreqs[None, :]  # (n_mels + 2, n_freqs)
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    # Slaney-style area normalization.
    enorm = 2.0 / (hz_pts[2:] - hz_pts[:-2])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def _hann_window_periodic(win_length: int) -> np.ndarray:
    """Periodic Hann window (torch.hann_window default)."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class MelConfig:
    sample_rate: int = 22050
    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_mels: int = 80
    fmin: float = 0.0
    fmax: float = 8000.0
    mag_eps: float = 1e-9
    log_clip: float = 1e-5


class MelSpectrogram:
    """Callable log-mel extractor on `device`: the window and the
    filterbank are built once, at construction."""

    def __init__(self, config: MelConfig = MelConfig(), device="cuda"):
        self.config = c = config
        self.device = resolve(device)
        window = _hann_window_periodic(c.win_length)
        if c.win_length < c.n_fft:  # torch.stft center-pads short windows
            pad = (c.n_fft - c.win_length) // 2
            window = np.pad(window, (pad, c.n_fft - c.win_length - pad))
        self._window = torch.from_numpy(window).to(self.device)
        self._mel = torch.from_numpy(
            mel_filterbank(c.sample_rate, c.n_fft, c.n_mels, c.fmin, c.fmax)
        ).to(self.device)  # (n_mels, n_freqs)

    def num_frames(self, num_samples: int) -> int:
        c = self.config
        padded = num_samples + 2 * ((c.n_fft - c.hop_length) // 2)
        return 1 + (padded - c.n_fft) // c.hop_length

    @torch.inference_mode()
    def __call__(self, y) -> torch.Tensor:
        """y: (..., num_samples) in [-1, 1] (array or tensor) -> (..., n_frames,
        n_mels) float32 log-mel on `device`, without a graph."""
        return self.differentiable(torch.as_tensor(y, dtype=torch.float32).to(self.device))

    def differentiable(self, y: torch.Tensor) -> torch.Tensor:
        """The same log-mel of a float32 tensor on `device`, keeping autograd's
        graph: the vocoder's generator loss differentiates through it, as the
        JAX trainer differentiates the JAX `MelSpectrogram`. The gradient is
        finite everywhere: `mag_eps` keeps the root off 0, and the clamp
        passes none below `log_clip`."""
        c = self.config
        lead, n = y.shape[:-1], y.shape[-1]
        pad = (c.n_fft - c.hop_length) // 2
        y = F.pad(y.reshape(-1, 1, n), (pad, pad), mode="reflect")[:, 0]
        spec = torch.stft(y, c.n_fft, c.hop_length, win_length=c.n_fft, window=self._window,
                          center=False, return_complex=True)  # (B, n_freqs, n_frames)
        mag = torch.sqrt(spec.real * spec.real + spec.imag * spec.imag + c.mag_eps)
        mel = torch.einsum("mf,bft->btm", self._mel, mag)
        return torch.log(torch.clamp(mel, min=c.log_clip)).reshape(*lead, -1, c.n_mels)
