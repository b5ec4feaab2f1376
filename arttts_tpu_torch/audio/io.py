"""WAV IO and resampling without torchaudio/soundfile dependencies (a copy
of `arttts_tpu/audio/io.py`)."""

from __future__ import annotations

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def load_wav(path, target_sr: int | None = None) -> tuple[np.ndarray, int]:
    """Read a wav file -> (float32 mono [-1, 1], sample_rate); optionally
    polyphase-resample to target_sr."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        audio = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        audio = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        audio = (data.astype(np.float32) - 128.0) / 128.0
    else:
        audio = data.astype(np.float32)
    if audio.ndim > 1:
        audio = audio.mean(axis=1)
    if target_sr is not None and sr != target_sr:
        from math import gcd

        g = gcd(sr, target_sr)
        audio = resample_poly(audio, target_sr // g, sr // g).astype(np.float32)
        sr = target_sr
    return audio, sr


def save_wav(path, audio: np.ndarray, sr: int) -> None:
    """Write float [-1, 1] audio as int16 wav (like the reference's
    `vocoder_inference.py:137-141` clamp * 32768 -> int16)."""
    audio = np.clip(np.asarray(audio, np.float32), -1.0, 1.0)
    wavfile.write(path, sr, (audio * 32767.0).astype(np.int16))
