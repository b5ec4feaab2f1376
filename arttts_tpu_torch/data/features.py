"""SPARC articulatory feature conventions (a copy of
`arttts_tpu/data/features.py`).

The SPARC coder emits 14 features per 20 ms frame (12 EMA + pitch +
loudness). The reference reorders/pads them into 16 channels for U-Net
divisibility and z-scores the pitch channel per utterance
(the reference's `src/data.py:107-134`, channel map
`configs/params_v1.py:22-35`); loudness is optionally log-normalized
(`data_phnm.py` with `log_normalize_loudness`).
"""

from __future__ import annotations

import numpy as np

from arttts_tpu_torch.core.config import (
    SPARC_LOUDNESS_IDX,
    SPARC_PITCH_IDX,
    SPARC_REORDER_FEATS,
)


def reorder_art_feats(art: np.ndarray, n_feats: int = 16) -> np.ndarray:
    """(T, 14) raw SPARC features -> (T, 16) reordered/zero-padded."""
    out = np.zeros((art.shape[0], n_feats), dtype=np.float32)
    for i, j in enumerate(SPARC_REORDER_FEATS):
        out[:, j] = art[:, i]
    return out


def normalize_pitch_channel(art16: np.ndarray, pitch_idx: int = SPARC_PITCH_IDX) -> np.ndarray:
    """Z-score the pitch channel per utterance (after reordering)."""
    pitch = art16[:, pitch_idx]
    std = pitch.std()
    if std > 0:
        art16[:, pitch_idx] = (pitch - pitch.mean()) / std
    else:
        art16[:, pitch_idx] = pitch - pitch.mean()
    return art16


def log_normalize_loudness_channel(
    art16: np.ndarray, loudness_idx: int = SPARC_LOUDNESS_IDX
) -> np.ndarray:
    """log then z-score the loudness channel per utterance."""
    loud = np.log(np.maximum(art16[:, loudness_idx], 1e-8))
    std = loud.std()
    art16[:, loudness_idx] = (loud - loud.mean()) / std if std > 0 else loud - loud.mean()
    return art16


def load_art_features(
    npy_path,
    n_feats: int = 16,
    log_normalize_loudness: bool = False,
) -> np.ndarray:
    """Load `emasrc/*.npy` (T, >=14), keep first 14, reorder to (T, 16),
    normalize pitch (and optionally loudness)."""
    art = np.load(npy_path)[:, :14].astype(np.float32)
    art16 = reorder_art_feats(art, n_feats)
    art16 = normalize_pitch_channel(art16)
    if log_normalize_loudness:
        art16 = log_normalize_loudness_channel(art16)
    return art16
