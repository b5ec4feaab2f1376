"""phnm3 structured-array utilities (ref `src/text/phnms.py`; a copy of
`arttts_tpu/text/phnms.py`).

A "phnm3" is a structured numpy array of (start, end, phone) rows describing
a forced alignment in seconds. Builders, diphthong splitting, duration
extraction, and re-alignment of ground-truth phonemes to model frame maps
(the `input_map` row of inference artifacts).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from arttts_tpu_torch.text.converters import DIPHTHONGS_IPA

PHNM3_DTYPE = [("start", "f4"), ("end", "f4"), ("phone", "U10")]

ART_SR = 50  # articulatory frame rate (Hz)


def build_phnm3(phonemes: Sequence[str], t_boundaries: Sequence[float]) -> np.ndarray:
    """Phones + boundary times (len = len(phones)+1) -> phnm3 array."""
    assert len(t_boundaries) == len(phonemes) + 1, (
        f"need len(phonemes)+1 boundaries, got {len(t_boundaries)} for "
        f"{len(phonemes)} phones"
    )
    rows = [
        (t_boundaries[i], t_boundaries[i + 1], ph) for i, ph in enumerate(phonemes)
    ]
    return np.array(rows, dtype=PHNM3_DTYPE)


def get_phnms_from_phnm3(phnm3, merge_diphtongues: bool) -> List[str]:
    """Phone list; diphthongs split into components unless merged."""
    phnms: List[str] = []
    for row in phnm3:
        phone = str(row[2])
        if merge_diphtongues or phone not in DIPHTHONGS_IPA:
            phnms.append(phone)
        else:
            phnms.append(phone[0])
            phnms.append(phone[1])
    return phnms


def get_pred_phnm3(
    phnm3, phnm_map: np.ndarray, merge_diphtongues: bool = False
) -> np.ndarray:
    """Re-align ground-truth phones to the model's frame->token map (the
    input_map artifact row) so that boundaries land exactly on predicted
    frames (ref phnms.py:46-72)."""
    phnms = get_phnms_from_phnm3(phnm3, merge_diphtongues)
    t_end = phnm_map.shape[0] / ART_SR
    boundaries = list((np.where(np.diff(phnm_map) == 1)[0] + 1) / ART_SR)
    boundaries = [0.0] + boundaries + [t_end]
    return build_phnm3(phnms, boundaries)


def get_lengths_from_phnm3(phnm3, merge_diphtongues: bool = False) -> np.ndarray:
    """Per-phone durations (seconds), halving diphthongs when split."""
    durations: List[float] = []
    for start, end, phone in phnm3:
        start, end, phone = float(start), float(end), str(phone)
        if not merge_diphtongues and phone in DIPHTHONGS_IPA:
            mid = (start + end) / 2
            durations += [mid - start, end - mid]
        else:
            durations.append(end - start)
    return np.asarray(durations, np.float32)
