"""VoxCommunis phonological-feature tokenization (a copy of the serving part
of `arttts_tpu/voxcommunis/data.py`, ref `src/voxcommunis/data.py:226-368`).

A `FeatureTokenizer` turns IPA phone strings into 24-dim feature rows
(multi-segment phones spread over their repetition counts), a
`PanPhonInventory` applies a correction map and downsamples 100 Hz
alignment frames to the 50 Hz model rate, and `phonological_feature_rows`
gives the (24 traits + silence + repetition-count) = 26-dim rows the
articulatory model reads. The training dataset and the language table are
not here yet.
"""

from __future__ import annotations

import pickle
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from arttts_tpu_torch.voxcommunis.decoder import FeatureDecoder
from arttts_tpu_torch.voxcommunis.utils import unique_consecutive

SAMPLE_RATE = 16_000
ALIGNMENT_FREQ = 100  # Hz
MODEL_FREQ = 50  # Hz
SUBSAMPLE = ALIGNMENT_FREQ // MODEL_FREQ


class FeatureTokenizer:
    """IPA phone -> representative form + (n_components, 24) feature rows
    (data.py:226-353); `encode` spreads multi-segment phones over their
    repetition counts with rounded boundaries."""

    def __init__(self, feature_decoder: FeatureDecoder):
        self._feat_decoder = feature_decoder

    @property
    def num_features(self) -> int:
        return len(self._feat_decoder.header)

    @property
    def multilingual_mode(self) -> bool:
        return self._feat_decoder.multilingual_mode

    @lru_cache(maxsize=None)
    def ipa_to_features(self, ipa_phone: str) -> Tuple[Tuple[str, ...], np.ndarray]:
        rep = self._feat_decoder.segment_to_representative(ipa_phone)
        rep, vector = self._feat_decoder.canonical_representation(rep)
        return rep, vector.astype(np.float32)

    def encode(
        self, ipa_phones: Sequence[str], counts: Sequence[int]
    ) -> Tuple[np.ndarray, List[str]]:
        """Expand phones into per-frame feature rows. A phone held for
        ``counts[i]`` frames repeats its vector; a k-component phone splits
        its frames into k near-equal runs (half-to-even rounded boundaries,
        matching ref data.py:304-338 semantics)."""
        if len(counts) != len(ipa_phones):
            raise ValueError(
                f"Length mismatch between IPA phones ({len(ipa_phones)}) and "
                f"counts ({len(counts)})"
            )
        chunks: List[np.ndarray] = []
        frame_phones: List[str] = []
        for phone, frames in zip(ipa_phones, counts):
            names, vectors = self.ipa_to_features(phone)
            k = len(names)
            edges = np.rint(np.arange(k + 1) * frames / k).astype(np.int64)
            runs = np.diff(edges)
            chunks.append(np.repeat(vectors, runs, axis=0))
            frame_phones.extend(np.repeat(np.asarray(names, dtype=object), runs))
        return np.concatenate(chunks, axis=0), frame_phones

    def decode(self, tokens: np.ndarray) -> List[str]:
        """Feature rows -> segments via the decoder's inverse lookup."""
        return [
            self._feat_decoder.find_segment(tuple(int(v) for v in row))
            for row in np.asarray(tokens)
        ]


class PanPhonInventory:
    """Correction-map application + 100->50 Hz downsampling (data.py:356-368).

    The reference loads `correction_map.pickle`; pass a dict or pickle path,
    default empty."""

    def __init__(self, corrections: Optional[object] = None):
        if corrections is None:
            self._corrections: Dict[str, str] = {}
        elif isinstance(corrections, (str, Path)):
            with open(corrections, "rb") as fp:
                self._corrections = pickle.load(fp)
        else:
            self._corrections = dict(corrections)

    def convert_to_ipa(self, panphon_phones) -> str:
        if isinstance(panphon_phones, str):
            panphon_phones = panphon_phones.split(" ")
        panphon_phones = panphon_phones[::SUBSAMPLE]
        return " ".join(self._corrections.get(p, p) for p in panphon_phones)


def phonological_feature_rows(
    phones_str: str, tokenizer: FeatureTokenizer
) -> np.ndarray:
    """Aligned phone string -> (seq_len, 26) rows: 24 traits + silence trait
    (+1 sil / -1 speech) + frame repetition count (data_ms.py:110-124)."""
    phones = phones_str.split(" ")
    phones, counts = unique_consecutive(phones, return_counts=True)
    ones = [1] * len(phones)
    feats, _ = tokenizer.encode(phones, ones)
    sil = (np.all(feats == 0, axis=1) * 2 - 1).astype(np.float32)[:, None]
    cnt = np.asarray(counts, np.float32)[:, None]
    return np.concatenate([feats, sil, cnt], axis=1)
