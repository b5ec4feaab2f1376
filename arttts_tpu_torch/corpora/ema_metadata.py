"""EMA corpus metadata pipeline (port of `arttts_tpu/corpora/ema_metadata.py`).

Equivalent of the reference's `src/utils_ema/ema_dataset.py` (SpeakerMetadata
/ SentenceMetadata): per-sentence records (id, paths, duration, validity),
per-speaker aggregation with train/val/test splits, EMA loading through the
corpus registry, resampling to a common rate, NaN-validity checks, and PCC
of corpus EMA vs SPARC re-encodings. The reference's four per-corpus method
families collapse into the one registry-driven implementation.

`SpeakerMetadata(ema_rate=100.0)` does not take the corpus's rate from
`CORPUS_LAYOUTS`: a caller passes it (MOCHA 500, MSPKA 400, PB2007 100), as
in the JAX package. `save`/`load` pickle the object, so a pickle names this
package's class; `to_json` is the format both packages share.
"""

from __future__ import annotations

import dataclasses
import json
import pickle
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
from scipy.signal import resample_poly

from arttts_tpu_torch.corpora.registry import get_corpus
from arttts_tpu_torch.eval.metrics import pearson_correlation


@dataclasses.dataclass
class SentenceMetadata:
    id: int
    stem: str
    # `wav_path` is never set here; it stays for `to_json`, the format
    # shared with the JAX package, whose `scan` fills it
    label_path: Optional[str] = None
    ema_path: Optional[str] = None
    wav_path: Optional[str] = None
    duration: Optional[float] = None
    valid: bool = True
    split: Optional[str] = None
    pcc_vs_sparc: Optional[float] = None

    def set_valid(self, valid: bool):
        self.valid = bool(valid)

    def set_duration(self, duration: float):
        self.duration = float(duration)


def resample_ema(ema: np.ndarray, src_rate: float, dst_rate: float = 100.0):
    """Polyphase resampling of (T, C) EMA tracks to a common rate."""
    if src_rate == dst_rate:
        return ema.astype(np.float32)
    from math import gcd

    a, b = int(round(dst_rate)), int(round(src_rate))
    g = gcd(a, b)
    return resample_poly(ema, a // g, b // g, axis=0).astype(np.float32)


# a sentence whose share of frames with a NaN (sensor dropouts) is above
# this is invalid
NAN_FRAC_THRESHOLD = 0.05


def ema_validity(ema: np.ndarray) -> bool:
    """A sentence is invalid when too many frames carry NaNs (sensor
    dropouts)."""
    return float(np.isnan(ema).any(axis=1).mean()) <= NAN_FRAC_THRESHOLD


class SpeakerMetadata:
    """Per-speaker sentence collection for one EMA corpus."""

    def __init__(self, corpus_name: str, speaker: str, root: str,
                 ema_rate: float = 100.0):
        self.corpus_name = corpus_name
        self.speaker = speaker
        self.root = Path(root)
        self.ema_rate = ema_rate
        self.sentences: Dict[int, SentenceMetadata] = {}

    # -- building ---------------------------------------------------------
    def scan(self, label_dir: str, ema_dir: Optional[str] = None):
        corpus = get_corpus(self.corpus_name)
        labels = sorted(Path(label_dir).glob(f"*{corpus.label_ext}"))
        for i, lab in enumerate(labels):
            s = SentenceMetadata(id=i, stem=lab.stem, label_path=str(lab))
            if ema_dir:
                for cand in Path(ema_dir).glob(f"{lab.stem}.*"):
                    s.ema_path = str(cand)
                    break
            self.sentences[i] = s
        return self

    def add_sentence(self, s: SentenceMetadata):
        self.sentences[s.id] = s

    # -- access -----------------------------------------------------------
    def get_sentences(self) -> List[SentenceMetadata]:
        return [self.sentences[k] for k in sorted(self.sentences)]

    def list_valid_ids(self) -> List[int]:
        return [k for k in sorted(self.sentences) if self.sentences[k].valid]

    def get_src_ema(self, id: int, dst_rate: float = 100.0) -> np.ndarray:
        corpus = get_corpus(self.corpus_name)
        assert corpus.get_ema is not None, f"{self.corpus_name} has no EMA reader"
        ema = corpus.get_ema(self.sentences[id].ema_path)
        return resample_ema(ema, self.ema_rate, dst_rate)

    def get_phnm3(self, id: int):
        corpus = get_corpus(self.corpus_name)
        return corpus.get_phnm3(self.sentences[id].label_path)

    # -- processing -------------------------------------------------------
    def extract_durations(self):
        for s in self.get_sentences():
            phnm3 = self.get_phnm3(s.id)
            if len(phnm3):
                s.set_duration(float(phnm3["end"][-1]))

    def validate_ema(self):
        for s in self.get_sentences():
            if s.ema_path is None:
                s.set_valid(False)
                continue
            try:
                ema = self.get_src_ema(s.id)
                s.set_valid(ema_validity(ema))
            except Exception:
                s.set_valid(False)

    def compute_sentence_pcc(self, id: int, sparc_ema: np.ndarray) -> float:
        """Mean per-channel PCC between corpus EMA (resampled to 50 Hz) and a
        SPARC re-encoding (T, 12) — the reference's sanity metric
        (ema_dataset.py:248)."""
        ema = self.get_src_ema(id, dst_rate=50.0)
        T = min(len(ema), len(sparc_ema))
        vals = [
            pearson_correlation(ema[:T, c], sparc_ema[:T, c])
            for c in range(min(ema.shape[1], sparc_ema.shape[1]))
        ]
        pcc = float(np.mean(vals))
        self.sentences[id].pcc_vs_sparc = pcc
        return pcc

    def set_splits(self, val_frac: float = 0.05, test_frac: float = 0.05,
                   seed: int = 37):
        ids = self.list_valid_ids()
        rng = np.random.default_rng(seed)
        perm = rng.permutation(len(ids))
        n_val = int(len(ids) * val_frac)
        n_test = int(len(ids) * test_frac)
        for j, pidx in enumerate(perm):
            sid = ids[pidx]
            if j < n_val:
                self.sentences[sid].split = "val"
            elif j < n_val + n_test:
                self.sentences[sid].split = "test"
            else:
                self.sentences[sid].split = "train"

    def agg_Xy_split(self, split: str):
        """(phnm3 list, ema list) for a split — training-ready pairs."""
        X, y = [], []
        for s in self.get_sentences():
            if s.valid and s.split == split:
                X.append(self.get_phnm3(s.id))
                y.append(self.get_src_ema(s.id))
        return X, y

    # -- persistence ------------------------------------------------------
    def save(self, path: str):
        with open(path, "wb") as f:
            pickle.dump(self, f)

    @classmethod
    def load(cls, path: str) -> "SpeakerMetadata":
        with open(path, "rb") as f:
            return pickle.load(f)

    def to_json(self, path: str):
        rows = [dataclasses.asdict(s) for s in self.get_sentences()]
        Path(path).write_text(json.dumps(
            {"corpus": self.corpus_name, "speaker": self.speaker,
             "sentences": rows}, indent=1))
