"""Batched UTMOS scoring over wav directories (port of
`arttts_tpu/eval/utmos_scorer.py`, the reference's UTMOS-demo `predict.py`
+ `score.py`): glob `*.wav` (sorted), resample to 16 kHz, group the clips
by sample bucket, tile each clip to its bucket (repeat padding, never
zeros), score (frame mean x 2 + 3, domain 0, judge 288) and append
`filename,score` CSV rows in name order.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from arttts_tpu_torch.audio.io import load_wav
from arttts_tpu_torch.core.device import check_module, resolve
from arttts_tpu_torch.models.utmos import UTMOSPredictor, build_utmos

SAMPLE_BUCKETS = (16000, 32000, 64000, 96000, 160000, 320000)  # 1 s .. 20 s at 16 kHz


def _bucket(n: int) -> int:
    for b in SAMPLE_BUCKETS:
        if n <= b:
            return b
    return n


def repeat_pad(wav: np.ndarray, target: int) -> np.ndarray:
    """Tile the clip until it reaches `target` samples (predict.py:38-51
    pads by repeating the waveform, not with zeros)."""
    if len(wav) >= target:
        return wav[:target]
    reps = int(np.ceil(target / len(wav)))
    return np.tile(wav, reps)[:target]


class UTMOSScorer:
    """A `UTMOSPredictor` on `device` (the card unless the CPU is asked for)."""

    def __init__(self, model: Optional[UTMOSPredictor] = None, device="cuda"):
        self.device = resolve(device)
        self.model = model if model is not None else build_utmos(device=self.device)
        check_module(self.model, self.device)

    @classmethod
    def from_lightning_checkpoint(cls, ckpt_path: str, device="cuda") -> "UTMOSScorer":
        from arttts_tpu_torch.utils.reference_weights import load_utmos_lightning

        dev = resolve(device)
        ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
        with torch.device("meta"):  # the checkpoint's tensors become the parameters
            model = UTMOSPredictor()
        load_utmos_lightning(model, ckpt)
        return cls(model.to(dev).eval(), dev)

    @torch.inference_mode()
    def score_batch(self, wavs: Sequence[np.ndarray]) -> np.ndarray:
        """Score clips of one sample count in one batch: (B,) float32."""
        batch = torch.from_numpy(np.stack(wavs).astype(np.float32)).to(self.device)
        return self.model.score(batch).cpu().numpy()

    def score_directory(self, wav_dir: str, out_csv: Optional[str] = None,
                        batch_size: int = 32) -> Dict[str, float]:
        """Score every `*.wav` of `wav_dir` in bucketed batches; with
        `out_csv`, append one `filename,score` row a file."""
        by_bucket: Dict[int, List] = {}
        for p in sorted(Path(wav_dir).glob("*.wav")):
            wav, _ = load_wav(p, target_sr=16000)
            by_bucket.setdefault(_bucket(len(wav)), []).append((p.name, wav))
        results: Dict[str, float] = {}
        for bucket, entries in sorted(by_bucket.items()):
            for i in range(0, len(entries), batch_size):
                chunk = entries[i: i + batch_size]
                scores = self.score_batch([repeat_pad(w, bucket) for _, w in chunk])
                for (name, _), s in zip(chunk, scores):
                    results[name] = float(s)
        if out_csv:
            with open(out_csv, "a", newline="") as f:
                writer = csv.writer(f)
                for name in sorted(results):
                    writer.writerow([name, results[name]])
        return results
