"""Per-corpus quantitative evaluation vs EMA ground truth (port of
`arttts_tpu/eval/quanti_corpus.py`).

Equivalent of the reference's `src/quanti_art_comp.py`: compare predicted
articulatory artifacts against corpus EMA recordings (MNGU0/MOCHA/MSPKA/
PB2007) resampled to 50 Hz — normalized DTW over the 12 EMA channels and
per-channel PCC — appending per-sample CSV rows. Runs on the host (NumPy).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np

from arttts_tpu_torch.corpora.ema_metadata import SpeakerMetadata
from arttts_tpu_torch.eval.metrics import ema_mean_pcc, normalized_dtw_score
from arttts_tpu_torch.eval.quanti import append_rows
from arttts_tpu_torch.infer.pipeline import split_acoustic_artifact


def quanti_art_corpus(
    pred_dir: str,
    meta: SpeakerMetadata,
    out_csv: Optional[str] = None,
) -> Dict[str, Dict[str, float]]:
    """Match prediction npys to corpus sentences by stem; returns per-sample
    {dtw, ema_pcc} of the artifact's decoder rows. Channels are z-scored
    before DTW (the corpora and SPARC live in different coordinate frames,
    ref quanti_art_comp.py:45-58)."""
    by_stem = {s.stem: s for s in meta.get_sentences() if s.valid}
    results: Dict[str, Dict[str, float]] = {}
    for pred_fp in sorted(Path(pred_dir).glob("*.npy")):
        s = by_stem.get(pred_fp.stem)
        if s is None or s.ema_path is None:
            continue
        _, dec, _ = split_acoustic_artifact(np.load(pred_fp), n_feats=14)
        pred = dec[:, :12]
        gt = meta.get_src_ema(s.id, dst_rate=50.0)[:, :12]
        pred = (pred - pred.mean(0)) / (pred.std(0) + 1e-8)
        gt = (gt - gt.mean(0)) / (gt.std(0) + 1e-8)
        dtw, p_al, g_al = normalized_dtw_score(pred, gt)
        results[pred_fp.stem] = {
            "dtw": dtw,
            "ema_pcc": ema_mean_pcc(p_al, g_al, n_ema=12),
        }
    if out_csv and results:
        append_rows(out_csv, ["sample_id", "dtw", "ema_pcc"],
                    [[sid, results[sid]["dtw"], results[sid]["ema_pcc"]]
                     for sid in sorted(results)])
    return results
