"""Quantitative evaluation stages writing per-sample CSVs (port of
`arttts_tpu/eval/quanti.py`, the reference's `quanti_art_voxcom.py` and
`quanti_mel_comp.py`): each reads the previous stage's artifacts ((29|161,
T) npys) and appends CSV rows.

- `quanti_art`: predicted articulatory tracks against reference SPARC
  features ((T, >= 14) npys): mean EMA PCC, pitch PCC, loudness PCC and the
  normalised DTW over the 12 EMA channels;
- `reencode_wavs`: the SPARC re-encoding step of that protocol, through the
  port's encoder (`models/sparc_encoder.py`);
- `quanti_mel`: mel artifacts against ground-truth mels: L2 and DTW.
"""

from __future__ import annotations

import csv
import logging
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from arttts_tpu_torch.eval.metrics import (
    ema_mean_pcc,
    mel_l2,
    normalized_dtw_score,
    pearson_correlation,
)
from arttts_tpu_torch.infer.pipeline import split_acoustic_artifact

ENCODE_BUCKETS = tuple(32000 * i for i in range(1, 16))  # 2 s .. 30 s at 16 kHz

log = logging.getLogger(__name__)


def append_rows(out_csv: str, header, rows) -> None:
    """Append CSV `rows` to `out_csv`, writing `header` when the file is new."""
    new_file = not Path(out_csv).exists()
    with open(out_csv, "a", newline="") as f:
        w = csv.writer(f)
        if new_file:
            w.writerow(header)
        w.writerows(rows)


def quanti_art(pred_dir: str, ref_dir: str, out_csv: Optional[str] = None,
               use_decoder_rows: bool = True) -> Dict[str, Dict[str, float]]:
    """Per sample with a reference of the same name: EMA PCC (12 ch), pitch
    PCC (ch 12), loudness PCC (ch 13), normalised DTW over the EMA."""
    results: Dict[str, Dict[str, float]] = {}
    for pred_fp in sorted(Path(pred_dir).glob("*.npy")):
        ref_fp = Path(ref_dir) / pred_fp.name
        if not ref_fp.exists():
            continue
        enc, dec, _ = split_acoustic_artifact(np.load(pred_fp), n_feats=14)
        pred = dec if use_decoder_rows else enc  # (T, 14)
        ref = np.load(ref_fp)[:, :14]
        T = min(pred.shape[0], ref.shape[0])
        pred, ref = pred[:T], ref[:T]
        dtw, _, _ = normalized_dtw_score(pred[:, :12], ref[:, :12])
        results[pred_fp.stem] = {
            "ema_pcc": ema_mean_pcc(pred, ref),
            "pitch_pcc": pearson_correlation(pred[:, 12], ref[:, 12]),
            "loudness_pcc": pearson_correlation(pred[:, 13], ref[:, 13]),
            "dtw": dtw,
        }
    if out_csv and results:
        keys = ["ema_pcc", "pitch_pcc", "loudness_pcc", "dtw"]
        append_rows(out_csv, ["sample_id"] + keys,
                     [[sid] + [results[sid][k] for k in keys] for sid in sorted(results)])
    return results


def encode_padded(encoder, wav: np.ndarray, device):
    """One clip through `encoder` (a `SparcEncoder` on `device`) in the
    smallest 2 s bucket holding it (the last bucket truncates, with a
    warning), frames past the clip masked: (features (n_valid, 14), spk (D,))
    as NumPy arrays."""
    n = len(wav)
    cap = next((b for b in ENCODE_BUCKETS if n <= b), ENCODE_BUCKETS[-1])
    if n > cap:
        log.warning("%d samples exceed the largest bucket (%d = %.0f s); truncating",
                    n, cap, cap / 16000)
    pad = np.zeros((1, cap), np.float32)
    pad[0, :n] = wav[:cap]
    n_valid = encoder.num_frames(min(n, cap))
    mask = (np.arange(encoder.num_frames(cap)) < n_valid).astype(np.float32)[None]
    with torch.inference_mode():
        feats, spk = encoder(torch.from_numpy(pad).to(device), torch.from_numpy(mask).to(device))
    return feats[0, :n_valid].cpu().numpy(), spk[0].cpu().numpy()


def reencode_wavs(wav_dir: str, out_dir: str, encoder=None, config=None,
                  device="cuda") -> int:
    """Encode every `*.wav` of `wav_dir` to a `(T, 14)` npy of the same stem
    in `out_dir`; returns the count. `encoder=None` builds one with random
    weights (pipeline smoke only: pass one with the WavLM and probe weights
    for a real evaluation)."""
    from arttts_tpu_torch.audio.io import load_wav
    from arttts_tpu_torch.core.device import check_module, resolve
    from arttts_tpu_torch.models.sparc_encoder import SparcEncoderConfig, build_encoder

    dev = resolve(device)
    if encoder is None:
        encoder = build_encoder(None, config or SparcEncoderConfig(), device=dev)
    check_module(encoder, dev)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    n_done = 0
    for wav_fp in sorted(Path(wav_dir).glob("*.wav")):
        wav, _ = load_wav(str(wav_fp), target_sr=encoder.config.pitch.sample_rate)
        feats, _ = encode_padded(encoder, wav, dev)
        np.save(out / f"{wav_fp.stem}.npy", feats)
        n_done += 1
    return n_done


def quanti_mel(pred_dir: str, ref_mel_dir: str,
               out_csv: Optional[str] = None) -> Dict[str, Dict[str, float]]:
    """Mel artifacts ((161, T)) against ground-truth mel npys ((T, 80) or
    (80, T))."""
    results: Dict[str, Dict[str, float]] = {}
    for pred_fp in sorted(Path(pred_dir).glob("*.npy")):
        ref_fp = Path(ref_mel_dir) / pred_fp.name
        if not ref_fp.exists():
            continue
        _, dec, _ = split_acoustic_artifact(np.load(pred_fp), n_feats=80)
        ref = np.load(ref_fp)
        if ref.shape[0] == 80 and ref.shape[1] != 80:
            ref = ref.T
        dtw, _, _ = normalized_dtw_score(dec, ref)
        results[pred_fp.stem] = {"mel_l2": mel_l2(dec, ref), "dtw": dtw}
    if out_csv and results:
        append_rows(out_csv, ["sample_id", "mel_l2", "dtw"],
                     [[sid, results[sid]["mel_l2"], results[sid]["dtw"]]
                      for sid in sorted(results)])
    return results
