"""Inference pipeline stages with the reference's filesystem contract (port
of `arttts_tpu/infer/pipeline.py`: `predict_frames`,
`run_acoustic_inference`, `split_acoustic_artifact`,
`denormalize_sparc_features`, `run_sparc_vocoder`).

Stage 1 (acoustic, ref `arttts_inference.py:317-379`): per sample, save
`{sample_id}.npy` of shape (29, T) for articulatory models - 14 reordered
encoder rows, 14 reordered decoder rows, 1 input_map row (frame -> input
token index from the alignment path) - or (161, T) for mel models.

Stage 2 (vocoding, `hifigan_inference_ms.py:81-141`): articulatory
artifacts -> wav through the SPARC FiLM generator's fast path
(`infer/chunked.py:vocode_sparc`, K4 FiLM mode and K5), pitch and loudness
denormalised first.

Every entry takes `device` (default "cuda"); the models must live on it.
Random draws come from a `torch.Generator` seeded with `seed` on `device`.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from arttts_tpu_torch.audio.io import save_wav
from arttts_tpu_torch.core.config import SPARC_REORDER_FEATS, ExperimentConfig
from arttts_tpu_torch.core.device import resolve
from arttts_tpu_torch.infer.chunked import vocode_sparc
from arttts_tpu_torch.infer.sampler import (
    encode_text,
    frame_bucket,
    predict_lengths,
    synthesize,
    synthesize_from_encoding,
)
from arttts_tpu_torch.ops.shape import fix_len_compatibility


def _sample_id(dataset, index: int) -> str:
    return dataset.manifest[index][0]  # voxcommunis manifests: (file id, (path, samples))


def predict_frames(model, x, x_lengths, spk=None, device="cuda"):
    """Total predicted frames per sentence (sum of ceil durations), (B,)."""
    w = predict_lengths(model, x, x_lengths, spk, device)
    return torch.ceil(w[:, :, 0]).sum(dim=1)


def run_acoustic_inference(config: ExperimentConfig, model, dataset, save_dir: str,
                           n_timesteps: int = 50, temperature: float = 1.0,
                           length_scale: float = 1.0, use_align: bool = False, seed: int = 37,
                           max_frames_cap: int = 2048, solver: str = "euler",
                           device="cuda") -> list:
    """Per-sample synthesis over `dataset`, saving the (29|161, T) npy
    contract. With `use_align` and an item's "durations" (aligned-input
    models) the bucket comes from the summed durations; otherwise one
    encoder pass sizes the bucket and feeds the decoder. Returns the saved
    paths."""
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    is_artic = config.model.n_feats == 16
    generator = torch.Generator(device=resolve(device)).manual_seed(seed)
    saved = []
    for index in range(len(dataset)):
        item = dataset[index]
        x = torch.as_tensor(np.asarray(item["x"])[None])
        x_lengths = torch.tensor([x.shape[1]], dtype=torch.int32)
        durations = None
        if use_align and "durations" in item:
            durations = torch.as_tensor(np.ceil(item["durations"])[None])
        spk = torch.as_tensor(np.asarray(item["spk"])[None]) if "spk" in item else None
        if durations is not None:
            pred_frames = int(math.ceil(float(durations.sum())))
            max_frames = frame_bucket(min(fix_len_compatibility(pred_frames), max_frames_cap))
            enc, dec, attn, y_len = synthesize(
                model, generator, x, x_lengths, n_timesteps, max_frames, temperature,
                length_scale=length_scale, x_durations=durations, device=device, spk=spk,
                solver=solver)
        else:
            mu_x, logw, x_mask, pf = encode_text(model, x, x_lengths, spk, device)
            pred_frames = min(max_frames_cap,
                              max(64, int(math.ceil(float(pf[0]) * length_scale - 1e-6))))
            max_frames = frame_bucket(min(fix_len_compatibility(pred_frames), max_frames_cap))
            enc, dec, attn, y_len = synthesize_from_encoding(
                model, generator, mu_x, logw, x_mask, n_timesteps, max_frames, temperature,
                length_scale=length_scale, device=device, spk=spk, solver=solver)
        L = int(y_len[0])
        enc_np = enc[0, :L].cpu().numpy()  # (L, n_feats)
        dec_np = dec[0, :L].cpu().numpy()
        input_map = attn[0, :, :L].cpu().numpy().argmax(axis=0)  # frame -> input token
        if is_artic:
            enc_np = enc_np[:, list(SPARC_REORDER_FEATS)]  # (L, 14)
            dec_np = dec_np[:, list(SPARC_REORDER_FEATS)]
        out = np.vstack([enc_np.T, dec_np.T, input_map[None, :]])  # (29|161, L)
        path = save_dir / f"{_sample_id(dataset, index)}.npy"
        np.save(path, out.astype(np.float32))
        saved.append(str(path))
    return saved


def split_acoustic_artifact(arr: np.ndarray, n_feats: int = 14):
    """(2*n_feats+1, T) artifact -> (enc (T, n), dec (T, n), input_map (T,))."""
    enc = arr[:n_feats].T
    dec = arr[n_feats: 2 * n_feats].T
    input_map = arr[2 * n_feats]
    return enc, dec, input_map


def denormalize_sparc_features(dec: np.ndarray, pitch_stats: tuple,
                               loudness_stats: Optional[tuple] = None) -> np.ndarray:
    """Undo the dataset normalization before vocoding
    (hifigan_inference.py:185-205): pitch ch 12 back to Hz via mu + z*std;
    loudness ch 13 via exp(mu + z*std) when it was log-normalized."""
    out = dec.copy()
    mu_p, std_p = pitch_stats
    out[:, 12] = out[:, 12] * std_p + mu_p
    if loudness_stats is not None:
        mu_l, std_l = loudness_stats
        out[:, 13] = np.exp(out[:, 13] * std_l + mu_l)
    return out


def run_sparc_vocoder(generator, artifact_paths, spk_ft: np.ndarray, save_dir: str,
                      pitch_stats: tuple, loudness_stats: Optional[tuple] = None,
                      sample_rate: int = 16000, device="cuda") -> list:
    """Saved (29, T) articulatory artifacts -> wav through the
    `SpkSparcHiFiGANGenerator` `generator` on its fast path
    (hifigan_inference_ms.py:91-141). Returns the saved paths."""
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    saved = []
    for p in artifact_paths:
        _, dec, _ = split_acoustic_artifact(np.load(p), n_feats=14)
        dec = denormalize_sparc_features(dec, pitch_stats, loudness_stats)
        # fixed-shape windows: one window shape serves every artifact length
        wav = vocode_sparc(generator, dec.astype(np.float32), spk_ft, device=device)
        out = save_dir / (Path(p).stem + ".wav")
        save_wav(out, wav, sample_rate)
        saved.append(str(out))
    return saved
