"""Inference pipeline stages with the reference's filesystem contract (port
of `arttts_tpu/infer/pipeline.py`).

Stage 1 (acoustic, ref `arttts_inference.py:317-379`): per sample, save
`{sample_id}.npy` of shape (29, T) for articulatory models - 14 reordered
encoder rows, 14 reordered decoder rows, 1 input_map row (frame -> input
token index from the alignment path) - or (161, T) for mel models.

Batched serving (`run_acoustic_inference_batched`): length-ordered
batches padded to shared buckets, with padding-exact GroupNorm statistics.

Stage 2 (vocoding): mel artifacts -> wav through the HiFi-GAN's fast path
(`run_mel_vocoder`, `vocoder_inference.py:76-141`), articulatory artifacts
-> wav through the SPARC FiLM generator's (`run_sparc_vocoder`,
`hifigan_inference_ms.py:81-141`, pitch and loudness denormalised first);
both through `infer/chunked.py:vocode_chunked` on K4 and K5.

Every entry takes `device` (default "cuda"); the models must live on it.
Random draws come from a `torch.Generator` seeded with `seed` on `device`.
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from arttts_tpu_torch.audio.io import save_wav
from arttts_tpu_torch.core.config import SPARC_REORDER_FEATS, ExperimentConfig
from arttts_tpu_torch.core.device import check_module, resolve
from arttts_tpu_torch.infer.chunked import vocode_chunked, vocode_sparc
from arttts_tpu_torch.infer.sampler import (
    encode_text,
    frame_bucket,
    predict_lengths,
    synthesize,
    synthesize_from_encoding,
)
from arttts_tpu_torch.models.hifigan import hifigan_forward_fast
from arttts_tpu_torch.models.tts import GradTTSModel
from arttts_tpu_torch.ops.shape import fix_len_compatibility
from arttts_tpu_torch.utils.profiling import span


def _sample_id(dataset, index: int) -> str:
    if hasattr(dataset, "entries"):  # filelists: the first field is the wav path
        return Path(dataset.entries[index][0]).stem
    return dataset.manifest[index][0]  # voxcommunis manifests: (file id, (path, samples))


def _save_artifact(path: Path, enc, dec, attn, L: int, is_artic: bool) -> str:
    """One utterance's (29|161, L) artifact: encoder rows, decoder rows
    (reordered to the 14 SPARC channels for articulatory models) and the
    input map (frame -> input token)."""
    enc_np = enc[:L].cpu().numpy()  # (L, n_feats)
    dec_np = dec[:L].cpu().numpy()
    input_map = attn[:, :L].cpu().numpy().argmax(axis=0)
    if is_artic:
        enc_np = enc_np[:, list(SPARC_REORDER_FEATS)]  # (L, 14)
        dec_np = dec_np[:, list(SPARC_REORDER_FEATS)]
    np.save(path, np.vstack([enc_np.T, dec_np.T, input_map[None, :]]).astype(np.float32))
    return str(path)


def predict_frames(model, x, x_lengths, spk=None, device="cuda"):
    """Total predicted frames per sentence (sum of ceil durations), (B,)."""
    w = predict_lengths(model, x, x_lengths, spk, device)
    return torch.ceil(w[:, :, 0]).sum(dim=1)


def run_acoustic_inference(config: ExperimentConfig, model, dataset, save_dir: str,
                           n_timesteps: int = 50, temperature: float = 1.0,
                           length_scale: float = 1.0, use_align: bool = False, seed: int = 37,
                           max_frames_cap: int = 2048, solver: str = "euler",
                           device="cuda", kernel_bf16: bool = False) -> list:
    """Per-sample synthesis over `dataset`, saving the (29|161, T) npy
    contract. With `use_align` and an item's "durations" (aligned-input
    models) the bucket comes from the summed durations; otherwise one
    encoder pass sizes the bucket and feeds the decoder. `kernel_bf16` runs
    the score network's kernels in their bf16 mode (`infer/sampler.py`).
    Returns the saved paths."""
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
                solver=solver, kernel_bf16=kernel_bf16)
        else:
            mu_x, logw, x_mask, pf = encode_text(model, x, x_lengths, spk, device)
            pred_frames = min(max_frames_cap,
                              max(64, int(math.ceil(float(pf[0]) * length_scale - 1e-6))))
            max_frames = frame_bucket(min(fix_len_compatibility(pred_frames), max_frames_cap))
            enc, dec, attn, y_len = synthesize_from_encoding(
                model, generator, mu_x, logw, x_mask, n_timesteps, max_frames, temperature,
                length_scale=length_scale, device=device, spk=spk, solver=solver,
                kernel_bf16=kernel_bf16)
        saved.append(_save_artifact(save_dir / f"{_sample_id(dataset, index)}.npy", enc[0],
                                    dec[0], attn[0], int(y_len[0]), is_artic))
    return saved


def with_masked_norm(model):
    """`model` itself if its decoder takes padding-exact GroupNorm
    statistics, else a twin that does, sharing `model`'s parameters (no
    copy): `masked_norm` changes the computation only."""
    cfg = model.config
    if cfg.decoder.masked_norm:
        return model
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, masked_norm=True))
    with torch.device("meta"):
        twin = GradTTSModel(cfg)
    twin.load_state_dict(model.state_dict(), assign=True)
    return twin.train(model.training)


def run_acoustic_inference_batched(config: ExperimentConfig, model, dataset, save_dir: str,
                                   batch_size: int = 8, n_timesteps: int = 50,
                                   temperature: float = 1.0, seed: int = 37,
                                   max_frames_cap: int = 2048, solver: str = "euler",
                                   device="cuda", kernel_bf16: bool = False) -> list:
    """Batched synthesis (serving mode): items are ordered by input length,
    padded to shared text buckets (32 ... 512) and one frame bucket per
    batch, and synthesized `batch_size` sentences a call. `masked_norm` is
    turned on (`with_masked_norm`): padded batches need padding-exact
    GroupNorm statistics to match per-sentence synthesis. Aligned-input
    items ("durations") take their bucket from the summed durations, the
    others from one encoder pass. Writes the same (29|161, T) artifacts;
    returns their paths. The call is an `arttts.pipeline.acoustic` span
    holding one `arttts.pipeline.batch` a batch, whose artifact writes are
    its `arttts.pipeline.save`."""
    with span("arttts.pipeline.acoustic"):
        model = with_masked_norm(model)
        save_dir = Path(save_dir)
        save_dir.mkdir(parents=True, exist_ok=True)
        is_artic = config.model.n_feats == 16
        generator = torch.Generator(device=resolve(device)).manual_seed(seed)
        items = [dataset[i] for i in range(len(dataset))]
        order = sorted(range(len(items)), key=lambda i: items[i]["x"].shape[0])
        saved = []
        for start in range(0, len(order), batch_size):
            with span("arttts.pipeline.batch"):
                idx = order[start: start + batch_size]
                xs = [np.asarray(items[i]["x"]) for i in idx]
                B = len(xs)
                T_x = frame_bucket(max(x.shape[0] for x in xs),
                                   buckets=(32, 64, 128, 256, 512))
                x = np.zeros((B, T_x) + xs[0].shape[1:],
                             xs[0].dtype if xs[0].ndim == 1 else np.float32)
                for j, xi in enumerate(xs):
                    x[j, : xi.shape[0]] = xi
                x_lengths = torch.tensor([xi.shape[0] for xi in xs], dtype=torch.int32)
                spk = None
                if "spk" in items[idx[0]]:
                    spk = torch.as_tensor(np.stack([np.asarray(items[i]["spk"]) for i in idx]))
                kw = dict(n_timesteps=n_timesteps, temperature=temperature, device=device,
                          spk=spk, solver=solver, kernel_bf16=kernel_bf16)
                if "durations" in items[idx[0]]:  # aligned-input models (v6)
                    dur = np.zeros((B, T_x), np.float32)
                    for j, i in enumerate(idx):
                        d = np.ceil(np.asarray(items[i]["durations"]))
                        dur[j, : len(d)] = d
                    pred = int(dur.sum(axis=1).max())
                    max_frames = frame_bucket(min(fix_len_compatibility(max(pred, 64)),
                                                  max_frames_cap))
                    enc, dec, attn, y_len = synthesize(model, generator, x, x_lengths,
                                                       max_frames=max_frames, x_durations=dur,
                                                       **kw)
                else:  # one encoder pass sizes the batch's bucket and feeds the decoder
                    mu_x, logw, x_mask, pf = encode_text(model, x, x_lengths, spk, device)
                    pred = int(math.ceil(float(pf.max())))
                    max_frames = frame_bucket(min(fix_len_compatibility(max(pred, 64)),
                                                  max_frames_cap))
                    enc, dec, attn, y_len = synthesize_from_encoding(
                        model, generator, mu_x, logw, x_mask, max_frames=max_frames, **kw)
                with span("arttts.pipeline.save"):
                    for j, i in enumerate(idx):
                        saved.append(_save_artifact(
                            save_dir / f"{_sample_id(dataset, i)}.npy", enc[j], dec[j], attn[j],
                            int(y_len[j]), is_artic))
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


def run_mel_vocoder(vocoder, artifact_paths, save_dir: str, sample_rate: int = 22050,
                    device="cuda", kernel_bf16: bool = False) -> list:
    """Saved (161, T) mel artifacts -> wav through the `HiFiGANGenerator`
    `vocoder` on its fast path (vocoder_inference.py:137-141): fixed-shape
    windows of `vocode_chunked` over `hifigan_forward_fast` (K4, K5; K4 in
    its bf16 mode with `kernel_bf16`). An `arttts.pipeline.vocode` span
    holds one `arttts.pipeline.track` a track, which holds its
    `arttts.pipeline.load`, `arttts.vocode` and `arttts.pipeline.write`.
    Returns the saved paths."""
    check_module(vocoder, device)
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    saved = []
    with span("arttts.pipeline.vocode"):
        for p in artifact_paths:
            with span("arttts.pipeline.track"):
                with span("arttts.pipeline.load"):
                    _, dec, _ = split_acoustic_artifact(np.load(p), n_feats=80)
                wav = vocode_chunked(lambda c: hifigan_forward_fast(vocoder, c, kernel_bf16),
                                     dec.astype(np.float32), device=device)
                with span("arttts.pipeline.write"):
                    out = save_dir / (Path(p).stem + ".wav")
                    save_wav(out, wav, sample_rate)
                saved.append(str(out))
    return saved


def run_sparc_vocoder(generator, artifact_paths, spk_ft: np.ndarray, save_dir: str,
                      pitch_stats: tuple, loudness_stats: Optional[tuple] = None,
                      sample_rate: int = 16000, device="cuda",
                      kernel_bf16: bool = False) -> list:
    """Saved (29, T) articulatory artifacts -> wav through the
    `SpkSparcHiFiGANGenerator` `generator` on its fast path
    (hifigan_inference_ms.py:91-141; K4 in its bf16 mode with
    `kernel_bf16`), in spans as `run_mel_vocoder`'s. Returns the saved
    paths."""
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    saved = []
    with span("arttts.pipeline.vocode"):
        for p in artifact_paths:
            with span("arttts.pipeline.track"):
                with span("arttts.pipeline.load"):
                    _, dec, _ = split_acoustic_artifact(np.load(p), n_feats=14)
                    dec = denormalize_sparc_features(dec, pitch_stats, loudness_stats)
                # fixed-shape windows: one window shape serves every artifact length
                wav = vocode_sparc(generator, dec.astype(np.float32), spk_ft, device=device,
                                   bf16=kernel_bf16)
                with span("arttts.pipeline.write"):
                    out = save_dir / (Path(p).stem + ".wav")
                    save_wav(out, wav, sample_rate)
                saved.append(str(out))
    return saved
