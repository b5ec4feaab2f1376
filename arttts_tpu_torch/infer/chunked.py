"""Fixed-shape chunked vocoding for feature tracks of any length (port of
`arttts_tpu/infer/chunked.py`).

A track is vocoded through overlapping windows of one static shape
`(win_batch, chunk + 2*halo, C)`, stitched exactly: HiFi-GAN is fully
convolutional, so an output sample depends only on input frames within the
generator's receptive radius R (about 13 frames for the stock layout). Each
window keeps only output frames at least `halo >= R` frames from any window
edge that is not a true sequence edge. A track no longer than one window is
placed twice in a (2, W, C) batch, flush left and flush right, and stitched
at T - min(halo, T // 2): exact whenever that margin is >= R.

The SPARC entry of the port is `vocode_sparc`: `vocode_chunked` over
`models/hifigan.py:spk_sparc_forward_fast` (the FiLM-MRF stages on K4, the
stride-2 upsamples on K5). Numpy in, numpy out, as in the JAX package; each
window batch is placed on `device` (default "cuda", no fallback).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from arttts_tpu_torch.core.device import check_module, resolve
from arttts_tpu_torch.models.hifigan import spk_sparc_forward_fast
from arttts_tpu_torch.utils.profiling import span

HOP = 256  # prod(upsample_rates) for both generator families


def _window_starts(T: int, chunk: int, halo: int) -> tuple:
    W = chunk + 2 * halo
    n = -(-T // chunk)
    starts, keeps = [], []
    for i in range(n):
        s = min(max(i * chunk - halo, 0), T - W)
        k = min(chunk, T - i * chunk)
        starts.append(s)
        keeps.append((i * chunk, i * chunk - s, k))  # (global, local, len)
    return starts, keeps


def vocode_chunked(
    apply_fn: Callable,
    feats: np.ndarray,
    spk: Optional[np.ndarray] = None,
    chunk: int = 512,
    halo: int = 32,
    win_batch: int = 8,
    hop: int = HOP,
    device="cuda",
) -> np.ndarray:
    """Vocode a (T, C) feature track of any length to a (T*hop,) waveform.

    apply_fn(c[, spk]) -> (B, W*hop, 1) takes float32 tensors on `device`:
    c (B, W, C) with W = chunk + 2*halo, B = win_batch (or 2 for a track no
    longer than W), and `spk` broadcast to (B, spk.size). The whole track
    is one `arttts.vocode` span (`utils/profiling.py:span`)."""
    with span("arttts.vocode"):
        T, C = feats.shape
        W = chunk + 2 * halo
        dev = resolve(device)

        def call(batch, nb):
            c = torch.as_tensor(batch, dtype=torch.float32, device=dev)
            if spk is None:
                out = apply_fn(c)
            else:
                s = torch.as_tensor(np.asarray(spk, np.float32).reshape(1, -1), device=dev)
                out = apply_fn(c, s.expand(nb, -1).contiguous())
            return out[..., 0].cpu().numpy()

        if T <= W:  # two placements of one static window; stitch head + tail
            m = min(halo, T // 2)
            batch = np.zeros((2, W, C), feats.dtype)
            batch[0, :T] = feats  # flush-left: true left edge
            batch[1, W - T:] = feats  # flush-right: true right edge
            wav = call(batch, 2)
            return np.concatenate([wav[0, : (T - m) * hop], wav[1, (W - m) * hop:]])

        starts, keeps = _window_starts(T, chunk, halo)
        windows = np.stack([feats[s: s + W] for s in starts])
        n = len(starts)
        out = np.empty(T * hop, feats.dtype)
        for g0 in range(0, n, win_batch):
            grp = windows[g0: g0 + win_batch]
            nb = grp.shape[0]
            if nb < win_batch:  # pad the last group to the static batch shape
                grp = np.concatenate([grp, np.zeros((win_batch - nb, W, C), feats.dtype)])
            wav = call(grp, win_batch)
            for j in range(nb):
                g, l, k = keeps[g0 + j]
                out[g * hop: (g + k) * hop] = wav[j, l * hop: (l + k) * hop]
        return out


def vocode_sparc(module, feats: np.ndarray, spk_ft: np.ndarray, device="cuda",
                 bf16: bool = False, **kwargs) -> np.ndarray:
    """A (T, 14) articulatory track -> (T*256,) waveform through the SPARC
    generator's fast path: the vocoding body of the JAX package's
    `infer/pipeline.py:run_sparc_vocoder`. `module` is a
    `SpkSparcHiFiGANGenerator` living on `device`; `bf16` runs K4 in its
    bf16 mode; `kwargs` go to `vocode_chunked` (chunk, halo, win_batch)."""
    check_module(module, device)
    mode = {"bf16": True} if bf16 else {}
    return vocode_chunked(lambda c, s: spk_sparc_forward_fast(module, c, s, **mode), feats,
                          spk=spk_ft, device=device, **kwargs)
