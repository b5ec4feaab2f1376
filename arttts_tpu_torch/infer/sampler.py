"""Reverse-diffusion sampling and text -> wav serving (port of
`arttts_tpu/infer/sampler.py`: its Euler, Heun and DPM-Solver++(2M) solvers
and its serving entries).

The JAX package traces the n-step loop into one program; here it is a
Python loop of score evaluations, each on the hand-written kernels for a
2D U-Net decoder, on the module for the 1D ones
(`models/unet2d_fast.make_score_fn`), and the vocoder runs its fast path
(`models/hifigan.py:hifigan_forward_fast`, on kernels K4 and K5). Output
lengths are static frame buckets with masking, as there. Random draws take
an explicit `torch.Generator` (the JAX `rng` keys); tensors keep the JAX
layouts: mel (B, T, 80), wav (B, T*256, 1).

Entry points take `device` (default "cuda") and place their inputs there;
the model and vocoder must already live on it. There is no fallback: with
no card, a "cuda" call raises. `spk` is a multi-speaker model's raw speaker
input (float pre-embeddings (B, 1024) for GradTTArtic, int ids otherwise),
as in the JAX signatures. `solver` picks Euler (`reverse_diffusion`, the
reference protocol), Heun (`reverse_diffusion_heun`, two evaluations a
step) or DPM-Solver++(2M) (`reverse_diffusion_dpm2m`, one a step); all
three call the same score function.

`mesh` (`parallel/mesh.py`) with a "model" axis of n > 1 runs the decode
sequence-parallel, as the JAX `synthesize(mesh=...)`: the diffusion state
is cut into n contiguous frame chunks, one a rank, after the path is built;
the solver's updates are local and the score function exchanges halos and
statistics (`models/unet2d_sp.py`); the output is gathered back, so every
rank returns the whole (B, max_frames, n_feats). Every rank must pass the
same inputs and a generator in the same state.

`kernel_bf16=True` runs the kernels (K1-K3 in the score network, K4 in the
vocoder) in the JAX kernels' bf16 mode, which the JAX package's TPU serving
path takes by default for K1-K3: bf16 operands in every product, float32
sums. It is a library argument, as `bf16` is in the JAX package; the
port's default stays float32 and no CLI sets it.

A request, an encoder pass, a decode (with its frames computed and kept),
each score evaluation and a vocoder pass are spans (`utils/profiling.py`):
seen in a profiler's trace while one records, a flag check otherwise.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from arttts_tpu_torch.core.device import check_module, resolve
from arttts_tpu_torch.models.diffusion_sde import get_noise
from arttts_tpu_torch.models.hifigan import hifigan_forward_fast
from arttts_tpu_torch.models.unet2d_fast import make_score_fn
from arttts_tpu_torch.ops.shape import fix_len_compatibility, generate_path, sequence_mask
from arttts_tpu_torch.parallel.mesh import Collectives, local_slice
from arttts_tpu_torch.utils.profiling import span


def _on(device, *tensors):
    dev = resolve(device)
    return [None if t is None else torch.as_tensor(t).to(dev) for t in tensors]


def _shards(mesh) -> int:
    """Ranks the frame axis is split over."""
    return 1 if mesh is None else mesh.shape["model"]


@torch.inference_mode()
def reverse_diffusion(model, z, mask, mu, n_timesteps: int, stoc: bool = False, spk=None,
                      generator: Optional[torch.Generator] = None, score_fn=None,
                      kernel_bf16: bool = False, mesh=None):
    """Euler reverse-SDE (stoc) or probability-flow ODE sampler.

    z, mu: (B, T, C); mask: (B, T, 1); with `mesh`, this rank's chunk of the
    frame axis. `generator` draws the stochastic increments (required with
    `stoc`), for the whole sequence, of which each rank keeps its chunk."""
    dec = model.config.decoder
    h = 1.0 / n_timesteps
    B = z.shape[0]
    T = z.shape[1] * _shards(mesh)
    if score_fn is None:
        score_fn = make_score_fn(model, T=T, kernel_bf16=kernel_bf16, mesh=mesh)
    if stoc and generator is None:
        raise ValueError("stoc=True needs a generator")
    xt = z * mask
    for i in range(n_timesteps):
        t = torch.full((B,), 1.0 - (i + 0.5) * h, dtype=z.dtype, device=z.device)
        noise_t = get_noise(t[:, None, None], dec.beta_min, dec.beta_max)
        with span("arttts.eval"):
            score = score_fn(xt, mask, mu, t, spk)
        if stoc:
            dxt_det = (0.5 * (mu - xt) - score) * noise_t * h
            eps = torch.randn((B, T, z.shape[2]), generator=generator, dtype=z.dtype,
                              device=z.device)
            if mesh is not None:
                eps = eps[:, local_slice(mesh, "model", T)]
            dxt = dxt_det + eps * torch.sqrt(noise_t * h)
        else:
            dxt = 0.5 * (mu - xt - score) * noise_t * h
        xt = (xt - dxt) * mask
    return xt


@torch.inference_mode()
def reverse_diffusion_heun(model, z, mask, mu, n_timesteps: int, spk=None, score_fn=None,
                           kernel_bf16: bool = False, mesh=None):
    """Second-order (Heun) probability-flow ODE sampler: the ODE of
    `reverse_diffusion` (stoc=False), dx/dt = -0.5 * beta(t) * (mu - x -
    score(x, t)), from t=1 to t=0 on a uniform midpoint grid, two score
    evaluations a step. `mesh` as `reverse_diffusion`."""
    dec = model.config.decoder
    h = 1.0 / n_timesteps
    B = z.shape[0]
    if score_fn is None:
        score_fn = make_score_fn(model, T=z.shape[1] * _shards(mesh), kernel_bf16=kernel_bf16,
                                 mesh=mesh)

    def drift(xt, t_scalar):
        t = torch.full((B,), t_scalar, dtype=z.dtype, device=z.device)
        beta = get_noise(t[:, None, None], dec.beta_min, dec.beta_max)
        with span("arttts.eval"):
            score = score_fn(xt, mask, mu, t, spk)
        return 0.5 * (mu - xt - score) * beta * h

    xt = z * mask
    for i in range(n_timesteps):
        t = 1.0 - (i + 0.5) * h
        k1 = drift(xt, t)
        x_mid = (xt - k1) * mask
        k2 = drift(x_mid, max(t - h, 0.5 * h))
        xt = (xt - 0.5 * (k1 + k2)) * mask
    return xt


def dpm2m_schedule(beta_min: float, beta_max: float, n_timesteps: int,
                   t_end: float = 1e-2) -> np.ndarray:
    """DPM-Solver++(2M)'s constants in float64, one row per update step
    (n_timesteps - 1 rows) plus the final denoise row: t_i, sigma_i,
    alpha_i, sigma_{i+1}/sigma_i, alpha_{i+1} * expm1(-h_i), a_i, b_i.

    The GradTTS SDE is VP around the encoder prior: with y = x - mu,
    alpha_t = exp(-0.5*Lambda(t)), sigma_t = sqrt(1 - exp(-Lambda(t))),
    Lambda the cumulative noise; the grid is uniform in log-SNR from t=1 to
    `t_end` (Lu et al. 2022, DPM-Solver++ Eq. 4.3)."""
    if n_timesteps < 2:
        raise ValueError("dpm solver needs n_timesteps >= 2")
    bmin, bmax = float(beta_min), float(beta_max)
    bd = bmax - bmin

    def lam_of_t(t):
        big_l = bmin * t + 0.5 * bd * t * t
        return np.log(np.exp(-0.5 * big_l) / np.sqrt(-np.expm1(-big_l)))

    lams = np.linspace(lam_of_t(1.0), lam_of_t(t_end), n_timesteps)
    # invert lambda -> t: Lambda = log(1 + e^{-2 lambda}); quadratic in t
    big_ls = np.logaddexp(0.0, -2.0 * lams)
    ts = (-bmin + np.sqrt(bmin * bmin + 2.0 * bd * big_ls)) / bd
    alphas = np.exp(-0.5 * big_ls)
    sigmas = np.sqrt(-np.expm1(-big_ls))
    hs = np.diff(lams)  # positive: lambda increases toward t=0
    n_upd = n_timesteps - 1
    a = np.ones(n_upd)
    b = np.zeros(n_upd)
    r = hs[:-1] / hs[1:]
    a[1:] = 1.0 + 1.0 / (2.0 * r)
    b[1:] = -1.0 / (2.0 * r)
    steps = np.stack([ts[:-1], sigmas[:-1], alphas[:-1], sigmas[1:] / sigmas[:-1],
                      alphas[1:] * np.expm1(-hs), a, b], axis=1)
    final = np.array([[ts[-1], sigmas[-1], alphas[-1], 0.0, 0.0, 0.0, 0.0]])
    return np.concatenate([steps, final])


@torch.inference_mode()
def reverse_diffusion_dpm2m(model, z, mask, mu, n_timesteps: int, spk=None,
                            t_end: float = 1e-2, score_fn=None, kernel_bf16: bool = False,
                            mesh=None):
    """DPM-Solver++(2M) for the probability-flow ODE: one score evaluation
    a step, multistep second order, with a first-order denoise-to-x0 final
    step. The model's score s gives the data prediction x0 = (y +
    sigma_t^2 * s) / alpha_t. `n_timesteps` counts evaluations (>= 2); the
    schedule is float64 NumPy (`dpm2m_schedule`), cast to z's type. `mesh`
    as `reverse_diffusion`."""
    consts = torch.as_tensor(
        dpm2m_schedule(model.config.decoder.beta_min, model.config.decoder.beta_max,
                       n_timesteps, t_end), dtype=z.dtype).tolist()
    B = z.shape[0]
    if score_fn is None:
        score_fn = make_score_fn(model, T=z.shape[1] * _shards(mesh), kernel_bf16=kernel_bf16,
                                 mesh=mesh)

    def score_x0(y, t_scalar, sig, alp):
        t = torch.full((B,), t_scalar, dtype=z.dtype, device=z.device)
        with span("arttts.eval"):
            s = score_fn((mu + y) * mask, mask, mu, t, spk)
        return (y + sig * sig * s) / alp

    y = (z - mu) * mask
    x0_prev = y
    for t_i, sig_i, alp_i, sig_ratio, alp_em1, a_i, b_i in consts[:-1]:
        x0 = score_x0(y, t_i, sig_i, alp_i)
        d = a_i * x0 + b_i * x0_prev
        y = (sig_ratio * y - alp_em1 * d) * mask
        x0_prev = x0
    t_n, sig_n, alp_n = consts[-1][:3]
    return (mu + score_x0(y, t_n, sig_n, alp_n)) * mask


@torch.inference_mode()
def _encode(model, x, x_lengths, spk, device):
    x, x_lengths, spk = _on(device, x, x_lengths, spk)
    check_module(model, device)
    mu_x, logw, x_mask = model.encode(x, x_lengths, spk)
    w = torch.exp(logw) * x_mask
    return mu_x, logw, x_mask, torch.ceil(w).sum(dim=(1, 2))


def encode_text(model, x, x_lengths, spk=None, device="cuda"):
    """One encoder pass: (mu_x, logw, x_mask, pred_frames) with pred_frames
    (B,) the summed ceil of the predicted durations (picks the bucket; one
    frame a token for a model without a duration predictor)."""
    with span("arttts.encode"):
        return _encode(model, x, x_lengths, spk, device)


@torch.inference_mode()
def predict_lengths(model, x, x_lengths, spk=None, device="cuda"):
    """Duration-only forward: w = exp(logw) * mask, (B, T_x, 1)."""
    x, x_lengths, spk = _on(device, x, x_lengths, spk)
    check_module(model, device)
    _, logw, x_mask = model.encode(x, x_lengths, spk)
    return torch.exp(logw) * x_mask


@torch.inference_mode()
def synthesize_from_encoding(model, generator: torch.Generator, mu_x, logw, x_mask,
                             n_timesteps: int, max_frames: int, temperature: float = 1.0,
                             stoc: bool = False, length_scale: float = 1.0,
                             x_durations=None, device="cuda", spk=None,
                             solver: str = "euler", kernel_bf16: bool = False, mesh=None):
    """Durations -> path -> mu_y -> z ~ N(mu_y, I/temperature) -> reverse
    diffusion (`solver` "heun" or "dpm"; any other name runs Euler, as the
    JAX package does). Returns (mu_y, dec, attn, y_lengths); mu_y and dec
    are (B, max_frames, n_feats), masked past y_lengths. With `mesh` (see
    the module note) `max_frames` must divide by its "model" axis."""
    with span("arttts.decode", frames_computed=mu_x.shape[0] * max_frames) as s:
        mu_x, logw, x_mask, x_durations, spk = _on(device, mu_x, logw, x_mask, x_durations,
                                                   spk)
        check_module(model, device)
        if x_durations is not None:
            w = x_durations[:, :, None] * x_mask
        else:
            w = torch.exp(logw) * x_mask
        w_ceil = torch.ceil(w) * length_scale
        y_lengths = torch.clamp(w_ceil.sum(dim=(1, 2)), 1, max_frames).to(torch.int32)
        s.count(frames_kept=y_lengths)
        y_mask = sequence_mask(y_lengths, max_frames).to(x_mask.dtype)[:, :, None]
        attn_mask = x_mask[:, :, 0:1] * y_mask[:, None, :, 0]
        attn = generate_path(w_ceil[:, :, 0], attn_mask)  # (B, T_x, max_frames)
        mu_y = torch.einsum("bij,bic->bjc", attn, mu_x)
        noise = torch.randn(mu_y.shape, generator=generator, dtype=mu_y.dtype,
                            device=mu_y.device)
        z = mu_y + noise / temperature
        kb = dict(kernel_bf16=kernel_bf16, mesh=mesh)
        z_l, m_l, mu_l = z, y_mask, mu_y
        if _shards(mesh) > 1:  # this rank's chunk of the frame axis
            cut = local_slice(mesh, "model", max_frames)
            z_l, m_l, mu_l = z[:, cut], y_mask[:, cut], mu_y[:, cut]
        if solver == "heun":
            dec = reverse_diffusion_heun(model, z_l, m_l, mu_l, n_timesteps, spk, **kb)
        elif solver == "dpm":
            dec = reverse_diffusion_dpm2m(model, z_l, m_l, mu_l, n_timesteps, spk, **kb)
        else:
            dec = reverse_diffusion(model, z_l, m_l, mu_l, n_timesteps, stoc, spk, generator,
                                    **kb)
        if _shards(mesh) > 1:
            dec = Collectives(mesh, "model").gather(dec, dim=1)
        return mu_y * y_mask, dec * y_mask, attn, y_lengths


@torch.inference_mode()
def synthesize(model, generator: torch.Generator, x, x_lengths, n_timesteps: int,
               max_frames: int, temperature: float = 1.0, stoc: bool = False,
               length_scale: float = 1.0, x_durations=None, device="cuda", spk=None,
               solver: str = "euler", kernel_bf16: bool = False, mesh=None):
    """Inputs (B, T_x) ids or (B, T_x, n_input_feats) traits -> (mu_y, dec,
    attn, y_lengths); `mesh` as `synthesize_from_encoding`."""
    x, x_lengths, spk = _on(device, x, x_lengths, spk)
    check_module(model, device)
    with span("arttts.encode"):
        mu_x, logw, x_mask = model.encode(x, x_lengths, spk)
    return synthesize_from_encoding(
        model, generator, mu_x, logw, x_mask, n_timesteps, max_frames, temperature,
        stoc, length_scale, x_durations, device, spk=spk, solver=solver,
        kernel_bf16=kernel_bf16, mesh=mesh,
    )


@torch.inference_mode()
def vocode(vocoder, mel, device="cuda", kernel_bf16: bool = False):
    """(B, T, 80) -> (B, T*256, 1) on the fast path
    (`models/hifigan.py:hifigan_forward_fast`: MRF stages on K4, stride-2
    upsamples on K5), as the JAX package's `_vocode` runs off the CPU."""
    with span("arttts.vocode"):
        (mel,) = _on(device, mel)
        check_module(vocoder, device)
        return hifigan_forward_fast(vocoder, mel, bf16=kernel_bf16)


@torch.inference_mode()
def synthesize_to_wav(model, vocoder, generator: torch.Generator, x, x_lengths,
                      n_timesteps: int, max_frames: int, temperature: float = 1.0,
                      stoc: bool = False, x_durations=None, device="cuda", spk=None,
                      solver: str = "euler", kernel_bf16: bool = False):
    """Text -> waveform: (wav (B, max_frames*256, 1), y_lengths)."""
    _, dec, _, y_lengths = synthesize(
        model, generator, x, x_lengths, n_timesteps, max_frames, temperature, stoc,
        x_durations=x_durations, device=device, spk=spk, solver=solver,
        kernel_bf16=kernel_bf16,
    )
    return vocode(vocoder, dec, device, kernel_bf16), y_lengths


@torch.inference_mode()
def synthesize_to_wav_from_encoding(model, vocoder, generator: torch.Generator, mu_x, logw,
                                    x_mask, n_timesteps: int, max_frames: int,
                                    temperature: float = 1.0, stoc: bool = False,
                                    x_durations=None, device="cuda", spk=None,
                                    solver: str = "euler", kernel_bf16: bool = False):
    """Decode + vocode from `encode_text`'s outputs: (wav, y_lengths)."""
    _, dec, _, y_lengths = synthesize_from_encoding(
        model, generator, mu_x, logw, x_mask, n_timesteps, max_frames, temperature, stoc,
        x_durations=x_durations, device=device, spk=spk, solver=solver,
        kernel_bf16=kernel_bf16,
    )
    return vocode(vocoder, dec, device, kernel_bf16), y_lengths


def frame_bucket(predicted_frames: int, buckets=(128, 256, 384, 512, 768, 1024)) -> int:
    """The smallest static bucket holding `predicted_frames`; past the last,
    the frame count rounded up to a multiple of 4."""
    for b in buckets:
        if predicted_frames <= b:
            return b
    return fix_len_compatibility(predicted_frames)


def serve_text_to_wav(model, vocoder, generator: torch.Generator, x, x_lengths,
                      n_timesteps: int = 50, temperature: float = 1.0, spk=None,
                      solver: str = "euler", max_frames_cap: int = 2048, device="cuda",
                      kernel_bf16: bool = False):
    """The request path: encode once, pick the smallest bucket holding the
    predicted length on the host, then decode and vocode (the spans
    `arttts.encode`, `arttts.decode`, `arttts.vocode` inside `arttts.request`).
    Returns (wav, y_lengths, bucket)."""
    with span("arttts.request"):
        with span("arttts.encode"):
            mu_x, logw, x_mask, pred = _encode(model, x, x_lengths, spk, device)
            pred_frames = int(math.ceil(float(pred.max())))
            bucket = frame_bucket(min(fix_len_compatibility(max(pred_frames, 4)),
                                      max_frames_cap))
        wav, y_lengths = synthesize_to_wav_from_encoding(
            model, vocoder, generator, mu_x, logw, x_mask, n_timesteps, bucket, temperature,
            device=device, spk=spk, solver=solver, kernel_bf16=kernel_bf16,
        )
        return wav, y_lengths, bucket
