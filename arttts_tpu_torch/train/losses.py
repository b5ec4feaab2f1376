"""Training losses of the Grad-TTS family (port of
`arttts_tpu/train/losses.py`: `grad_tts_loss`, `grad_ttartic_loss` and
their helpers).

`grad_tts_loss` (GradTTS, ArtTTS, AttentionTTS) has three parts: the
duration loss against the alignment MAS finds, the Gaussian prior loss of
the aligned encoder output, and the diffusion loss of the score network on
a random fixed-size segment. MAS runs on the card on the detached log-prior
(kernel K6, `ops/mas.py:maximum_path`) and its path carries no gradient.
`grad_ttartic_loss` (the multi-speaker GradTTArtic) takes its alignment
from the forced-alignment durations instead (`ops/shape.py:generate_path`):
no MAS, no duration loss. Both take the same arguments. Layouts are the
JAX package's: x (B, T_x) ids or (B, T_x, C) traits, y (B, T_y, n_feats),
masks (B, T, 1); spk (B,) ids or (B, E) pre-embeddings; durations
(B, T_x).

Every draw (dropout masks, segment offsets, diffusion time t, noise z) comes
from the one `torch.Generator` the caller passes, in that order. `pinned`
overrides the last three for parity tests. Whether the encoder's dropout
acts is the model's mode (`model.train()` / `model.eval()`).

Each part divides a sum over the batch by a count over the batch (tokens,
or valid frames times n_feats). A data-parallel step passes the counts of
the global batch (`denominators`, from `loss_denominators` summed over
the ranks), so each rank's parts are its share of the global batch's
loss, as the JAX package's sharded step computes it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from arttts_tpu_torch.models.diffusion_sde import (
    diffusion_loss_from_estimate,
    forward_diffusion,
    sample_t,
)
from arttts_tpu_torch.ops.mas import maximum_path
from arttts_tpu_torch.ops.shape import duration_loss, generate_path, sequence_mask


def mas_log_prior(mu_x, y, x_mask, y_mask):
    """Gaussian log-prior matrix for MAS. mu_x: (B, T_x, C); y: (B, T_y, C).
    Returns the (B, T_x, T_y) log-prior and the (B, T_x, T_y) attention mask."""
    n_feats = mu_x.shape[-1]
    const = -0.5 * math.log(2 * math.pi) * n_feats
    y_sq = -0.5 * torch.sum(y**2, dim=-1)[:, None, :]  # (B, 1, T_y)
    y_mu = torch.einsum("bic,bjc->bij", mu_x, y)  # (B, T_x, T_y)
    mu_sq = -0.5 * torch.sum(mu_x**2, dim=-1)[:, :, None]  # (B, T_x, 1)
    log_prior = y_sq + y_mu + mu_sq + const
    attn_mask = x_mask[:, :, 0:1] * y_mask[:, None, :, 0]
    return log_prior, attn_mask


def cut_segments(generator: Optional[torch.Generator], y, attn, y_lengths, out_size: int,
                 offsets=None):
    """Random `out_size`-frame decoder segments. y: (B, T_y, C); attn
    (B, T_x, T_y); T_y >= out_size (the data layer pads batches so).
    `offsets` (B,) overrides the draw; `generator` may then be None. As the
    JAX `dynamic_slice`, an offset is clamped to [0, T_y - out_size].
    Returns (y_cut, attn_cut, y_cut_mask)."""
    B, T_y, C = y.shape
    if T_y < out_size:
        raise ValueError(f"{T_y} frames cannot hold a segment of {out_size}")
    if offsets is None:
        max_offset = torch.clamp(y_lengths - out_size, min=0)
        u = torch.rand(B, generator=generator, dtype=y.dtype, device=y.device)
        offsets = torch.floor(u * max_offset.to(u.dtype))
    offsets = torch.as_tensor(offsets, device=y.device).long().clamp(0, T_y - out_size)
    idx = offsets[:, None] + torch.arange(out_size, device=y.device)  # (B, out_size)
    y_cut = torch.gather(y, 1, idx[:, :, None].expand(B, out_size, C))
    attn_cut = torch.gather(attn, 2, idx[:, None, :].expand(B, attn.shape[1], out_size))
    y_cut_lengths = torch.clamp(y_lengths, max=out_size)
    y_cut_mask = sequence_mask(y_cut_lengths, out_size).to(y.dtype)[:, :, None]
    return y_cut * y_cut_mask, attn_cut * y_cut_mask[:, None, :, 0], y_cut_mask


def prior_loss_fn(y, mu_y, y_mask, n_feats: int, denominator=None):
    """Gaussian prior negative log-likelihood per valid value (over
    `denominator` values when given)."""
    loss = torch.sum(0.5 * ((y - mu_y) ** 2 + math.log(2 * math.pi)) * y_mask)
    return loss / (torch.sum(y_mask) * n_feats if denominator is None else denominator)


def loss_denominators(x_lengths, y_lengths, out_size: Optional[int], n_feats: int):
    """The counts the parts divide by, from the batch alone: (tokens, valid
    values), the values those of the `out_size`-frame segments (the whole
    sequences when None) times n_feats. float32 (2,)."""
    frames = y_lengths if out_size is None else torch.clamp(y_lengths, max=out_size)
    return torch.stack([x_lengths.sum(), frames.sum() * n_feats]).to(torch.float32)


def _prior_and_diffusion(model, generator, mu_x, y, y_lengths, y_mask, attn, spk,
                         out_size, pinned, values=None):
    """The parts both losses share, after the alignment: the segment cut,
    the aligned prior mu_y, and the diffusion and prior losses over
    `values` valid values (None: this batch's). Returns (prior, diff)."""
    t_pin = z_pin = off_pin = None
    if pinned is not None:
        t_pin, z_pin, off_pin = pinned
    n_feats = model.config.n_feats
    dec = model.config.decoder
    if out_size is not None:
        y_seg, attn_seg, y_seg_mask = cut_segments(generator, y, attn, y_lengths, out_size,
                                                   offsets=off_pin)
    else:
        y_seg, attn_seg, y_seg_mask = y, attn, y_mask

    mu_y = torch.einsum("bij,bic->bjc", attn_seg, mu_x)  # (B, T_seg, C)
    if t_pin is None:
        t = sample_t(generator, y.shape[0], dtype=mu_x.dtype, device=mu_x.device)
    else:
        t = t_pin
    xt, z = forward_diffusion(generator, y_seg, y_seg_mask, mu_y, t, dec.beta_min,
                              dec.beta_max, z=z_pin)
    noise_est = model.estimate_noise(xt, y_seg_mask, mu_y, t, spk)
    diff = diffusion_loss_from_estimate(noise_est, z, y_seg_mask, t, n_feats, dec.beta_min,
                                        dec.beta_max, values)
    prior = prior_loss_fn(y_seg, mu_y, y_seg_mask, n_feats, values)
    return prior, diff


def grad_tts_loss(model, generator: Optional[torch.Generator], x, x_lengths, y, y_lengths,
                  spk=None, durations=None, out_size: Optional[int] = None, pinned=None,
                  denominators=None):
    """(total, {"dur_loss", "prior_loss", "diff_loss"}) of one batch.

    `spk` is a multi-speaker model's raw speaker input (None otherwise).
    `durations` is not used (MAS finds the alignment); it keeps the
    signature of `grad_ttartic_loss`. `out_size` cuts a random segment of
    that many frames for the prior and diffusion parts (None: the full
    sequences, as validation runs). `pinned` is an optional
    (t, z, offsets) triple overriding the draws. `denominators` (tokens,
    values) replaces this batch's counts (see the module note)."""
    tokens, values = (None, None) if denominators is None else denominators
    mu_x, logw, x_mask = model.encode(x, x_lengths, spk, generator=generator)
    y_mask = sequence_mask(y_lengths, y.shape[1]).to(mu_x.dtype)[:, :, None]

    # MAS on the detached log-prior; the path carries no gradient
    with torch.no_grad():
        log_prior, attn_mask = mas_log_prior(mu_x.detach(), y, x_mask, y_mask)
        attn = maximum_path(log_prior, attn_mask)  # (B, T_x, T_y)

    logw_hat = torch.log(1e-8 + torch.sum(attn, dim=-1))[:, :, None] * x_mask
    dur = duration_loss(logw, logw_hat, x_lengths, tokens)
    prior, diff = _prior_and_diffusion(model, generator, mu_x, y, y_lengths, y_mask, attn, spk,
                                       out_size, pinned, values)
    total = dur + prior + diff
    return total, {"dur_loss": dur, "prior_loss": prior, "diff_loss": diff}


def grad_ttartic_loss(model, generator: Optional[torch.Generator], x, x_lengths, y,
                      y_lengths, spk=None, durations=None, out_size: Optional[int] = None,
                      pinned=None, denominators=None):
    """(total, {"prior_loss", "diff_loss"}) of one batch of the aligned-input
    multi-speaker model: the alignment is the 0/1 path of `durations`
    (B, T_x) frame counts from the forced alignments (input channel 26), so
    there is no MAS and no duration loss. Arguments as `grad_tts_loss`."""
    if durations is None:
        raise ValueError("grad_ttartic_loss needs aligned durations")
    mu_x, _, x_mask = model.encode(x, x_lengths, spk, generator=generator)
    y_mask = sequence_mask(y_lengths, y.shape[1]).to(mu_x.dtype)[:, :, None]
    attn_mask = x_mask[:, :, 0:1] * y_mask[:, None, :, 0]
    attn = generate_path(durations, attn_mask)
    values = None if denominators is None else denominators[1]
    prior, diff = _prior_and_diffusion(model, generator, mu_x, y, y_lengths, y_mask, attn, spk,
                                       out_size, pinned, values)
    return prior + diff, {"prior_loss": prior, "diff_loss": diff}


def loss_for_model(name: str):
    """The loss of a model family (`ModelConfig.name`), as the JAX
    package's `loss_for_model` maps it."""
    return grad_ttartic_loss if name == "grad_ttartic" else grad_tts_loss
