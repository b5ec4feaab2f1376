"""GradTTS training loss (port of `grad_tts_loss` and its helpers in
`arttts_tpu/train/losses.py`).

The three parts: the duration loss against the alignment MAS finds, the
Gaussian prior loss of the aligned encoder output, and the diffusion loss of
the score network on a random fixed-size segment. MAS runs on the card on
the detached log-prior (kernel K6, `ops/mas.py:maximum_path`) and its path
carries no gradient. Layouts are the JAX package's: x (B, T_x) ids,
y (B, T_y, n_feats), masks (B, T, 1).

Every draw (dropout masks, segment offsets, diffusion time t, noise z) comes
from the one `torch.Generator` the caller passes, in that order. `pinned`
overrides the last three for parity tests. Whether the encoder's dropout
acts is the model's mode (`model.train()` / `model.eval()`).
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
from arttts_tpu_torch.ops.shape import duration_loss, sequence_mask


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


def prior_loss_fn(y, mu_y, y_mask, n_feats: int):
    """Gaussian prior negative log-likelihood per valid value."""
    loss = torch.sum(0.5 * ((y - mu_y) ** 2 + math.log(2 * math.pi)) * y_mask)
    return loss / (torch.sum(y_mask) * n_feats)


def grad_tts_loss(model, generator: Optional[torch.Generator], x, x_lengths, y, y_lengths,
                  out_size: Optional[int] = None, pinned=None):
    """(total, {"dur_loss", "prior_loss", "diff_loss"}) of one batch.

    `out_size` cuts a random segment of that many frames for the prior and
    diffusion parts (None: the full sequences, as validation runs).
    `pinned` is an optional (t, z, offsets) triple overriding the draws."""
    t_pin = z_pin = off_pin = None
    if pinned is not None:
        t_pin, z_pin, off_pin = pinned
    n_feats = model.config.n_feats
    dec = model.config.decoder

    mu_x, logw, x_mask = model.encode(x, x_lengths, generator=generator)
    y_mask = sequence_mask(y_lengths, y.shape[1]).to(mu_x.dtype)[:, :, None]

    # MAS on the detached log-prior; the path carries no gradient
    with torch.no_grad():
        log_prior, attn_mask = mas_log_prior(mu_x.detach(), y, x_mask, y_mask)
        attn = maximum_path(log_prior, attn_mask)  # (B, T_x, T_y)

    logw_hat = torch.log(1e-8 + torch.sum(attn, dim=-1))[:, :, None] * x_mask
    dur = duration_loss(logw, logw_hat, x_lengths)

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
    noise_est = model.estimate_noise(xt, y_seg_mask, mu_y, t)
    diff = diffusion_loss_from_estimate(noise_est, z, y_seg_mask, t, n_feats, dec.beta_min,
                                        dec.beta_max)
    prior = prior_loss_fn(y_seg, mu_y, y_seg_mask, n_feats)
    total = dur + prior + diff
    return total, {"dur_loss": dur, "prior_loss": prior, "diff_loss": diff}


def loss_for_model(name: str):
    """The loss of a model family."""
    if name == "grad_ttartic":
        raise NotImplementedError(
            "grad_ttartic_loss (the multi-speaker GradTTArtic model) is not ported yet: "
            "ROADMAP A8")
    return grad_tts_loss
