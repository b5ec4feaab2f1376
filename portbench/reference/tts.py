"""Plain reference of the acoustic model and its three uses in the cells:
one request (encode, durations, bucket, Euler probability-flow ODE), a
batch of aligned multi-speaker items, and the Grad-TTS training loss with
monotonic alignment search in NumPy.

It follows Grad-TTS (Popov et al. 2021, arXiv:2105.06337) as the port runs
it; where the port makes a choice of its own (frame buckets, which GroupNorm
statistics at which bucket, how a batch is ordered and padded), this file
restates the choice and works it out again from the inputs. It imports
nothing of the port.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from portbench.reference.encoder import Encoder, sequence_mask
from portbench.reference.unet import GradLogPEstimator2d, masked_statistics

FRAME_BUCKETS = (128, 256, 384, 512, 768, 1024)
TEXT_BUCKETS = (32, 64, 128, 256, 512)


def fix_len(length: int) -> int:
    return ((int(length) + 3) // 4) * 4


def frame_bucket(frames: int, buckets=FRAME_BUCKETS) -> int:
    for b in buckets:
        if frames <= b:
            return b
    return fix_len(frames)


class SpeakerFT(nn.Module):
    def __init__(self, c_in=1024, c_out=64):
        super().__init__()
        self.spk_fc = nn.Sequential(nn.Linear(c_in, c_in), nn.GELU(), nn.Identity(),
                                    nn.Linear(c_in, c_out))

    def forward(self, x):
        return self.spk_fc(x)


class _Decoder(nn.Module):
    def __init__(self, est):
        super().__init__()
        self.estimator = est


class AcousticModel(nn.Module):
    """`cfg` is the configuration file's "model" group."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        dec = cfg["decoder"]
        self.encoder = Encoder(cfg["encoder"], cfg["n_feats"], cfg["n_spks"], cfg["spk_emb_dim"])
        self.decoder = _Decoder(GradLogPEstimator2d(
            dec["dim"], tuple(dec["dim_mults"]), cfg["n_spks"], cfg["spk_emb_dim"],
            cfg["n_feats"], dec["pe_scale"]))
        self.multi = cfg["name"] == "grad_ttartic"
        if self.multi:
            self.spk_enc = SpeakerFT(cfg["spk_preemb_dim"], cfg["spk_emb_dim"])

    def speaker(self, spk):
        return self.spk_enc(spk.float()) if self.multi and spk is not None else None

    def gn(self, T: int, masked_norm: bool):
        dec = self.cfg["decoder"]
        masked_norm = masked_norm or dec["masked_norm"]
        return (masked_statistics(self.cfg["n_feats"], masked_norm, T),
                1e-5 if masked_norm else 1e-6)

    def score(self, xt, mask, mu, t, spk_emb, gn):
        return self.decoder.estimator(xt, mask, mu, t, spk_emb, gn)


def generate_path(duration, mask):
    cum = torch.cumsum(duration, dim=1)
    pos = torch.arange(mask.shape[-1], device=duration.device, dtype=cum.dtype)
    path = (pos[None, None, :] < cum[:, :, None]).to(mask.dtype)
    prev = torch.nn.functional.pad(path, (0, 0, 1, 0))[:, :-1]
    return (path - prev) * mask


def euler(model, z, mask, mu, n_steps: int, spk_emb, gn):
    """Probability-flow ODE from t = 1 to 0 on a midpoint grid."""
    dec = model.cfg["decoder"]
    bmin, bmax = dec["beta_min"], dec["beta_max"]
    h = 1.0 / n_steps
    B = z.shape[0]
    xt = z * mask
    for i in range(n_steps):
        t = torch.full((B,), 1.0 - (i + 0.5) * h, dtype=z.dtype, device=z.device)
        beta = bmin + (bmax - bmin) * t[:, None, None]
        score = model.score(xt, mask, mu, t, spk_emb, gn)
        xt = (xt - 0.5 * (mu - xt - score) * beta * h) * mask
    return xt


def decode(model, mu_x, x_mask, w_ceil, frames: int, noise_fn, n_steps: int, spk_emb,
           masked_norm: bool = False):
    """Durations -> path -> prior -> z = prior + noise -> Euler. Returns
    (dec (B, frames, F) masked, y_lengths, attn)."""
    y_lengths = torch.clamp(w_ceil.sum(dim=(1, 2)), 1, frames).to(torch.int32)
    y_mask = sequence_mask(y_lengths, frames).to(x_mask.dtype)[:, :, None]
    attn = generate_path(w_ceil[:, :, 0], x_mask[:, :, 0:1] * y_mask[:, None, :, 0])
    mu_y = torch.einsum("bij,bic->bjc", attn, mu_x)
    z = mu_y + noise_fn(mu_y.shape)
    dec = euler(model, z, y_mask, mu_y, n_steps, spk_emb, model.gn(frames, masked_norm))
    return dec * y_mask, y_lengths, attn


@torch.no_grad()
def serve_request(model, x, n_steps: int, noise_fn, cap: int = 2048):
    """One request at B=1: the bucket is the smallest holding the summed
    ceil of the predicted durations. Returns (dec (1, bucket, F), y_len,
    bucket)."""
    x_lengths = torch.tensor([x.shape[1]], dtype=torch.int32, device=x.device)
    mu_x, logw, x_mask = model.encoder(x, x_lengths)
    w_ceil = torch.ceil(torch.exp(logw) * x_mask)
    pred = int(math.ceil(float(w_ceil.sum())))
    bucket = frame_bucket(min(fix_len(max(pred, 4)), cap))
    dec, y_len, _ = decode(model, mu_x, x_mask, w_ceil, bucket, noise_fn, n_steps, None)
    return dec, int(y_len[0]), bucket


def batch_plan(lengths, durations, batch_size: int, cap: int = 2048):
    """The port's batched serving plan, worked out again: items ordered by
    input length (stable), cut into batches, each padded to a text bucket
    and one frame bucket from its summed durations. Returns a list of
    (item indices, T_x, frames)."""
    order = sorted(range(len(lengths)), key=lambda i: lengths[i])
    plan = []
    for s in range(0, len(order), batch_size):
        idx = order[s: s + batch_size]
        t_x = frame_bucket(max(lengths[i] for i in idx), TEXT_BUCKETS)
        pred = int(max(np.ceil(durations[i]).sum() for i in idx))
        plan.append((idx, t_x, frame_bucket(min(fix_len(max(pred, 64)), cap))))
    return plan


@torch.no_grad()
def aligned_item(model, x, dur, spk, t_x: int, frames: int, n_steps: int, noise):
    """One aligned multi-speaker item at its batch's text and frame buckets
    (B=1; masked statistics make it independent of the batch's other
    rows). x (T, C), dur (T,), spk (E,); noise (frames, F), its row of the
    batch's draw. Returns (enc (L, F), dec (L, F), attn (T_x, L))."""
    dev = noise.device
    n = x.shape[0]
    xp = torch.zeros((1, t_x, x.shape[1]), dtype=torch.float32, device=dev)
    xp[0, :n] = x
    dp = torch.zeros((1, t_x), dtype=torch.float32, device=dev)
    dp[0, :n] = torch.ceil(dur)
    x_lengths = torch.tensor([n], dtype=torch.int32, device=dev)
    spk_emb = model.speaker(spk[None])
    mu_x, _, x_mask = model.encoder(xp, x_lengths, None, spk_emb)
    w_ceil = dp[:, :, None] * x_mask
    y_lengths = torch.clamp(w_ceil.sum(dim=(1, 2)), 1, frames).to(torch.int32)
    y_mask = sequence_mask(y_lengths, frames).to(x_mask.dtype)[:, :, None]
    attn = generate_path(w_ceil[:, :, 0], x_mask[:, :, 0:1] * y_mask[:, None, :, 0])
    mu_y = torch.einsum("bij,bic->bjc", attn, mu_x)
    dec = euler(model, mu_y + noise[None], y_mask, mu_y, n_steps, spk_emb,
                model.gn(frames, True))
    L = int(y_lengths[0])
    return (mu_y * y_mask)[0, :L], (dec * y_mask)[0, :L], attn[0, :, :L]


# ---------------------------------------------------------------- training
def mas_numpy(value: np.ndarray, t_xs, t_ys, neg: float = -1e9) -> np.ndarray:
    """Monotonic alignment search (Glow-TTS), one (B, T_x) column of the
    max-plus DP per frame in float32, then the backtrace with the strict
    `<` of the reference's Cython loop. value (B, T_x, T_y) float32,
    already masked. Returns the 0/1 path."""
    B, T_x, T_y = value.shape
    xs = np.arange(T_x)[None, :]
    t_x = np.asarray(t_xs, np.int64)[:, None]
    t_y = np.asarray(t_ys, np.int64)[:, None]
    neg32 = np.float32(neg)
    prev = np.zeros((B, T_x), np.float32)
    dec = np.zeros((B, T_x, T_y), bool)
    for y in range(T_y):
        in_band = (xs >= np.maximum(t_x + y - t_y, 0)) & (xs < np.minimum(t_x, y + 1))
        v_cur = np.where(xs == y, neg32, prev)
        shifted = np.concatenate([np.full((B, 1), neg32), prev[:, :-1]], axis=1)
        v_prev = np.where(xs == 0, np.float32(0.0 if y == 0 else neg), shifted)
        dec[:, :, y] = (xs != 0) & ((xs == y) | ((y > 0) & (prev < shifted)))
        v_in = value[:, :, y]
        prev = np.where(in_band, np.maximum(v_cur, v_prev) + v_in, v_in).astype(np.float32)
    path = np.zeros((B, T_x, T_y), np.float32)
    rows = np.arange(B)
    index = np.maximum(np.asarray(t_xs, np.int64) - 1, 0)
    t_ys = np.asarray(t_ys)
    for y in range(T_y - 1, -1, -1):
        active = t_ys > y
        path[rows[active], index[active], y] = 1.0
        index = np.where(active & dec[rows, index, y], index - 1, index)
    return path


def train_loss(model, generator, batch, out_size: int):
    """The Grad-TTS loss of one batch with its pinned draws (segment
    offsets, diffusion times, noise) and the encoder's dropout drawn from
    `generator`. Returns (total, {dur, prior, diff})."""
    dec = model.cfg["decoder"]
    bmin, bmax = dec["beta_min"], dec["beta_max"]
    n_feats = model.cfg["n_feats"]
    x, xl, y, yl = batch["x"], batch["x_lengths"], batch["y"], batch["y_lengths"]
    t, z, off = batch["pinned_t"], batch["pinned_z"], batch["pinned_offsets"]
    mu_x, logw, x_mask = model.encoder(x, xl, generator)
    y_mask = sequence_mask(yl, y.shape[1]).to(mu_x.dtype)[:, :, None]
    with torch.no_grad():
        mx = mu_x.detach()
        log_prior = (-0.5 * torch.sum(y ** 2, dim=-1)[:, None, :]
                     + torch.einsum("bic,bjc->bij", mx, y)
                     - 0.5 * torch.sum(mx ** 2, dim=-1)[:, :, None]
                     - 0.5 * math.log(2 * math.pi) * n_feats)
        attn_mask = x_mask[:, :, 0:1] * y_mask[:, None, :, 0]
        value = (log_prior * attn_mask).float().cpu().numpy()
        t_xs = attn_mask[:, :, 0].sum(1).to(torch.int32).cpu().numpy()
        t_ys = attn_mask[:, 0, :].sum(1).to(torch.int32).cpu().numpy()
        attn = torch.as_tensor(mas_numpy(value, t_xs, t_ys), device=y.device)
    logw_hat = torch.log(1e-8 + torch.sum(attn, dim=-1))[:, :, None] * x_mask
    dur = torch.sum((logw - logw_hat) ** 2) / torch.sum(xl)
    B, T_y, C = y.shape
    off = off.long().clamp(0, T_y - out_size)
    idx = off[:, None] + torch.arange(out_size, device=y.device)
    y_seg = torch.gather(y, 1, idx[:, :, None].expand(B, out_size, C))
    attn_seg = torch.gather(attn, 2, idx[:, None, :].expand(B, attn.shape[1], out_size))
    seg_mask = sequence_mask(torch.clamp(yl, max=out_size), out_size).to(y.dtype)[:, :, None]
    y_seg, attn_seg = y_seg * seg_mask, attn_seg * seg_mask[:, None, :, 0]
    mu_y = torch.einsum("bij,bic->bjc", attn_seg, mu_x)
    cum = (bmin * t + 0.5 * (bmax - bmin) * t ** 2)[:, None, None]
    mean = y_seg * torch.exp(-0.5 * cum) + mu_y * (1.0 - torch.exp(-0.5 * cum))
    xt = (mean + z * torch.sqrt(1.0 - torch.exp(-cum))) * seg_mask
    zm = z * seg_mask
    masked = dec["masked_norm"]  # the module path's statistics, at every length
    est = model.score(xt, seg_mask, mu_y, t, None, (masked, 1e-5 if masked else 1e-6))
    values = torch.sum(seg_mask) * n_feats
    diff = torch.sum((est * torch.sqrt(1.0 - torch.exp(-cum)) + zm) ** 2) / values
    prior = torch.sum(0.5 * ((y_seg - mu_y) ** 2 + math.log(2 * math.pi)) * seg_mask) / values
    return dur + prior + diff, {"dur_loss": dur, "prior_loss": prior, "diff_loss": diff}


class Adam:
    """Adam (Kingma and Ba 2015) written out, after a clip of each top-level
    group's gradients to `clip` (encoder, decoder; speaker modules not)."""

    def __init__(self, model, lr: float, clip: float, b1=0.9, b2=0.999, eps=1e-8):
        self.model, self.lr, self.clip = model, lr, clip
        self.b1, self.b2, self.eps = b1, b2, eps
        self.m = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
        self.v = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
        self.t = 0

    def load(self, m: dict, v: dict, t: int):
        """Start from moments `m`, `v` (by parameter name) after `t` steps."""
        self.m = {n: m[n].clone() for n in self.m}
        self.v = {n: v[n].clone() for n in self.v}
        self.t = t

    @torch.no_grad()
    def step(self):
        """Clip, then update. Returns the clipped gradients by name."""
        for name, child in self.model.named_children():
            if name in ("spk_enc", "spk_emb"):
                continue
            ps = [p for p in child.parameters() if p.grad is not None]
            norm = torch.sqrt(sum(torch.sum(p.grad ** 2) for p in ps))
            scale = torch.clamp(self.clip / (norm + 1e-6), max=1.0)
            for p in ps:
                p.grad.mul_(scale)
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        grads = {}
        for n, p in self.model.named_parameters():
            g = p.grad
            grads[n] = g.clone()
            self.m[n].lerp_(g, 1 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[n].sqrt() / math.sqrt(c2)).add_(self.eps)
            p.addcdiv_(self.m[n], denom, value=-self.lr / c1)
        return grads
