"""Plain reference of the Grad-TTS 2D U-Net score network (Popov et al.
2021, the `GradLogPEstimator2d` of its public code) in float32: 3x3
convolutions, GroupNorm(8), mish, Rezero linear attention (4 heads of 32),
two stride-2 downsamples and two 4x4 transposed convolutions, and a speaker
plane for multi-speaker models.

The GroupNorm statistics are those the port takes at a frame bucket:
over valid frames only (`masked`) or over the whole image, with one-pass
moments (E[x^2] - E[x]^2), eps 1e-5 with `masked_norm` and 1e-6 without.
`masked_statistics` restates the port's rule for which it takes. State-dict
names are the port's; the module imports nothing of it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

GROUPS = 8
HEADS = 4
DIM_HEAD = 32
_MIB = 1024 * 1024


def mish(x):
    return x * torch.tanh(F.softplus(x))


def _tpu_vmem_fits(T: int, rows: int, n_in: int, lanes: int = 128) -> bool:
    if T % 64:
        return False
    usable = (100 - 12) * _MIB - rows * (2 * T + 16) * lanes * 4
    need = (13 + n_in) * rows * (64 + 16) * lanes * 4
    return usable >= need + 2 * _MIB


def masked_statistics(n_feats: int, masked_norm: bool, T: int) -> bool:
    """Whether the port's score network takes GroupNorm statistics over
    valid frames at frame bucket T (the flagship U-Net): always with
    `masked_norm`, else where the JAX package's TPU fast path would run,
    which the port reproduces (T a multiple of 256 that fits its budget)."""
    F_ = n_feats
    return masked_norm or (
        F_ % 4 == 0 and T % 256 == 0
        and _tpu_vmem_fits(T, F_ // 2, 1)
        and _tpu_vmem_fits(T // 2, F_ // 2, 2, 128)
        and _tpu_vmem_fits(T // 4, F_ // 4, 2, 256))


def group_norm(h, m, masked: bool, eps: float, weight, bias):
    B, C, H, T = h.shape
    hg = h.reshape(B, GROUPS, C // GROUPS, H, T)
    if masked:
        mg = m.reshape(B, 1, 1, 1, T)
        count = mg.sum(dim=(2, 3, 4)) * (C // GROUPS) * H
        s1 = (hg * mg).sum(dim=(2, 3, 4))
        s2 = (hg * hg * mg).sum(dim=(2, 3, 4))
    else:
        count = float((C // GROUPS) * H * T)
        s1 = hg.sum(dim=(2, 3, 4))
        s2 = (hg * hg).sum(dim=(2, 3, 4))
    mean = s1 / count
    var = torch.clamp(s2 / count - mean * mean, min=0.0)
    hn = (hg - mean[..., None, None, None]) * torch.rsqrt(var + eps)[..., None, None, None]
    return hn.reshape(B, C, H, T) * weight[:, None, None] + bias[:, None, None]


class Mish(nn.Module):
    def forward(self, x):
        return mish(x)


class GroupNorm(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))


class Block(nn.Module):
    def __init__(self, dim, dim_out):
        super().__init__()
        self.block = nn.ModuleList([nn.Conv2d(dim, dim_out, 3, padding=1), GroupNorm(dim_out)])

    def forward(self, x, mask, gn):
        conv, norm = self.block
        h = conv(x * mask)
        return mish(group_norm(h, mask, gn[0], gn[1], norm.weight, norm.bias)) * mask


class ResnetBlock(nn.Module):
    def __init__(self, dim, dim_out, time_emb_dim):
        super().__init__()
        self.mlp = nn.Sequential(Mish(), nn.Linear(time_emb_dim, dim_out))
        self.block1 = Block(dim, dim_out)
        self.block2 = Block(dim_out, dim_out)
        self.res_conv = nn.Conv2d(dim, dim_out, 1) if dim != dim_out else None

    def forward(self, x, mask, time_emb, gn):
        h = self.block1(x, mask, gn)
        h = h + self.mlp(time_emb)[:, :, None, None]
        h = self.block2(h, mask, gn)
        xm = x * mask
        return h + (xm if self.res_conv is None else self.res_conv(xm))


class LinearAttention(nn.Module):
    def __init__(self, dim):
        super().__init__()
        hidden = HEADS * DIM_HEAD
        self.to_qkv = nn.Conv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Conv2d(hidden, dim, 1)

    def forward(self, x):
        B, _, H, T = x.shape
        q, k, v = self.to_qkv(x).reshape(B, 3, HEADS, DIM_HEAD, H * T).unbind(1)
        k = torch.softmax(k, dim=-1)
        context = torch.einsum("bhdn,bhen->bhde", k, v)
        out = torch.einsum("bhde,bhdn->bhen", context, q)
        return self.to_out(out.reshape(B, HEADS * DIM_HEAD, H, T))


class Rezero(nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn
        self.g = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        return self.fn(x) * self.g


class Residual(nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x) + x


class Downsample(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.conv = nn.Conv2d(dim, dim, 3, 2, 1)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.conv = nn.ConvTranspose2d(dim, dim, 4, 2, 1)

    def forward(self, x):
        return self.conv(x)


def attention(dim):
    return Residual(Rezero(LinearAttention(dim)))


class GradLogPEstimator2d(nn.Module):
    def __init__(self, dim, dim_mults, n_spks, spk_emb_dim, n_feats, pe_scale):
        super().__init__()
        self.dim = dim
        self.pe_scale = pe_scale
        self.mlp = nn.Sequential(nn.Linear(dim, dim * 4), Mish(), nn.Linear(dim * 4, dim))
        self.n_spks = n_spks
        if n_spks > 1:
            self.spk_mlp = nn.Sequential(nn.Linear(spk_emb_dim, spk_emb_dim * 4), Mish(),
                                         nn.Linear(spk_emb_dim * 4, n_feats))
        dims = [3 if n_spks > 1 else 2] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        self.downs = nn.ModuleList()
        for ind, (d_in, d_out) in enumerate(in_out):
            last = ind >= len(in_out) - 1
            self.downs.append(nn.ModuleList([
                ResnetBlock(d_in, d_out, dim), ResnetBlock(d_out, d_out, dim),
                attention(d_out), nn.Identity() if last else Downsample(d_out)]))
        mid = dims[-1]
        self.mid_block1 = ResnetBlock(mid, mid, dim)
        self.mid_attn = attention(mid)
        self.mid_block2 = ResnetBlock(mid, mid, dim)
        self.ups = nn.ModuleList()
        for d_in, d_out in reversed(in_out[1:]):
            self.ups.append(nn.ModuleList([
                ResnetBlock(d_out * 2, d_in, dim), ResnetBlock(d_in, d_in, dim),
                attention(d_in), Upsample(d_in)]))
        self.final_block = Block(dim, dim)
        self.final_conv = nn.Conv2d(dim, 1, 1)

    def time_embedding(self, t):
        half = self.dim // 2
        freq = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                         * -(math.log(10000.0) / (half - 1)))
        emb = self.pe_scale * t.float()[:, None] * freq[None, :]
        return self.mlp(torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1))

    def forward(self, x, mask, mu, t, spk, gn):
        """x, mu (B, T, F); mask (B, T, 1); t (B,); spk (B, E) or None;
        gn = (masked statistics, eps). Returns (B, T, F)."""
        t_emb = self.time_embedding(t)
        planes = [mu.transpose(1, 2), x.transpose(1, 2)]
        if self.n_spks > 1:
            s = self.spk_mlp(spk)
            planes.append(s[:, :, None].expand_as(planes[0]))
        h = torch.stack(planes, dim=1)
        mask_img = mask.transpose(1, 2)[:, :, None, :]
        hiddens, masks = [], [mask_img]
        for r1, r2, attn, down in self.downs:
            m = masks[-1]
            h = r1(h, m, t_emb, gn)
            h = r2(h, m, t_emb, gn)
            h = attn(h)
            hiddens.append(h)
            if not isinstance(down, nn.Identity):
                h = down(h * m)
            masks.append(m[..., ::2])
        masks = masks[:-1]
        m_mid = masks[-1]
        h = self.mid_block1(h, m_mid, t_emb, gn)
        h = self.mid_attn(h)
        h = self.mid_block2(h, m_mid, t_emb, gn)
        for r1, r2, attn, up in self.ups:
            m = masks.pop()
            h = torch.cat([h, hiddens.pop()], dim=1)
            h = r1(h, m, t_emb, gn)
            h = r2(h, m, t_emb, gn)
            h = attn(h)
            h = up(h * m)
        h = self.final_block(h, mask_img, gn)
        out = self.final_conv(h * mask_img) * mask_img
        return out[:, 0].transpose(1, 2)
