"""2D U-Net score estimator, module path (port of
`arttts_tpu/models/unet2d.py:GradLogPEstimator2d` and its blocks).

This is the plain version of the score network: `F.conv2d`, GroupNorm and
the linear attention written out in PyTorch. The serving path runs the same
network through the hand-written kernels instead
(`models/unet2d_fast.py`); this module holds the parameters both use.

Images are (B, C, H, T) with H the n_feats rows and T the frames; masks
(B, 1, 1, T). Parameter names are the reference's torch state-dict names
(`downs.{l}.{0,1}.block1.block.0`, `mid_attn.fn.fn.to_qkv`, `ups.{u}.3.conv`,
...), the names `arttts_tpu/utils/torch_convert_acoustic.py` reads.
The public forward keeps the JAX layout: x, mu (B, T, n_feats), mask (B, T, 1).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from arttts_tpu_torch.models.convs import ConvTranspose2dTorch
from arttts_tpu_torch.ops.resblock2d import DIM_HEAD, HEADS, group_norm, mish


class Mish(nn.Module):
    def forward(self, x):
        return mish(x)


class SinusoidalPosEmb(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t, scale: float = 1000.0):
        """(B,) -> (B, dim); phases in float32 whatever t's type."""
        half = self.dim // 2
        freq = torch.exp(
            torch.arange(half, dtype=torch.float32, device=t.device)
            * -(math.log(10000.0) / (half - 1))
        )
        emb = scale * t.float()[:, None] * freq[None, :]
        return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)


class GroupNorm(nn.Module):
    """GroupNorm with statistics over valid frames only (`masked`, the JAX
    `MaskedGroupNorm`, eps 1e-5) or over the whole image (flax
    `nn.GroupNorm`, eps 1e-6)."""

    def __init__(self, groups: int, channels: int, masked: bool):
        super().__init__()
        self.groups = groups
        self.masked = masked
        self.eps = 1e-5 if masked else 1e-6
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, h, mask):
        return group_norm(h, mask, self.masked, self.eps, self.weight, self.bias)


class Block(nn.Module):
    """conv3x3 -> GroupNorm -> mish, masked in and out."""

    def __init__(self, dim: int, dim_out: int, groups: int = 8, masked: bool = False):
        super().__init__()
        self.block = nn.ModuleList(
            [nn.Conv2d(dim, dim_out, 3, padding=1), GroupNorm(groups, dim_out, masked)]
        )

    def forward(self, x, mask):
        conv, norm = self.block
        return mish(norm(conv(x * mask), mask)) * mask


class ResnetBlock(nn.Module):
    """Two blocks, the time embedding added between them, and an identity
    or 1x1-conv residual of the masked input."""

    def __init__(self, dim: int, dim_out: int, time_emb_dim: int, groups: int = 8,
                 masked: bool = False):
        super().__init__()
        self.mlp = nn.Sequential(Mish(), nn.Linear(time_emb_dim, dim_out))
        self.block1 = Block(dim, dim_out, groups, masked)
        self.block2 = Block(dim_out, dim_out, groups, masked)
        self.res_conv = nn.Conv2d(dim, dim_out, 1) if dim != dim_out else None

    def forward(self, x, mask, time_emb):
        h = self.block1(x, mask)
        h = h + self.mlp(time_emb)[:, :, None, None]
        h = self.block2(h, mask)
        xm = x * mask
        return h + (xm if self.res_conv is None else self.res_conv(xm))


class LinearAttention(nn.Module):
    """Softmax-k linear attention over all H*T positions, 4 heads of 32."""

    def __init__(self, dim: int, heads: int = HEADS, dim_head: int = DIM_HEAD):
        super().__init__()
        self.heads = heads
        self.dim_head = dim_head
        hidden = heads * dim_head
        self.to_qkv = nn.Conv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Conv2d(hidden, dim, 1)

    def forward(self, x):
        B, _, H, T = x.shape
        qkv = self.to_qkv(x).reshape(B, 3, self.heads, self.dim_head, H * T)
        q, k, v = qkv.unbind(1)
        k = torch.softmax(k, dim=-1)
        context = torch.einsum("bhdn,bhen->bhde", k, v)
        out = torch.einsum("bhde,bhdn->bhen", context, q)
        return self.to_out(out.reshape(B, self.heads * self.dim_head, H, T))


class Rezero(nn.Module):
    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn
        self.g = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        return self.fn(x) * self.g


class Residual(nn.Module):
    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x) + x


class Downsample(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Conv2d(dim, dim, 3, 2, 1)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv = ConvTranspose2dTorch(dim, dim, 4, 2, 1)

    def forward(self, x):
        return self.conv(x)


def attention(dim: int) -> Residual:
    return Residual(Rezero(LinearAttention(dim)))


class GradLogPEstimator2d(nn.Module):
    """U-Net noise estimator over the (mu, x_t[, speaker]) image.

    `use_preblock` puts the preblock variant's wide (1, preblock_kernel)
    block with channel attention (`models/unet1d.py:PreBlock`, state-dict
    name `preblock`) in front of the downs, as the reference's
    `Diffusion1DPreblock` does."""

    cuda_calls = 0  # forwards on a CUDA tensor (the kernel path runs none)
    resnet_block = ResnetBlock
    block = Block

    def __init__(self, dim: int, dim_mults: Tuple[int, ...] = (1, 2, 4), groups: int = 8,
                 n_spks: int = 1, spk_emb_dim: int = 64, n_feats: int = 80,
                 pe_scale: int = 1000, masked_norm: bool = False, use_preblock: bool = False,
                 preblock_kernel: int = 9):
        super().__init__()
        self.dim = dim
        self.n_feats = n_feats
        self.pe_scale = pe_scale
        self.masked_norm = masked_norm
        self.time_pos_emb = SinusoidalPosEmb(dim)
        self.mlp = nn.Sequential(nn.Linear(dim, dim * 4), Mish(), nn.Linear(dim * 4, dim))
        self.n_spks = n_spks
        if n_spks > 1:  # the speaker plane: embedding -> (B, n_feats)
            self.spk_mlp = nn.Sequential(nn.Linear(spk_emb_dim, spk_emb_dim * 4), Mish(),
                                         nn.Linear(spk_emb_dim * 4, n_feats))

        dims = [3 if n_spks > 1 else 2] + [dim * m for m in dim_mults]
        self.preblock = None
        if use_preblock:
            from arttts_tpu_torch.models.unet1d import PreBlock

            self.preblock = PreBlock(dims[0], dims[0], preblock_kernel)
        in_out = list(zip(dims[:-1], dims[1:]))
        rb = lambda a, b: self.resnet_block(a, b, dim, groups, masked_norm)  # noqa: E731
        self.downs = nn.ModuleList()
        for ind, (d_in, d_out) in enumerate(in_out):
            last = ind >= len(in_out) - 1
            self.downs.append(nn.ModuleList([
                rb(d_in, d_out), rb(d_out, d_out), attention(d_out),
                nn.Identity() if last else Downsample(d_out),
            ]))
        mid = dims[-1]
        self.mid_block1 = rb(mid, mid)
        self.mid_attn = attention(mid)
        self.mid_block2 = rb(mid, mid)
        self.ups = nn.ModuleList()
        for d_in, d_out in reversed(in_out[1:]):
            self.ups.append(nn.ModuleList([
                rb(d_out * 2, d_in), rb(d_in, d_in), attention(d_in), Upsample(d_in),
            ]))
        self.final_block = self.block(dim, dim, groups, masked_norm)
        self.final_conv = nn.Conv2d(dim, 1, 1)

    def time_embedding(self, t):
        """MLP(sinusoidal(t)) (B, dim); each block applies mish then its Dense."""
        return self.mlp(self.time_pos_emb(t, scale=self.pe_scale))

    def input_planes(self, x, mu, spk: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The U-Net's input image (B, 2 or 3, F, T): mu, x and, with
        n_spks > 1, the speaker plane spk_mlp(spk) broadcast over T."""
        planes = [mu.transpose(1, 2), x.transpose(1, 2)]
        if self.n_spks > 1:
            if spk is None:
                raise ValueError("a multi-speaker estimator needs speaker embeddings")
            planes.append(self.spk_mlp(spk)[:, :, None].expand_as(planes[0]))
        return torch.stack(planes, dim=1)

    def forward(self, x, mask, mu, t, spk: Optional[torch.Tensor] = None):
        """x, mu: (B, T, n_feats); mask: (B, T, 1); t: (B,); spk: (B,
        spk_emb_dim) speaker embedding (n_spks > 1). Returns (B, T, n_feats)."""
        if x.is_cuda:
            GradLogPEstimator2d.cuda_calls += 1
        t_emb = self.time_embedding(t)
        h = self.input_planes(x, mu, spk)  # (B, 2 or 3, F, T)
        mask_img = mask.transpose(1, 2)[:, :, None, :]  # (B, 1, 1, T)
        if self.preblock is not None:
            h = self.preblock(h, mask_img)

        hiddens = []
        masks = [mask_img]
        for r1, r2, attn, down in self.downs:
            m = masks[-1]
            h = r1(h, m, t_emb)
            h = r2(h, m, t_emb)
            h = attn(h)
            hiddens.append(h)
            if not isinstance(down, nn.Identity):
                h = down(h * m)
            masks.append(m[..., ::2])
        masks = masks[:-1]
        m_mid = masks[-1]
        h = self.mid_block1(h, m_mid, t_emb)
        h = self.mid_attn(h)
        h = self.mid_block2(h, m_mid, t_emb)
        for r1, r2, attn, up in self.ups:
            m = masks.pop()
            h = torch.cat([h, hiddens.pop()], dim=1)
            h = r1(h, m, t_emb)
            h = r2(h, m, t_emb)
            h = attn(h)
            h = up(h * m)
        h = self.final_block(h, mask_img)
        out = self.final_conv(h * mask_img) * mask_img  # (B, 1, F, T)
        return out[:, 0].transpose(1, 2)
