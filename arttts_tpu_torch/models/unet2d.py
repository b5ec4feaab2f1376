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

`compute_dtype="bfloat16"` (`DecoderConfig.compute_dtype`) is the JAX
estimator's bf16 mode (`arttts_tpu/models/unet2d.py:210-281`): the
parameters stay float32 and are cast at each use, each product (conv,
dense, the attention's einsums) takes and gives bf16 with its bias added
after it in bf16, activations are bf16 (each operation of mish rounded, as
XLA rounds it), and these stay float32: the sinusoidal phases, every GroupNorm's
statistics and normalisation (rounded after), the attention's k softmax
(rounded to v's type) and the preblock (as the JAX `PreBlock`, which takes
no dtype). The output is cast back to the input's type. Only the module
path runs it: no kernel takes this configuration, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from arttts_tpu_torch.models.convs import ConvTranspose2dTorch
from arttts_tpu_torch.ops.resblock2d import DIM_HEAD, HEADS, group_norm, mish


class Mish(nn.Module):
    def forward(self, x):
        return mish(x)


def product(m: nn.Module, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """m(x) for a `nn.Linear`, `nn.Conv2d` or `ConvTranspose2dTorch` computed
    in `dtype`, as a flax `Dense`/`Conv` with `dtype` computes it: the input
    and the float32 parameters cast to `dtype`, the bias added after the
    product. In float32 it is the module's own call."""
    if dtype == torch.float32:
        return m(x)
    x, w = x.to(dtype), m.weight.to(dtype)
    if isinstance(m, nn.Linear):
        y = F.linear(x, w)
    elif isinstance(m, nn.ConvTranspose2d):
        y = F.conv_transpose2d(x, w, None, m.stride, m.padding, m.output_padding)
    else:
        y = m._conv_forward(x, w, None)
    if m.bias is None:
        return y
    b = m.bias.to(dtype)
    return y + (b if isinstance(m, nn.Linear) else b[:, None, None])


def act(x: torch.Tensor) -> torch.Tensor:
    """mish in x's type. In bf16 each operation of the JAX expression
    `x * tanh(softplus(x))` (softplus as `jnp.logaddexp(x, 0)`: max(x, 0) +
    log1p(exp(-|x|))) is rounded to bf16, as XLA computes it there."""
    if x.dtype == torch.float32:
        return mish(x)
    r = lambda t: t.to(x.dtype).float()  # noqa: E731
    xf = x.float()
    sp = r(xf.clamp(min=0) + r(torch.log1p(r(torch.exp(-xf.abs())))))
    return (xf * r(torch.tanh(sp))).to(x.dtype)


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
        """Statistics and normalisation in float32, rounded to h's type."""
        return group_norm(h.float(), mask.float(), self.masked, self.eps, self.weight,
                          self.bias).to(h.dtype)


class Block(nn.Module):
    """conv3x3 -> GroupNorm -> mish, masked in and out; products in `dtype`."""

    def __init__(self, dim: int, dim_out: int, groups: int = 8, masked: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.block = nn.ModuleList(
            [nn.Conv2d(dim, dim_out, 3, padding=1), GroupNorm(groups, dim_out, masked)]
        )

    def forward(self, x, mask):
        conv, norm = self.block
        return act(norm(product(conv, x * mask, self.dtype), mask)) * mask


class ResnetBlock(nn.Module):
    """Two blocks, the time embedding added between them, and an identity
    or 1x1-conv residual of the masked input."""

    def __init__(self, dim: int, dim_out: int, time_emb_dim: int, groups: int = 8,
                 masked: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.mlp = nn.Sequential(Mish(), nn.Linear(time_emb_dim, dim_out))
        self.block1 = Block(dim, dim_out, groups, masked, dtype)
        self.block2 = Block(dim_out, dim_out, groups, masked, dtype)
        self.res_conv = nn.Conv2d(dim, dim_out, 1) if dim != dim_out else None

    def forward(self, x, mask, time_emb):
        h = self.block1(x, mask)
        h = h + product(self.mlp[1], act(time_emb), self.dtype)[:, :, None, None]
        h = self.block2(h, mask)
        xm = x * mask
        return h + (xm if self.res_conv is None else product(self.res_conv, xm, self.dtype))


class LinearAttention(nn.Module):
    """Softmax-k linear attention over all H*T positions, 4 heads of 32."""

    def __init__(self, dim: int, heads: int = HEADS, dim_head: int = DIM_HEAD,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads = heads
        self.dim_head = dim_head
        self.dtype = dtype
        hidden = heads * dim_head
        self.to_qkv = nn.Conv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Conv2d(hidden, dim, 1)

    def forward(self, x):
        B, _, H, T = x.shape
        qkv = product(self.to_qkv, x, self.dtype)
        q, k, v = qkv.reshape(B, 3, self.heads, self.dim_head, H * T).unbind(1)
        if self.dtype != torch.float32:  # the softmax in float32, as the JAX module's
            k = k.float()
            k = torch.exp(k - k.amax(dim=-1, keepdim=True))
            k = (k / k.sum(dim=-1, keepdim=True)).to(v.dtype)
        else:
            k = torch.softmax(k, dim=-1)
        context = torch.einsum("bhdn,bhen->bhde", k, v)
        out = torch.einsum("bhde,bhdn->bhen", context, q)
        return product(self.to_out, out.reshape(B, self.heads * self.dim_head, H, T), self.dtype)


class Rezero(nn.Module):
    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn
        self.g = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        return self.fn(x) * self.g.to(x.dtype)


class Residual(nn.Module):
    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x) + x


class Downsample(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(dim, dim, 3, 2, 1)

    def forward(self, x):
        return product(self.conv, x, self.dtype)


class Upsample(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = ConvTranspose2dTorch(dim, dim, 4, 2, 1)

    def forward(self, x):
        return product(self.conv, x, self.dtype)


def attention(dim: int, dtype: torch.dtype = torch.float32) -> Residual:
    return Residual(Rezero(LinearAttention(dim, dtype=dtype)))


class GradLogPEstimator2d(nn.Module):
    """U-Net noise estimator over the (mu, x_t[, speaker]) image.

    `use_preblock` puts the preblock variant's wide (1, preblock_kernel)
    block with channel attention (`models/unet1d.py:PreBlock`, state-dict
    name `preblock`) in front of the downs, as the reference's
    `Diffusion1DPreblock` does. `compute_dtype` "bfloat16" is the JAX
    estimator's bf16 mode (the module note says what stays float32)."""

    cuda_calls = 0  # forwards on a CUDA tensor (the kernel path runs none)
    resnet_block = ResnetBlock
    block = Block

    def __init__(self, dim: int, dim_mults: Tuple[int, ...] = (1, 2, 4), groups: int = 8,
                 n_spks: int = 1, spk_emb_dim: int = 64, n_feats: int = 80,
                 pe_scale: int = 1000, masked_norm: bool = False, use_preblock: bool = False,
                 preblock_kernel: int = 9, compute_dtype: str = "float32"):
        super().__init__()
        if compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype!r}")
        self.dtype = getattr(torch, compute_dtype)
        # the blocks take a dtype only in the bf16 mode (the 1D blocks have none)
        dt = {} if self.dtype == torch.float32 else dict(dtype=self.dtype)
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
        rb = lambda a, b: self.resnet_block(a, b, dim, groups, masked_norm, **dt)  # noqa: E731
        self.downs = nn.ModuleList()
        for ind, (d_in, d_out) in enumerate(in_out):
            last = ind >= len(in_out) - 1
            self.downs.append(nn.ModuleList([
                rb(d_in, d_out), rb(d_out, d_out), attention(d_out, **dt),
                nn.Identity() if last else Downsample(d_out, **dt),
            ]))
        mid = dims[-1]
        self.mid_block1 = rb(mid, mid)
        self.mid_attn = attention(mid, **dt)
        self.mid_block2 = rb(mid, mid)
        self.ups = nn.ModuleList()
        for d_in, d_out in reversed(in_out[1:]):
            self.ups.append(nn.ModuleList([
                rb(d_out * 2, d_in), rb(d_in, d_in), attention(d_in, **dt),
                Upsample(d_in, **dt),
            ]))
        self.final_block = self.block(dim, dim, groups, masked_norm, **dt)
        self.final_conv = nn.Conv2d(dim, 1, 1)

    def time_embedding(self, t):
        """MLP(sinusoidal(t)) (B, dim) in the compute dtype, the phases in
        float32; each block applies mish then its Dense."""
        emb = self.time_pos_emb(t, scale=self.pe_scale).to(self.dtype)
        return product(self.mlp[2], act(product(self.mlp[0], emb, self.dtype)), self.dtype)

    def input_planes(self, x, mu, spk: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The U-Net's input image (B, 2 or 3, F, T): mu, x and, with
        n_spks > 1, the speaker plane spk_mlp(spk) broadcast over T."""
        planes = [mu.transpose(1, 2), x.transpose(1, 2)]
        if self.n_spks > 1:
            if spk is None:
                raise ValueError("a multi-speaker estimator needs speaker embeddings")
            s = product(self.spk_mlp[0], spk.to(self.dtype), self.dtype)
            s = product(self.spk_mlp[2], act(s), self.dtype)
            planes.append(s[:, :, None].expand_as(planes[0]))
        return torch.stack(planes, dim=1)

    def forward(self, x, mask, mu, t, spk: Optional[torch.Tensor] = None):
        """x, mu: (B, T, n_feats); mask: (B, T, 1); t: (B,); spk: (B,
        spk_emb_dim) speaker embedding (n_spks > 1). Returns (B, T, n_feats)."""
        if x.is_cuda:
            GradLogPEstimator2d.cuda_calls += 1
        in_dtype = x.dtype
        x, mask, mu = x.to(self.dtype), mask.to(self.dtype), mu.to(self.dtype)
        t_emb = self.time_embedding(t)
        h = self.input_planes(x, mu, spk)  # (B, 2 or 3, F, T)
        mask_img = mask.transpose(1, 2)[:, :, None, :]  # (B, 1, 1, T)
        if self.preblock is not None:  # float32 in both modes, as in the JAX package
            h = self.preblock(h.float(), mask_img.float())

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
        out = product(self.final_conv, h * mask_img, self.dtype) * mask_img  # (B, 1, F, T)
        return out[:, 0].transpose(1, 2).to(in_dtype)
