"""1D (time-conv + cross-channel attention) diffusion estimators, module
path (port of `arttts_tpu/models/unet1d.py`).

Equivalent of the reference's `Diffusion1D` / `Diffusion1DPreblock`
estimators (`model/diffusion_1D.py:52-152`, `diffusion_1D_preblock.py:69-84`):
the U-Net skeleton is the 2D one, but each block runs a (1, 3) time-only
convolution followed by `ArtChannelsAttention` - softmax attention across
the articulatory feature axis at each frame - before GroupNorm and mish.
`PreBlock` is the preblock variant's wide (1, 9) block (no GroupNorm), which
the reference and the JAX package put in front of the *2D* U-Net
(`models/unet2d.py:GradLogPEstimator2d(use_preblock=True)`).

No TPU kernel covers these: the serving path calls this module
(`models/unet2d_fast.py:make_score_fn`). Images are (B, C, F, T), masks
(B, 1, 1, T); state-dict names are the reference's (`block.0` the conv,
`block.1` the attention, `block.2` the GroupNorm), the names
`arttts_tpu/utils/torch_convert_acoustic.py:convert_estimator1d` reads.
"""

from __future__ import annotations

from torch import nn

from arttts_tpu_torch.models.unet2d import GradLogPEstimator2d, GroupNorm, Mish
from arttts_tpu_torch.ops.resblock2d import mish


class ArtChannelsAttention(nn.Module):
    """Softmax attention across the n_feats (height) axis at each frame
    (diffusion_1D.py:105-152): a (1, 3) qkv conv, heads x dim_head, a 1x1
    output conv."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads = heads
        self.dim_head = dim_head
        hidden = heads * dim_head
        self.to_qkv = nn.Conv2d(dim, hidden * 3, (1, 3), padding=(0, 1), bias=False)
        self.to_out = nn.Conv2d(hidden, dim, 1)

    def forward(self, x):
        B, _, F, T = x.shape
        qkv = self.to_qkv(x).reshape(B, 3, self.heads, self.dim_head, F, T)
        q, k, v = qkv.unbind(1)  # (B, h, d, F, T)
        scores = (q.permute(0, 1, 4, 3, 2) @ k.permute(0, 1, 4, 2, 3)) / self.dim_head ** 0.5
        attn = scores.softmax(dim=-1)  # (B, h, T, F, F)
        out = attn @ v.permute(0, 1, 4, 3, 2)  # (B, h, T, F, d)
        out = out.permute(0, 1, 4, 3, 2).reshape(B, self.heads * self.dim_head, F, T)
        return self.to_out(out)


class Block1d(nn.Module):
    """(1, 3) conv -> channel attention -> GroupNorm -> mish, masked in and
    out (diffusion_1D.py:52-66)."""

    def __init__(self, dim: int, dim_out: int, groups: int = 8, masked: bool = False):
        super().__init__()
        self.block = nn.ModuleList([
            nn.Conv2d(dim, dim_out, (1, 3), padding=(0, 1)), ArtChannelsAttention(dim_out),
            GroupNorm(groups, dim_out, masked)])

    def forward(self, x, mask):
        conv, attn, norm = self.block
        return mish(norm(attn(conv(x * mask)), mask)) * mask


class PreBlock(nn.Module):
    """(1, kernel) conv -> channel attention -> mish, no GroupNorm
    (diffusion_1D_preblock.py:69-84)."""

    def __init__(self, dim: int, dim_out: int, kernel: int = 9):
        super().__init__()
        self.block = nn.ModuleList([
            nn.Conv2d(dim, dim_out, (1, kernel), padding=(0, kernel // 2)),
            ArtChannelsAttention(dim_out)])

    def forward(self, x, mask):
        conv, attn = self.block
        return mish(attn(conv(x * mask))) * mask


class ResnetBlock1d(nn.Module):
    """Two `Block1d`, the time embedding added between them, and an identity
    or 1x1-conv residual of the masked input."""

    def __init__(self, dim: int, dim_out: int, time_emb_dim: int, groups: int = 8,
                 masked: bool = False):
        super().__init__()
        self.mlp = nn.Sequential(Mish(), nn.Linear(time_emb_dim, dim_out))
        self.block1 = Block1d(dim, dim_out, groups, masked)
        self.block2 = Block1d(dim_out, dim_out, groups, masked)
        self.res_conv = nn.Conv2d(dim, dim_out, 1) if dim != dim_out else None

    def forward(self, x, mask, time_emb):
        h = self.block1(x, mask)
        h = h + self.mlp(time_emb)[:, :, None, None]
        h = self.block2(h, mask)
        xm = x * mask
        return h + (xm if self.res_conv is None else self.res_conv(xm))


class GradLogPEstimator1d(GradLogPEstimator2d):
    """The U-Net of `GradLogPEstimator2d` (down/upsamples, linear attention,
    skips) with 1D blocks."""

    resnet_block = ResnetBlock1d
    block = Block1d
