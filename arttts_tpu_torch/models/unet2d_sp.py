"""Sequence-parallel score network of the 2D U-Net (port of
`arttts_tpu/models/unet2d_sp.py`).

The diffusion state's frame axis is split over a mesh's "model" axis: each
rank holds a contiguous chunk of T / n frames and computes the U-Net on it
in the module layout (B, C, H, T_local), with the whole sequence's math:

  * 3x3 convolutions take a one-frame halo from each neighbour (zeros at
    the sequence's ends, the zero padding the unsharded convolution reads);
  * GroupNorm takes masked statistics of the whole sequence: local sums,
    all-reduced (eps as the module's: 1e-5 with `masked_norm`, else 1e-6);
  * the Rezero linear attention takes its per-channel key maximum
    (all-reduce MAX), exp-sum and per-head context (all-reduce SUM);
  * the stride-2 downsample runs the module on the chunk with a two-frame
    left halo, which keeps the output grid's parity, and drops its first
    output frame; the 4x4/2 transposed convolution runs the module on the
    chunk with one-frame halos and keeps frames [2 : 2 + 2 T_local].

Every collective is an all-reduce (`parallel/mesh.py:Collectives`). As in
the JAX package the chunk-local compute is plain tensor code, no kernel.
The arithmetic follows the JAX SP path's rounding points, not the float32
module: every 3x3 and 1x1 product of the blocks and of the attention's
projections takes bf16-rounded operands and sums in float32, and q, v, the
normalised keys and the context are rounded to bf16
(`unet2d_sp.py:_dot`, `_attn_wide_sp`); the downsample, the transposed
convolutions, the time and speaker embeddings (phases in float32) and the
final 1x1 projection are float32.

It follows the JAX SP path's masking too, which differs from the module's
in one place: level 1's second block (ResnetBlock2d_1) takes the first
block's output unmasked, in its 3x3 convolution and its identity residual
(`unet2d_sp.py:470-474`), where the module and the fast path mask every
block's input. On an input with padded frames the SP score then differs
from the unsharded one near the end of the valid frames, by 2.5e-2 at 16
rows in both packages (`tests/test_torch_sp.py`); without padding it does
not.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from arttts_tpu_torch.models.unet2d import Block, Downsample, Residual, ResnetBlock, Upsample
from arttts_tpu_torch.models.unet2d_fast import group_norm_eps, time_embedding
from arttts_tpu_torch.ops.resblock2d import mish, round_bf16
from arttts_tpu_torch.parallel.mesh import Collectives


def unet2d_sp_supported(cfg, T: int, n_shards: int) -> bool:
    """The flagship U-Net geometry with a chunk a rank that survives two
    stride-2 levels (chunk length divisible by 4), as the JAX gate."""
    d = cfg.decoder
    return (d.kind == "unet2d" and d.dim == 64 and tuple(d.dim_mults) == (1, 2, 4)
            and d.groups == 8 and d.compute_dtype == "float32" and cfg.n_feats % 4 == 0
            and n_shards > 1 and T % n_shards == 0 and (T // n_shards) % 4 == 0)


def _conv_bf16(x, conv, padding=0):
    """conv(x) with bf16-rounded operands and float32 sums, bias after."""
    y = F.conv2d(round_bf16(x), round_bf16(conv.weight), None, padding=padding)
    return y + conv.bias[:, None, None]


def _conv3x3(x, conv, comm: Collectives):
    left, right = comm.halos(x, 1, 1)
    return _conv_bf16(torch.cat([left, x, right], dim=-1), conv, padding=(1, 0))


def _group_norm(h, norm, count, comm: Collectives, eps: float):
    """GroupNorm of a masked `h` with the whole sequence's statistics;
    `count` (B,) valid elements a group."""
    B, C, H, T = h.shape
    hg = h.reshape(B, norm.groups, C // norm.groups, H, T)
    s = comm.sum(torch.stack([hg.sum(dim=(2, 3, 4)), (hg * hg).sum(dim=(2, 3, 4))]))
    mean = s[0] / count[:, None]
    var = torch.clamp(s[1] / count[:, None] - mean * mean, min=0.0)
    hn = (hg - mean[..., None, None, None]) * torch.rsqrt(var + eps)[..., None, None, None]
    return hn.reshape(B, C, H, T) * norm.weight[:, None, None] + norm.bias[:, None, None]


def _block(block: Block, x, m, length, comm, eps):
    """conv3x3 -> GroupNorm -> mish, masked out; the caller masks x."""
    conv, norm = block.block
    h = _conv3x3(x, conv, comm) * m
    count = length * (h.shape[1] // norm.groups) * h.shape[2]
    return mish(_group_norm(h, norm, count, comm, eps)) * m


def _resnet_block(rb: ResnetBlock, x, m, length, tmish, comm, eps, mask_input=True):
    if mask_input:
        x = x * m
    temb = F.linear(tmish, rb.mlp[1].weight, rb.mlp[1].bias)[:, :, None, None]
    h = _block(rb.block2, (_block(rb.block1, x, m, length, comm, eps) + temb) * m, m, length,
               comm, eps)
    return h + (x if rb.res_conv is None else _conv_bf16(x, rb.res_conv))


def _attention(res: Residual, x, comm: Collectives):
    """x + g * LinearAttention(x) over the whole sequence's positions."""
    rz = res.fn
    la = rz.fn
    B, _, H, T = x.shape
    hd = la.heads * la.dim_head
    w = round_bf16(la.to_qkv.weight)
    xb = round_bf16(x)
    k = F.conv2d(xb, w[hd: 2 * hd]).reshape(B, hd, H * T)
    q = round_bf16(F.conv2d(xb, w[:hd]))
    v = round_bf16(F.conv2d(xb, w[2 * hd:])).reshape(B, la.heads, la.dim_head, H * T)
    ke = torch.exp(k - comm.max(k.amax(dim=-1))[..., None])
    kn = round_bf16(ke / comm.sum(ke.sum(dim=-1))[..., None])
    ctx = round_bf16(comm.sum(torch.einsum(
        "bhdn,bhen->bhde", kn.reshape(B, la.heads, la.dim_head, H * T), v)))
    out = torch.einsum("bhde,bhdn->bhen", ctx, q.reshape(B, la.heads, la.dim_head, H * T))
    proj = _conv_bf16(out.reshape(B, hd, H, T), la.to_out)
    return x + rz.g * proj


def _downsample(down: Downsample, x, comm: Collectives):
    left, _ = comm.halos(x, 2, 0)
    return down(torch.cat([left, x], dim=-1))[..., 1:]


def _upsample(up: Upsample, x, comm: Collectives):
    left, right = comm.halos(x, 1, 1)
    return up(torch.cat([left, x, right], dim=-1))[..., 2: 2 + 2 * x.shape[-1]]


def score2d_sp(est, xt, mask, mu, t, spk_emb, comm: Collectives, eps: float) -> torch.Tensor:
    """Noise estimate of this rank's chunk: xt, mu (B, T_local, n_feats),
    mask (B, T_local, 1), t (B,), spk_emb the speaker embedding of a
    multi-speaker model (None otherwise). Returns (B, T_local, n_feats)."""
    tmish = time_embedding(est, t)
    m1 = mask.transpose(1, 2)[:, :, None, :]  # (B, 1, 1, T_local)
    m2, m3 = m1[..., ::2], m1[..., ::4]
    l1 = comm.sum(mask[..., 0].sum(dim=1))  # (B,) valid frames of the sequence
    l2 = torch.ceil(l1 / 2)
    l3 = torch.ceil(l2 / 2)

    def rb(block, x, m, length):
        return _resnet_block(block, x, m, length, tmish, comm, eps)

    (d0, d1, d2), (u0, u1) = est.downs, est.ups
    h = rb(d0[0], est.input_planes(xt, mu, spk_emb), m1, l1)
    # the JAX SP path feeds ResnetBlock2d_1 its input unmasked (see the note)
    h = _attention(d0[2], _resnet_block(d0[1], h, m1, l1, tmish, comm, eps, mask_input=False),
                   comm)
    h = _downsample(d0[3], h * m1, comm)
    h = _attention(d1[2], rb(d1[1], rb(d1[0], h, m2, l2), m2, l2), comm)
    hid2 = h
    h = _downsample(d1[3], h * m2, comm)
    h = _attention(d2[2], rb(d2[1], rb(d2[0], h, m3, l3), m3, l3), comm)
    hid3 = h
    h = _attention(est.mid_attn, rb(est.mid_block1, h, m3, l3), comm)
    h = rb(est.mid_block2, h, m3, l3)
    h = rb(u0[0], torch.cat([h, hid3], dim=1), m3, l3)
    h = _upsample(u0[3], _attention(u0[2], rb(u0[1], h, m3, l3), comm) * m3, comm)
    h = rb(u1[0], torch.cat([h, hid2], dim=1), m2, l2)
    h = _upsample(u1[3], _attention(u1[2], rb(u1[1], h, m2, l2), comm) * m2, comm)
    h = _block(est.final_block, h * m1, m1, l1, comm, eps)
    out = est.final_conv(h * m1) * m1  # (B, 1, F, T_local)
    return out[:, 0].transpose(1, 2)


def make_sp_score_fn(model, T: int, mesh):
    """The sequence-parallel score function at frame bucket T over `mesh`'s
    "model" axis: (xt, mask, mu, t, spk) on this rank's chunk of T / n frames ->
    (B, T / n, n_feats). Needs `unet2d_sp_supported(cfg, T, n)`. Its
    `comm` counts the collectives."""
    n = mesh.shape["model"]
    if not unet2d_sp_supported(model.config, T, n):
        raise ValueError(f"no sequence-parallel path for this decoder at T={T} over {n} ranks")
    comm = Collectives(mesh, "model")
    est, eps = model.decoder.estimator, group_norm_eps(model.config)

    def score(xt, mask, mu, t, spk=None):
        if xt.shape[1] * n != T:
            raise ValueError(f"a chunk of {xt.shape[1]} frames is not T/{n} = {T // n}")
        return score2d_sp(est, xt, mask, mu, t, model.embed_speaker(spk), comm, eps)

    score.comm = comm
    return score


def make_gathered_score_fn(model, mesh):
    """The module path (`model.estimate_noise`) on the whole sequence, its
    inputs gathered from the ranks' chunks along `mesh`'s "model" axis:
    each rank returns its chunk of the output. What the JAX package's GSPMD
    partitioning of the module computes where the SP path does not apply."""
    comm = Collectives(mesh, "model")

    def score(xt, mask, mu, t, spk=None):
        T_l, F_ = xt.shape[1], xt.shape[2]
        full = comm.gather(torch.cat([xt, mu, mask], dim=-1), dim=1)
        out = model.estimate_noise(full[..., :F_], full[..., 2 * F_:], full[..., F_: 2 * F_],
                                   t, spk)
        return out[:, comm.index * T_l: (comm.index + 1) * T_l]

    score.comm = comm
    return score
