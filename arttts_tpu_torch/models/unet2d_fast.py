"""Serving path of the 2D U-Net score network on the hand-written kernels
(port of `arttts_tpu/models/unet2d_fast.py`: `time_embedding`,
`score2d_fast`, `make_score_fn`).

Every ResnetBlock2d (with the Rezero linear attention fused behind it where
the U-Net has one) is one call of K1 `ops.resblock2d.resblock2d`; the two
Downsample2d are K2 `ops.updown.downsample2d`; the two 4x4 transposed convs
K3 `ops.updown.conv_transpose2d`. Per evaluation: 13 K1 calls (6 with
attention), 2 K2, 2 K3. The time MLP, the speaker MLP of a multi-speaker
model (its output is a third input plane, so ResnetBlock2d_0 takes 3
channels) and the final 1x1 projection to one channel are small products
outside any kernel, as in the JAX package.

GroupNorm statistics (pitfall of the JAX dispatch): on a TPU the JAX package
runs its fused kernels only where `unet2d_fast_supported(cfg, T)` holds, and
those compute masked statistics; elsewhere it runs the module, whose
statistics include padded frames unless `masked_norm`. The port runs its
kernels at every bucket and reproduces that choice with K1's statistics mode
(`masked_statistics`).

`bf16=True` (`make_score_fn(..., kernel_bf16=True)`) runs K1-K3 in the JAX
kernels' bf16 mode, which `arttts_tpu/models/unet2d_fast.py:score2d_fast`
takes by default on a TPU: bf16 operands in every product, float32 sums,
statistics and activations. The port's default stays float32.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from arttts_tpu_torch.models.unet2d import GradLogPEstimator2d, ResnetBlock, Residual
from arttts_tpu_torch.ops.resblock2d import AttnWeights, BlockWeights, mish, resblock2d
from arttts_tpu_torch.ops.updown import conv_transpose2d, downsample2d

# The JAX package's TPU gate, restated: `unet2d_fast_supported` needs the
# flagship geometry, T % 256 == 0 and the VMEM budget of
# `ops/resblock2d_pallas.py:resblock2d_supported` at each resolution
# (100 MiB limit, 12 MiB slack, two whole-T scratches, 13 live tiles of 64
# frames plus one per input, 2 MiB margin; PAD = 8 border frames).
_MIB = 1024 * 1024


def _tpu_vmem_fits(T: int, rows: int, n_in: int, lanes: int = 128) -> bool:
    if T % 64:
        return False
    usable = (100 - 12) * _MIB - rows * (2 * T + 16) * lanes * 4
    need = (13 + n_in) * rows * (64 + 16) * lanes * 4
    return usable >= need + 2 * _MIB


def supported(cfg) -> bool:
    """Geometry the kernels implement: the flagship U-Net (dim 64, mults
    (1, 2, 4), 8 groups, float32), with or without the speaker plane."""
    d = cfg.decoder
    return (d.kind == "unet2d" and d.dim == 64 and tuple(d.dim_mults) == (1, 2, 4)
            and d.groups == 8 and d.compute_dtype == "float32"
            and d.attn_heads == 4 and d.attn_dim_head == 32)


def masked_statistics(cfg, T: int) -> bool:
    """Whether the score network at frame bucket T takes GroupNorm
    statistics over valid frames only: always with `masked_norm`, else
    exactly where the JAX package's TPU fast path runs."""
    F = cfg.n_feats
    return cfg.decoder.masked_norm or (
        supported(cfg) and F % 4 == 0 and T % 256 == 0
        and _tpu_vmem_fits(T, F // 2, 1)
        and _tpu_vmem_fits(T // 2, F // 2, 2, 128)
        and _tpu_vmem_fits(T // 4, F // 4, 2, 256)
    )


def group_norm_eps(cfg) -> float:
    return 1e-5 if cfg.decoder.masked_norm else 1e-6


def time_embedding(est: GradLogPEstimator2d, t: torch.Tensor) -> torch.Tensor:
    """mish(MLP(sinusoidal(t))), phases in float32; each block then applies
    its own Dense."""
    return mish(est.time_embedding(t.float()))


def _block(rb: ResnetBlock) -> BlockWeights:
    d = lambda p: p.detach()  # noqa: E731
    b1, b2 = rb.block1.block, rb.block2.block
    w = dict(w1=d(b1[0].weight), b1=d(b1[0].bias), gn1_w=d(b1[1].weight), gn1_b=d(b1[1].bias),
             w2=d(b2[0].weight), b2=d(b2[0].bias), gn2_w=d(b2[1].weight), gn2_b=d(b2[1].bias))
    if rb.res_conv is not None:
        c_out, c_in = rb.res_conv.weight.shape[:2]
        w.update(w_res=d(rb.res_conv.weight).reshape(c_out, c_in), b_res=d(rb.res_conv.bias))
    return BlockWeights(**w)


def _attn(res: Residual) -> AttnWeights:
    rz = res.fn
    qkv, out = rz.fn.to_qkv.weight.detach(), rz.fn.to_out.weight.detach()
    return AttnWeights(gain=rz.g.detach(), w_qkv=qkv.reshape(qkv.shape[:2]),
                       w_out=out.reshape(out.shape[:2]), b_out=rz.fn.to_out.bias.detach())


class KernelWeights:
    """The estimator's tensors in the kernels' operand form, gathered once
    (views of the module's parameters, no copies)."""

    def __init__(self, est: GradLogPEstimator2d):
        self.est = est
        (d0, d1, d2), mid = est.downs, (est.mid_block1, est.mid_attn, est.mid_block2)
        (u0, u1) = est.ups
        # ResnetBlock2d_0..11 in the JAX package's call order
        self.blocks: List[ResnetBlock] = [d0[0], d0[1], d1[0], d1[1], d2[0], d2[1],
                                          mid[0], mid[2], u0[0], u0[1], u1[0], u1[1]]
        self.block_w = [_block(rb) for rb in self.blocks]
        # attention sites 0..5 fuse behind ResnetBlock2d 1, 3, 5, 6, 9, 11
        self.attn_w = {1: _attn(d0[2]), 3: _attn(d1[2]), 5: _attn(d2[2]), 6: _attn(mid[1]),
                       9: _attn(u0[2]), 11: _attn(u1[2])}
        fb = est.final_block.block
        self.final = BlockWeights(w1=fb[0].weight.detach(), b1=fb[0].bias.detach(),
                                  gn1_w=fb[1].weight.detach(), gn1_b=fb[1].bias.detach())
        self.down = [(d.conv.weight.detach(), d.conv.bias.detach()) for d in (d0[3], d1[3])]
        self.up = [(u[3].conv.weight.detach(), u[3].conv.bias.detach()) for u in (u0, u1)]
        self.out_w = est.final_conv.weight.detach().reshape(-1)  # (64,)
        self.out_b = est.final_conv.bias.detach()


def score2d_fast(kw: KernelWeights, xt, mask, mu, t, spk_emb=None, *, masked_stats: bool,
                 eps: float, bf16: bool = False) -> torch.Tensor:
    """Noise estimate of (B, T, n_feats) inputs through K1-K3; mask (B, T, 1),
    t (B,), spk_emb (B, spk_emb_dim) the speaker embedding of a
    multi-speaker model; `bf16` the kernels' bf16 mode. The U-Net's frame
    axis must divide by 4."""
    B, T, F = xt.shape
    if T % 4:
        raise ValueError(f"frame axis {T} must be divisible by 4 (fix_len_compatibility)")
    tmish = time_embedding(kw.est, t)
    lengths = mask[..., 0].sum(dim=1).to(torch.int32)
    lengths2 = (lengths + 1) // 2
    lengths4 = (lengths2 + 1) // 2

    def rb(i, xs, lens):
        mlp = kw.blocks[i].mlp[1]
        temb = torch.addmm(mlp.bias, tmish, mlp.weight.t())  # the block's Dense
        return resblock2d(xs, lens, temb, kw.block_w[i], masked_stats=masked_stats,
                          eps=eps, attn=kw.attn_w.get(i), bf16=bf16)

    img = kw.est.input_planes(xt, mu, spk_emb).contiguous()  # (B, 2 or 3, F, T)
    h = rb(0, [img], lengths)  # K1 masks its input, the speaker plane too
    h = rb(1, [h], lengths)  # level 1's output feeds no skip: two ups
    h = downsample2d(h, lengths, *kw.down[0], bf16=bf16)
    h = rb(2, [h], lengths2)
    h = rb(3, [h], lengths2)
    hid2 = h
    h = downsample2d(h, lengths2, *kw.down[1], bf16=bf16)
    h = rb(4, [h], lengths4)
    h = rb(5, [h], lengths4)
    hid3 = h
    h = rb(6, [h], lengths4)
    h = rb(7, [h], lengths4)
    h = rb(8, [h, hid3], lengths4)
    h = rb(9, [h], lengths4)
    h = conv_transpose2d(h, lengths4, *kw.up[0], bf16=bf16)
    h = rb(10, [h, hid2], lengths2)
    h = rb(11, [h], lengths2)
    h = conv_transpose2d(h, lengths2, *kw.up[1], bf16=bf16)
    h = resblock2d([h], lengths, None, kw.final, masked_stats=masked_stats, eps=eps,
                   bf16=bf16)
    out = torch.einsum("c,bchw->bhw", kw.out_w, h) + kw.out_b  # (B, F, T)
    return (out * mask.transpose(1, 2)).transpose(1, 2)


def make_score_fn(model, T: int, kernel_bf16: bool = False, mesh=None) -> Callable:
    """The score function the sampler calls at frame bucket T:
    (xt, mask, mu, t, spk) -> (B, T, n_feats). A 2D U-Net decoder runs
    through the kernels at every bucket, with the GroupNorm statistics the
    JAX package computes there, in their bf16 mode with `kernel_bf16`; the
    1D and preblock decoders and a decoder with `compute_dtype="bfloat16"`,
    which no kernel covers (the JAX package's `unet2d_fast_supported` is
    false for them), run the module (`model.estimate_noise`), whatever
    `kernel_bf16` says. `spk` is the raw speaker input
    (`model.embed_speaker`'s argument).

    `mesh` with a "model" axis of n > 1 (sequence parallelism): the
    function takes and gives this rank's chunk of T / n frames, as the JAX
    dispatch routes it (`arttts_tpu/models/unet2d_fast.py:522-533`): the SP
    path where `unet2d_sp_supported` holds, else the module path on the
    gathered sequence. Both are float32 (the JAX SP path is), so
    `kernel_bf16` raises there."""
    cfg = model.config
    if mesh is not None and mesh.shape["model"] > 1:
        from arttts_tpu_torch.models import unet2d_sp

        if kernel_bf16:
            raise ValueError("the sequence-parallel score function is float32 only")
        if unet2d_sp.unet2d_sp_supported(cfg, T, mesh.shape["model"]):
            return unet2d_sp.make_sp_score_fn(model, T, mesh)
        return unet2d_sp.make_gathered_score_fn(model, mesh)
    if (cfg.decoder.kind in ("unet1d", "unet1d_preblock")
            or cfg.decoder.compute_dtype != "float32"):
        return lambda xt, mask, mu, t, spk=None: model.estimate_noise(xt, mask, mu, t, spk)
    if not supported(cfg):
        raise NotImplementedError("the kernels implement the flagship 2D U-Net only")
    kw = KernelWeights(model.decoder.estimator)
    masked, eps = masked_statistics(cfg, T), group_norm_eps(cfg)

    def score(xt, mask, mu, t, spk: Optional[torch.Tensor] = None):
        return score2d_fast(kw, xt, mask, mu, t, model.embed_speaker(spk),
                            masked_stats=masked, eps=eps, bf16=kernel_bf16)

    return score
