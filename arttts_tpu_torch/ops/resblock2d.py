"""K1: one whole U-Net ResnetBlock2d (plus its Rezero linear attention) as
hand-written CUDA kernels, with its plain PyTorch version.

Replaces the TPU kernel `_resblock_kernel` of
`arttts_tpu/ops/resblock2d_pallas.py` (wrappers `resblock2d_packed` :916,
C=64, and `resblock2d_wide` :1107, C=128/256). The function is the module's
(`models/unet2d.py:ResnetBlock2d`, `Block2d`, `Rezero(LinearAttention2d)`):

    h = mish(GN(conv3x3(x*m) + b1)) ; h = (h + temb) * m
    h = mish(GN(conv3x3(h) + b2)) * m + (x*m  or  W_res (x*m) + b_res)
    h = h + g * (W_o (q ctx) + b_o)           # attention, when given

with GroupNorm(8) statistics either over valid frames only (`masked_stats`)
or over the whole image (the flax `nn.GroupNorm` the module uses when
`masked_norm` is off). `block_only` weights (no second conv) give the final
Block2d: mish(GN(conv3x3(x*m) + b1)) * m.

Layout: images (B, C, H, T) float32; the block input may come as a list of
channel chunks (the up path's skip concatenation is never materialised).

What bounds it on the H100, and what the design does about it, is in the
note at the top of `csrc/resblock2d.cu`. Its 3x3 and 1x1 products
(`conv3x3`, `conv1x1`) are implicit GEMMs on the tensor cores in 3xTF32
(float32 accuracy from three TF32 passes), bound by the tensor cores' rate;
the launcher picks per shape the largest tile that gives every SM a block.
A float32 3x3 product takes one of two routes, by its shape alone
(`conv3x3_route`): Hopper's warpgroup `wgmma` (`conv3x3_wgmma`) where its
64-frame tiles still give every SM a block, else the `mma.sync` body.
GroupNorm's image-wide statistics are per-tile partial sums from the 3x3
epilogue, reduced in a second, fixed-order pass (no atomics, so a call
gives the same bits every run); normalisation, mish, the time embedding and
the attention core are small kernels of their own.

`bf16=True` is the JAX kernel's default mode (`resblock2d_packed` :925,
`resblock2d_wide` :1116): every product rounds its operands to bf16 (to
nearest, ties to even) and sums in float32, with the attention core's
rounding points and the Rezero gain folded into the output projection
before rounding (`rezero_attention_plain`); GroupNorm statistics, mish, the
time embedding and the residual sum stay float32. On the card it is a bf16
`mma.sync` mode of the same kernels (`csrc/resblock2d.cu`).

`resblock2d` runs the plain version for tensors on the CPU and the kernels
for tensors on a CUDA device; anything else raises.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from arttts_tpu_torch.ops import _build

GROUPS = 8
HEADS = 4
DIM_HEAD = 32


@dataclasses.dataclass(frozen=True)
class BlockWeights:
    """One ResnetBlock2d's tensors (torch layouts). `w2 is None` marks a
    lone Block2d (`block_only`); `w_res is None` an identity residual."""

    w1: torch.Tensor  # (c_out, c_in, 3, 3)
    b1: torch.Tensor
    gn1_w: torch.Tensor
    gn1_b: torch.Tensor
    w2: Optional[torch.Tensor] = None  # (c_out, c_out, 3, 3)
    b2: Optional[torch.Tensor] = None
    gn2_w: Optional[torch.Tensor] = None
    gn2_b: Optional[torch.Tensor] = None
    w_res: Optional[torch.Tensor] = None  # (c_out, c_in)
    b_res: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class AttnWeights:
    """Rezero(LinearAttention2d): gain (1,), qkv (384, C), out (C, 128) + (C,)."""

    gain: torch.Tensor
    w_qkv: torch.Tensor
    w_out: torch.Tensor
    b_out: torch.Tensor


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """float32 -> bf16 -> float32: to nearest, ties to even, as
    `astype(jnp.bfloat16)` and the kernels' `cvt.rn` round."""
    return t.to(torch.bfloat16).to(t.dtype)


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


def frame_mask(lengths: torch.Tensor, T: int, dtype=torch.float32) -> torch.Tensor:
    """(B,) lengths -> (B, 1, 1, T) {0, 1} mask of valid frames."""
    t = torch.arange(T, device=lengths.device)
    return (t[None, :] < lengths[:, None]).to(dtype)[:, None, None, :]


def group_norm(h, m, masked_stats: bool, eps: float, weight, bias):
    """GroupNorm(8) with one-pass statistics (E[x^2] - E[x]^2, as the JAX
    modules compute them), over frames where `m` is 1 if `masked_stats`,
    else over the whole image."""
    B, C, H, T = h.shape
    hg = h.reshape(B, GROUPS, C // GROUPS, H, T)
    if masked_stats:
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


def attention_core_plain(qkv: torch.Tensor, bf16: bool = False):
    """The attention between its two projections: qkv (B, 384, P) -> the
    context (B, 4, 32, 32), indexed [head, d of k, e of v], and the output
    (B, 128, P) = q ctx. The bf16 mode rounds where `_resblock_kernel`
    rounds (`resblock2d_pallas.py:684-736`): k not at all, and its max,
    exp(k - max) and their sum S in float32; ctx = bf16(bf16(v)^T
    bf16(exp(k - max)) / S); out = bf16(q) ctx summed in float32."""
    B, _, P = qkv.shape
    q, k, v = qkv.reshape(B, 3, HEADS, DIM_HEAD, P).unbind(1)
    if bf16:
        ke = torch.exp(k - k.amax(dim=-1, keepdim=True))
        ctx = torch.einsum("bhdn,bhen->bhde", round_bf16(ke), round_bf16(v))
        ctx = round_bf16(ctx / ke.sum(dim=-1)[..., None])
        q = round_bf16(q)
    else:
        ctx = torch.einsum("bhdn,bhen->bhde", torch.softmax(k, dim=-1), v)
    return ctx, torch.einsum("bhde,bhdn->bhen", ctx, q).reshape(B, HEADS * DIM_HEAD, P)


def rezero_attention_plain(x: torch.Tensor, a: AttnWeights,
                           bf16: bool = False) -> torch.Tensor:
    """x + g * LinearAttention2d(x): per-channel softmax of k over all H*T
    positions (padded frames included, as in the module), 4 heads of 32. The
    bf16 mode rounds x and W_qkv for the qkv product, then q, v, exp(k - max)
    and ctx (`attention_core_plain`), and the output and g*W_o for the
    projection: the Rezero gain folded into W_o and b_o before rounding, as
    `pack_attn_params` folds it."""
    B, C, H, T = x.shape
    r = round_bf16 if bf16 else (lambda t: t)
    qkv = torch.einsum("oc,bcp->bop", r(a.w_qkv), r(x.reshape(B, C, H * T)))
    _, out = attention_core_plain(qkv, bf16)
    out = out.reshape(B, HEADS * DIM_HEAD, H, T)
    if bf16:
        proj = torch.einsum("oc,bchw->bohw", round_bf16(a.gain * a.w_out), round_bf16(out))
        return x + proj + (a.gain * a.b_out)[:, None, None]
    proj = torch.einsum("oc,bchw->bohw", a.w_out, out) + a.b_out[:, None, None]
    return x + a.gain * proj


def _conv3x3(x, w, b):
    return F.conv2d(x, w, b, padding=1)


def _conv1x1(x, w, b):
    return torch.einsum("oc,bchw->bohw", w, x) + b[:, None, None]


def _conv3x3_bf16(x, w, b):
    return _conv3x3(round_bf16(x), round_bf16(w), b)


def _conv1x1_bf16(x, w, b):
    return _conv1x1(round_bf16(x), round_bf16(w), b)


def resblock2d_plain(
    xs: Sequence[torch.Tensor],
    lengths: torch.Tensor,
    temb: Optional[torch.Tensor],
    w: BlockWeights,
    *,
    masked_stats: bool,
    eps: float,
    attn: Optional[AttnWeights] = None,
    bf16: bool = False,
) -> torch.Tensor:
    """The plain PyTorch version of `resblock2d` (same arguments)."""
    if xs[0].is_cuda:
        resblock2d_plain.cuda_calls += 1
    if bf16:
        return block_with_products(xs, lengths, temb, w, masked_stats=masked_stats, eps=eps,
                                   attn=attn, conv3x3=_conv3x3_bf16, conv1x1=_conv1x1_bf16,
                                   bf16_attention=True)
    return block_with_products(xs, lengths, temb, w, masked_stats=masked_stats, eps=eps,
                               attn=attn)


def block_with_products(xs, lengths, temb, w, *, masked_stats, eps, attn=None,
                        conv3x3=_conv3x3, conv1x1=_conv1x1, bf16_attention=False):
    """`resblock2d_plain`'s computation with its block products given as
    functions (input, weight, bias) -> output: the two 3x3 convolutions
    (zero padding 1) and the residual projection, and the attention in
    either mode. The tests hand it emulations of the kernels' arithmetic."""
    x = torch.cat(list(xs), dim=1) if len(xs) > 1 else xs[0]
    m = frame_mask(lengths, x.shape[-1], x.dtype)
    xm = x * m
    h = conv3x3(xm, w.w1, w.b1)
    h = mish(group_norm(h, m, masked_stats, eps, w.gn1_w, w.gn1_b))
    if w.w2 is None:
        return h * m
    h = (h + temb[:, :, None, None]) * m
    h = conv3x3(h, w.w2, w.b2)
    h = mish(group_norm(h, m, masked_stats, eps, w.gn2_w, w.gn2_b)) * m
    res = xm if w.w_res is None else conv1x1(xm, w.w_res, w.b_res)
    y = h + res
    return y if attn is None else rezero_attention_plain(y, attn, bf16_attention)


resblock2d_plain.cuda_calls = 0


WGMMA_ROWS = (4, 2)  # the `wgmma` route's tiles, largest first: rows x 64 frames x 64 channels
WGMMA_COLS = 64
WGMMA_CI = 8  # input channels of the route's staged chunk


def conv3x3_route(B: int, c_in: int, c_out: int, H: int, T: int, bf16: bool, sms: int) -> int:
    """Which body runs one 3x3 product of K1: the rows of the `wgmma`
    route's tile, or 0 for the `mma.sync` body. The route takes float32
    products whose input channels fill its 8-channel chunks, with the first
    of its tiles that gives each of the card's `sms` SMs a block; the first
    block's 2 or 3 input planes, the bf16 mode and any shape that no tile of
    the route fills the card with stay on the `mma.sync` body (whose smaller
    tiles do)."""
    if bf16 or c_in % WGMMA_CI:
        return 0
    for rows in WGMMA_ROWS:
        if -(-H // rows) * -(-T // WGMMA_COLS) * (c_out // 64) * B >= sms:
            return rows
    return 0


@functools.lru_cache(maxsize=None)
def _sm_count(index: Optional[int]) -> int:
    """SMs of CUDA device `index` (a CUDA tensor's device always has one)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_operand(t: torch.Tensor, shape, device, what: str, dtype=torch.float32) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` on `device`."""
    if (t.dtype != dtype or not t.is_contiguous() or tuple(t.shape) != tuple(shape)
            or t.device != device):
        raise ValueError(
            f"{what}: want contiguous {dtype} {tuple(shape)} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device} contiguous={t.is_contiguous()}"
        )


def resblock2d(
    xs: Sequence[torch.Tensor],
    lengths: torch.Tensor,
    temb: Optional[torch.Tensor],
    w: BlockWeights,
    *,
    masked_stats: bool,
    eps: float,
    attn: Optional[AttnWeights] = None,
    bf16: bool = False,
) -> torch.Tensor:
    """One ResnetBlock2d (or lone Block2d) on (B, c_j, H, T) input chunks.

    lengths: (B,) int32 valid frames; temb: (B, c_out) rows of the block's
    time-embedding Dense (None for a lone Block2d). `bf16`: the JAX kernel's
    bf16 mode. Returns (B, c_out, H, T).
    """
    dev = xs[0].device
    if dev.type == "cpu":
        return resblock2d_plain(
            xs, lengths, temb, w, masked_stats=masked_stats, eps=eps, attn=attn, bf16=bf16
        )
    if dev.type != "cuda":
        raise ValueError(f"resblock2d runs on cpu or cuda tensors, not {dev}")
    return _resblock2d_cuda(_build.library("resblock2d"), xs, lengths, temb, w,
                            masked_stats, eps, attn, bf16)


resblock2d.launches = 0
resblock2d.bf16_launches = 0  # the launches among them in the bf16 mode
resblock2d.wgmma_launches = 0  # ... and those with a 3x3 product on the `wgmma` route


def _resblock2d_cuda(lib, xs, lengths, temb, w, masked_stats, eps, attn, bf16=False):
    if not 1 <= len(xs) <= 2:
        raise ValueError("resblock2d takes one or two input chunks")
    B, _, H, T = xs[0].shape
    cs = [x.shape[1] for x in xs]
    c_in = sum(cs)
    c_out = w.w1.shape[0]
    if c_out % 64:
        raise ValueError(f"c_out must be a multiple of 64, got {c_out}")
    if min(cs) < 1 or B < 1 or H < 1 or T < 1:
        raise ValueError(f"empty operand: chunks of {cs} channels, image {B}x{H}x{T}")

    def _check(t, shape, what):
        check_operand(t, shape, xs[0].device, what)

    for j, x in enumerate(xs):
        _check(x, (B, cs[j], H, T), f"input chunk {j}")
    check_operand(lengths, (B,), xs[0].device, "lengths", torch.int32)
    _check(w.w1, (c_out, c_in, 3, 3), "w1")
    for name in ("b1", "gn1_w", "gn1_b"):
        _check(getattr(w, name), (c_out,), name)
    block_only = w.w2 is None
    if not block_only:
        _check(w.w2, (c_out, c_out, 3, 3), "w2")
        for name in ("b2", "gn2_w", "gn2_b"):
            _check(getattr(w, name), (c_out,), name)
        _check(temb, (B, c_out), "temb")
        if w.w_res is None and c_in != c_out:
            raise ValueError("identity residual needs c_in == c_out")
        if w.w_res is not None:
            _check(w.w_res, (c_out, c_in), "w_res")
            _check(w.b_res, (c_out,), "b_res")
    if attn is not None:
        _check(attn.w_qkv, (3 * HEADS * DIM_HEAD, c_out), "w_qkv")
        _check(attn.w_out, (c_out, HEADS * DIM_HEAD), "w_out")
        _check(attn.b_out, (c_out,), "b_out")
        _check(attn.gain, (1,), "gain")

    p = _build.ptr
    s = _build.stream(xs[0])
    x0, x1 = xs[0], (xs[1] if len(xs) > 1 else None)
    c1 = cs[1] if len(xs) > 1 else 0
    sms = _sm_count(x0.device.index)
    # each 3x3 product's route (the second reads c_out channels) and tiles
    routes = [conv3x3_route(B, c, c_out, H, T, bf16, sms)
              for c in ((c_in,) if block_only else (c_in, c_out))]
    tiles = [lib.conv_tiles(B, c_out, H, T, r) for r in routes]
    if min(tiles) <= 0:
        raise RuntimeError(f"conv_tiles: CUDA error {-min(tiles)}")
    new = lambda c: torch.empty((B, c, H, T), device=x0.device)  # noqa: E731
    h = new(c_out)
    part = torch.empty((B, c_out // 8, max(tiles), 2), device=x0.device)
    stats = torch.empty((B, GROUPS, 2), device=x0.device)
    resblock2d.launches += 1
    resblock2d.bf16_launches += bool(bf16)
    resblock2d.wgmma_launches += any(routes)

    conv3x3_fn, conv1x1_fn = _build.launcher("conv3x3", bf16), _build.launcher("conv1x1", bf16)

    def conv_norm(inputs, chans, wt, bias, j):
        args = (p(inputs[0]), chans[0], p(inputs[1]), chans[1], p(lengths), p(wt), p(bias),
                p(h), p(part), B, H, T, c_out, int(masked_stats))
        if routes[j]:
            _build.call(lib, "conv3x3_wgmma", *args, routes[j], s)
        else:
            _build.call(lib, conv3x3_fn, *args, s)
        _build.call(lib, "gn_stats", p(part), p(lengths), p(stats), B, c_out, tiles[j],
                    H, T, int(masked_stats), float(eps), s)

    def act(gamma, beta, tv, res, res_masked, out):
        _build.call(lib, "gn_act", p(h), p(stats), p(gamma), p(beta), p(tv), p(res),
                    int(res_masked), p(lengths), p(out), B, c_out, H, T, s)
        return out

    def conv1x1(inputs, chans, lens, wt, bias, resid, gain, out):
        _build.call(lib, conv1x1_fn, p(inputs[0]), chans[0], p(inputs[1]), chans[1], p(lens),
                    p(wt), p(bias), p(resid), p(gain), p(out), B, out.shape[1], H, T, s)
        return out

    conv_norm((x0, x1), (cs[0], c1), w.w1, w.b1, 0)
    if block_only:
        return act(w.gn1_w, w.gn1_b, None, None, False, new(c_out))
    a = act(w.gn1_w, w.gn1_b, temb, None, False, new(c_out))
    conv_norm((a, None), (c_out, 0), w.w2, w.b2, 1)
    if w.w_res is None:
        res, res_masked = x0, True
    else:
        res = conv1x1((x0, x1), (cs[0], c1), lengths, w.w_res, w.b_res, None, None,
                      new(c_out))
        res_masked = False
    y = act(w.gn2_w, w.gn2_b, None, res, res_masked, a)  # `a` is dead: reuse it
    if attn is None:
        return y

    hd = HEADS * DIM_HEAD
    qkv = conv1x1((y, None), (c_out, 0), None, attn.w_qkv, None, None, None, new(3 * hd))
    _, ao = attention_core_cuda(lib, qkv.reshape(B, 3 * hd, H * T), bf16)
    return conv1x1((ao.reshape(B, hd, H, T), None), (hd, 0), None, attn.w_out, attn.b_out, y,
                   attn.gain, new(c_out))


def attention_core_cuda(lib, qkv: torch.Tensor, bf16: bool = False):
    """`attention_core_plain` on the card: qkv a contiguous (B, 384, P)
    CUDA tensor. Returns (ctx, out)."""
    B, _, P = qkv.shape
    hd = HEADS * DIM_HEAD
    n_chunks = lib.attn_chunks(P)
    dev = qkv.device
    kpart = torch.empty((B, hd, n_chunks, 2), device=dev)
    cpart = torch.empty((B, HEADS, n_chunks, DIM_HEAD, DIM_HEAD), device=dev)
    ctx = torch.empty((B, HEADS, DIM_HEAD, DIM_HEAD), device=dev)
    out = torch.empty((B, hd, P), device=dev)
    p = _build.ptr
    _build.call(lib, _build.launcher("attention_core", bf16), p(qkv), p(kpart), p(cpart),
                p(ctx), p(out), B, P, _build.stream(qkv))
    return ctx, out
