"""The plain versions of the port's kernels (`arttts_tpu_torch/ops/
resblock2d.py`, `ops/updown.py`) against the JAX package, on the CPU.

Each plain version is what its CUDA kernel is held against on the card
(`chip_smoke.py`), so here it is held against the flax modules the TPU
kernels replace (`ResnetBlock2d`, `Block2d`, `Rezero(LinearAttention2d)`,
`Downsample2d`, `ConvTranspose2dTorch`; the JAX package's own tests pin its
Pallas kernels to those modules), plus two interpret-mode cases against the
Pallas kernels themselves (f32 dots), one of them in the masked-statistics,
eps 1e-6 mode no module has. Inputs are numpy draws from a fixed seed;
tolerance atol/rtol 2e-4 (float32 both sides, sums in other orders).

The last tests emulate the arithmetic of K1, K2, K3 and K4
(`csrc/resblock2d.cu`, `csrc/updown.cu`, `csrc/mrf.cu`: 3xTF32 on the tensor
cores) on the CPU and hold it to `chip_smoke.py`'s kernel tolerance against
the plain versions, and check the guards of K1's and K4's wrappers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from arttts_tpu.models.convs import ConvTranspose2dTorch
from arttts_tpu.models.unet2d import Block2d, Downsample2d, LinearAttention2d, ResnetBlock2d
from arttts_tpu_torch.ops import mrf
from arttts_tpu_torch.ops import resblock2d as K1
from arttts_tpu_torch.ops.resblock2d import AttnWeights, BlockWeights, frame_mask, resblock2d
from arttts_tpu_torch.ops.updown import conv_transpose2d, downsample2d


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs (`tests/test_torch_cli.py`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(p):  # flax (kh, kw, in, out) -> torch (out, in, kh, kw)
    return _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1))), _t(p["bias"])


def _block_weights(p, block_only=False):
    b0 = p if block_only else p["Block2d_0"]
    w1, b1 = _conv(b0["Conv_0"])
    w = dict(w1=w1, b1=b1, gn1_w=_t(b0["GroupNorm_0"]["scale"]),
             gn1_b=_t(b0["GroupNorm_0"]["bias"]))
    if not block_only:
        b1_ = p["Block2d_1"]
        w2, b2 = _conv(b1_["Conv_0"])
        w.update(w2=w2, b2=b2, gn2_w=_t(b1_["GroupNorm_0"]["scale"]),
                 gn2_b=_t(b1_["GroupNorm_0"]["bias"]))
        if "Conv_0" in p:
            w.update(w_res=_t(np.asarray(p["Conv_0"]["kernel"]).T), b_res=_t(p["Conv_0"]["bias"]))
    return BlockWeights(**w)


def _attn_params(rng, C):
    """LinearAttention2d params drawn at the module's init scale, gain 0.3."""
    la = {"Conv_0": {"kernel": rng.standard_normal((C, 384)).astype(np.float32) / np.sqrt(C)},
          "Conv_1": {"kernel": rng.standard_normal((128, C)).astype(np.float32) / np.sqrt(128),
                     "bias": 0.1 * rng.standard_normal(C).astype(np.float32)}}
    g = np.full((1,), 0.3, np.float32)
    port = AttnWeights(gain=_t(g), w_qkv=_t(la["Conv_0"]["kernel"].T),
                       w_out=_t(la["Conv_1"]["kernel"].T), b_out=_t(la["Conv_1"]["bias"]))
    return la, g, port


def _inputs(rng, B, H, T, c_in, lengths, c_t=64):
    x = rng.standard_normal((B, H, T, c_in)).astype(np.float32)
    mask = (np.arange(T)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)
    temb = rng.standard_normal((B, c_t)).astype(np.float32)
    return x, mask[:, None, :, None], temb


def _chunks(x, c_chunks):
    """(B, H, T, C) numpy -> list of (B, c_j, H, T) torch chunks."""
    offs = np.cumsum((0,) + tuple(c_chunks))
    xt = np.transpose(x, (0, 3, 1, 2))
    return [_t(xt[:, offs[j]:offs[j + 1]]).contiguous() for j in range(len(c_chunks))]


def _tvec(p, temb):
    m = temb * np.tanh(np.logaddexp(0.0, temb))  # mish
    return _t(m @ np.asarray(p["Dense_0"]["kernel"]) + np.asarray(p["Dense_0"]["bias"]))


def _nchw(y):
    return np.transpose(np.asarray(y), (0, 3, 1, 2))


def _close(got, ref, tol=2e-4):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=tol, rtol=tol)


@pytest.mark.parametrize(
    "c_chunks,c_out,masked,lengths,attn",
    [
        ((2,), 64, True, [64, 41], False),         # level-1 entry: 2 planes, projection
        ((64,), 64, False, [64, 37], False),       # identity residual, unmasked statistics
        ((128, 128), 64, False, [64], False),      # chunked skip input, projection
        ((64,), 64, True, [64, 50], True),         # attention fused behind the block
        ((128,), 128, False, [64, 29], True),      # attention at C=128, unmasked statistics
    ],
)
def test_resblock_plain_matches_module(c_chunks, c_out, masked, lengths, attn):
    rng = np.random.default_rng(c_out + sum(c_chunks) + len(lengths) + attn)
    B, H, T = len(lengths), 8, 64
    x, mask, temb = _inputs(rng, B, H, T, sum(c_chunks), lengths)
    mod = ResnetBlock2d(dim_out=c_out, masked_norm=masked)
    p = mod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask), jnp.asarray(temb))
    p = jax.tree_util.tree_map(np.asarray, p["params"])
    ref = mod.apply({"params": p}, x, mask, temb)
    aw = None
    if attn:
        la, g, aw = _attn_params(rng, c_out)
        ref = ref + g * LinearAttention2d().apply({"params": la}, ref)
    got = resblock2d(_chunks(x, c_chunks), torch.tensor(lengths, dtype=torch.int32),
                     _tvec(p, temb), _block_weights(p), masked_stats=masked,
                     eps=1e-5 if masked else 1e-6, attn=aw)
    _close(got, _nchw(ref))


@pytest.mark.parametrize("masked", [True, False])
def test_block_only_plain_matches_module(masked):
    rng = np.random.default_rng(3 + masked)
    lengths = [64, 45]
    x, mask, _ = _inputs(rng, 2, 8, 64, 64, lengths)
    mod = Block2d(dim_out=64, masked_norm=masked)
    p = jax.tree_util.tree_map(
        np.asarray, mod.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(mask))["params"])
    ref = mod.apply({"params": p}, x, mask)
    got = resblock2d(_chunks(x, (64,)), torch.tensor(lengths, dtype=torch.int32), None,
                     _block_weights(p, block_only=True), masked_stats=masked,
                     eps=1e-5 if masked else 1e-6)
    _close(got, _nchw(ref))


@pytest.mark.parametrize("C", [64, 128])
def test_downsample_plain_matches_module(C):
    rng = np.random.default_rng(C)
    lengths = [32, 19]
    x, mask, _ = _inputs(rng, 2, 8, 32, C, lengths)
    mod = Downsample2d(C)
    p = jax.tree_util.tree_map(np.asarray, mod.init(jax.random.PRNGKey(2), x)["params"])
    ref = mod.apply({"params": p}, x * mask)
    got = downsample2d(_chunks(x, (C,))[0], torch.tensor(lengths, dtype=torch.int32),
                       *_conv(p["Conv_0"]))
    assert tuple(got.shape) == (2, C, 4, 16)
    _close(got, _nchw(ref))


@pytest.mark.parametrize("C", [128, 64])
def test_conv_transpose_plain_matches_module(C):
    rng = np.random.default_rng(C + 1)
    lengths = [16, 9]
    x, mask, _ = _inputs(rng, 2, 4, 16, C, lengths)
    mod = ConvTranspose2dTorch(C, C, 4, 2, 1)
    p = jax.tree_util.tree_map(np.asarray, mod.init(jax.random.PRNGKey(3), x)["params"])
    p["bias"] = 0.1 * rng.standard_normal(C).astype(np.float32)
    ref = mod.apply({"params": p}, x * mask)
    got = conv_transpose2d(_chunks(x, (C,))[0], torch.tensor(lengths, dtype=torch.int32),
                           _t(p["weight"]), _t(p["bias"]))
    assert tuple(got.shape) == (2, C, 8, 32)
    _close(got, _nchw(ref))


@pytest.mark.parametrize("wide", [True, False])
def test_resblock_plain_matches_pallas_interpret(wide):
    """Against the TPU kernel itself in interpret mode with f32 dots:
    `resblock2d_wide` at C=128 in the masked-statistics eps 1e-6 mode (the
    v2 serving mode at buckets of 256 frames and up), and
    `resblock2d_packed` at C=64 with eps 1e-5; both with padded frames and
    the fused attention."""
    from arttts_tpu.ops import resblock2d_pallas as rp

    C, eps = (128, 1e-6) if wide else (64, 1e-5)
    rng = np.random.default_rng(17 + wide)
    B, H, T, lengths = 2, 8, 128, [128, 83]
    x, mask, temb = _inputs(rng, B, H, T, C, lengths)
    mod = ResnetBlock2d(dim_out=C, masked_norm=True)
    p = jax.tree_util.tree_map(np.asarray, mod.init(
        jax.random.PRNGKey(4), jnp.asarray(x), jnp.asarray(mask), jnp.asarray(temb))["params"])
    la, g, aw = _attn_params(rng, C)
    tv = _tvec(p, temb)
    lens = jnp.asarray(lengths, jnp.int32)
    if wide:
        out = rp.resblock2d_wide(
            (rp.pad_wide(jnp.asarray(x)),), lens, jnp.asarray(tv.numpy()),
            rp.pack_resblock_params_wide(p, (C,), C), c_out=C, eps=eps, interpret=True,
            bf16=False, attn_params=rp.pack_attn_params_wide(la, g))
        ref = rp.unpad_wide(out)
    else:
        out = rp.resblock2d_packed(
            rp.split_pack_image(jnp.asarray(x)), lens,
            jax.vmap(rp.pack_lane_vec)(jnp.asarray(tv.numpy())),
            rp.pack_resblock_params(p, C), c_in=C, eps=eps, interpret=True, bf16=False,
            attn_params=rp.pack_attn_params(la, g))
        ref = rp.unpack_image(out)
    got = resblock2d(_chunks(x, (C,)), torch.tensor(lengths, dtype=torch.int32), tv,
                     _block_weights(p), masked_stats=True, eps=eps, attn=aw)
    _close(got, _nchw(ref))


# ---- the 3xTF32 arithmetic of K1, K2 and K3 (csrc/*.cu), emulated -------------
TOL_KERNEL = 1e-4  # chip_smoke.py: max |kernel - plain| <= TOL * max(1, max |plain|)


def _tf32(a):
    """float32 -> TF32 as `cvt.rna.tf32.f32` rounds it: to nearest, ties away
    from zero, keeping 10 stored mantissa bits (the low 13 bits cleared)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_trunc(a):
    """float32 as the tensor core reads it for a TF32 operand: its top 19
    bits (the low 13 cleared, toward zero)."""
    return (a.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split(a):
    """The kernels' split: hi = tf32(a), lo = a - hi as the tensor core reads it."""
    hi = _tf32(a)
    return hi, _tf32_trunc(a - hi)


def _split_trunc(a):
    """K4's split (`csrc/mrf.cu`): hi = a with its low 13 bits cleared, lo =
    a - hi as the tensor core reads it."""
    hi = _tf32_trunc(a)
    return hi, _tf32_trunc(a - hi)


def _mma(acc, a, b, passes, split=_split):
    """acc += a @ b as the kernels' `mma.sync` steps: 3xTF32 (lo.hi, hi.lo,
    hi.hi, in that order) or one TF32 pass (the hi halves alone); TF32
    products are exact in float32."""
    (ah, al), (bh, bl) = split(a), split(b)
    if passes == 3:
        acc += al @ bh
        acc += ah @ bl
    acc += ah @ bh


def _k2_by_split(x, lengths, w, b, passes=3):
    """K2's decomposition: per 8-channel chunk, per tap, one k8 step over the
    chunk's channels; B from the even/odd column planes of the padded window."""
    B, C, H, T = x.shape
    Ho, To = (H + 1) // 2, (T + 1) // 2
    xp = F.pad(x * frame_mask(lengths, T, x.dtype), (1, 2, 1, 2))
    planes = (xp[..., 0::2], xp[..., 1::2])  # even and odd input columns
    acc = torch.zeros(w.shape[0], B * Ho * To)
    for ci0 in range(0, C, 8):
        for kh in range(3):
            for kw in range(3):
                win = planes[kw & 1][:, ci0:ci0 + 8, kh:kh + 2 * Ho:2, kw // 2:kw // 2 + To]
                _mma(acc, w[:, ci0:ci0 + 8, kh, kw], win.permute(1, 0, 2, 3).reshape(8, -1),
                     passes)
    return (acc.reshape(-1, B, Ho, To).permute(1, 0, 2, 3) + b[:, None, None])


def _k3_by_split(x, lengths, w, b, passes=3):
    """K3's decomposition: output (2a + py, 2c + px) is parity class (py, px),
    its taps ky = 1 - py + 2 jy, kx = 1 - px + 2 jx read input
    (a + py - jy, c + px - jx); per chunk, per class, per tap one k8 step."""
    B, C, H, T = x.shape
    xp = F.pad(x * frame_mask(lengths, T, x.dtype), (1, 1, 1, 1))
    out = torch.zeros(B, w.shape[1], 2 * H, 2 * T)
    for py in range(2):
        for px in range(2):
            acc = torch.zeros(w.shape[1], B * H * T)
            for ci0 in range(0, C, 8):
                for jy in range(2):
                    for jx in range(2):
                        ky, kx = 1 - py + 2 * jy, 1 - px + 2 * jx
                        r0, c0 = 1 + py - jy, 1 + px - jx
                        win = xp[:, ci0:ci0 + 8, r0:r0 + H, c0:c0 + T]
                        _mma(acc, w[ci0:ci0 + 8, :, ky, kx].t(),
                             win.permute(1, 0, 2, 3).reshape(8, -1), passes)
            out[:, :, py::2, px::2] = acc.reshape(-1, B, H, T).permute(1, 0, 2, 3)
    return out + b[:, None, None]


def _k1_product_by_split(x, w, b, passes=3, wk=4):
    """K1's 3x3 or 1x1 product (`igemm_body`): per staged chunk of 8 wk input
    channels, warp group k takes channels 8k..8k+7 and runs one k8 step per
    tap; the groups' sums are added in the order of k, then the bias. wk = 4
    is the tile of the deepest call (chunks (256, 256) -> 128 at 20x192)."""
    B, C, H, T = x.shape
    w4 = w if w.dim() == 4 else w[:, :, None, None]
    ks = w4.shape[-1]
    xp = F.pad(x, (ks // 2,) * 4)
    acc = [torch.zeros(w4.shape[0], B * H * T) for _ in range(wk)]
    for ci0 in range(0, C, 8):
        for kh in range(ks):
            for kw in range(ks):
                win = xp[:, ci0:ci0 + 8, kh:kh + H, kw:kw + T]
                _mma(acc[(ci0 // 8) % wk], w4[:, ci0:ci0 + 8, kh, kw],
                     win.permute(1, 0, 2, 3).reshape(win.shape[1], -1), passes)
    total = acc[0]
    for a in acc[1:]:
        total = total + a
    return total.reshape(-1, B, H, T).permute(1, 0, 2, 3) + b[:, None, None]


def _k1_wgmma_product_by_split(x, w, b, passes=3):
    """K1's 3x3 product on the `wgmma` route (`wgmma_body`): per staged
    chunk of 8 input channels, per tap, one k8 step of each pass (lo.hi,
    hi.lo, hi.hi; both operands split once, by truncation) into one
    accumulator; then the bias."""
    B, C, H, T = x.shape
    xp = F.pad(x, (1, 1, 1, 1))
    acc = torch.zeros(w.shape[0], B * H * T)
    for ci0 in range(0, C, 8):
        for tap in range(9):
            kh, kw = divmod(tap, 3)
            win = xp[:, ci0:ci0 + 8, kh:kh + H, kw:kw + T].permute(1, 0, 2, 3).reshape(8, -1)
            _mma(acc, w[:, ci0:ci0 + 8, kh, kw], win, passes, _split_trunc)
    return acc.reshape(-1, B, H, T).permute(1, 0, 2, 3) + b[:, None, None]


def _k1_by_split(xs, lengths, temb, w, passes=3, masked_stats=True, eps=1e-6, wgmma=False):
    """The block with K1's products emulated; GroupNorm, mish, the time
    embedding and the residual sum through `resblock2d_plain`'s code.
    `wgmma`: the 3x3 products on the `wgmma` route, else on the `mma.sync`
    body; 1x1 products are the `mma.sync` body's."""
    prod = lambda x, w_, b: _k1_product_by_split(x, w_, b, passes)  # noqa: E731
    conv3x3 = prod if not wgmma else (  # noqa: E731
        lambda x, w_, b: _k1_wgmma_product_by_split(x, w_, b, passes))
    return K1.block_with_products(xs, lengths, temb, w, masked_stats=masked_stats, eps=eps,
                                  conv3x3=conv3x3, conv1x1=prod)


def _k4_conv_by_split(x, w, b, dilation, passes=3):
    """K4's dilated conv1d (`csrc/mrf.cu`): per staged chunk of 8 input
    channels, per tap, one k8 step into one accumulator (no warp splits K),
    then the bias; SAME zero padding at the tensor's own frame range; K4's
    own split (hi truncated, not rounded)."""
    B, C, T = x.shape
    k = w.shape[-1]
    pad = dilation * (k - 1) // 2
    xp = F.pad(x, (pad, pad))
    acc = torch.zeros(w.shape[0], B * T)
    for ci0 in range(0, C, 8):
        for tap in range(k):
            win = xp[:, ci0:ci0 + 8, tap * dilation:tap * dilation + T]
            _mma(acc, w[:, ci0:ci0 + 8, tap], win.permute(1, 0, 2).reshape(8, -1), passes,
                 _split_trunc)
    return acc.reshape(-1, B, T).permute(1, 0, 2) + b[:, None]


def _k5_by_split(x, w, b, pad, outpad, passes=3):
    """K5's polyphase GEMM (`csrc/upsample1d.cu`): rows m = 2 co + r (the
    two output phases), depth k = 2 ci + s with A[m, k] = W[ci, co, r + 2s]
    and B[k, n] = lrelu(x)[ci, q_lo + n - s] (zero outside [0, T)); one k8
    step per 4 input channels into one accumulator, K4's split; then the
    phases interleaved into output frames 2q + r - pad, and the bias."""
    B, cin, T = x.shape
    cout = w.shape[1]
    t_out = (T - 1) * 2 - 2 * pad + 4 + outpad
    q_lo, q_hi = pad // 2, (t_out - 1 + pad) // 2
    n = q_hi - q_lo + 1
    xp = F.pad(F.leaky_relu(x, 0.1), (1, q_hi + 1 - T))  # column c holds q = c - 1
    a = w.permute(1, 2, 0).reshape(cout, 2, 2, cin)  # [co, s, r, ci] = W[ci, co, r + 2s]
    a = a.permute(0, 2, 3, 1).reshape(2 * cout, 2 * cin)
    bm = torch.stack([xp[:, :, q_lo + 1 - s:q_lo + 1 - s + n] for s in (0, 1)], dim=2)
    bm = bm.permute(1, 2, 0, 3).reshape(2 * cin, B * n)
    acc = torch.zeros(2 * cout, B * n)
    for k0 in range(0, 2 * cin, 8):
        _mma(acc, a[:, k0:k0 + 8], bm[k0:k0 + 8], passes, _split_trunc)
    out = acc.reshape(cout, 2, B, n).permute(2, 0, 3, 1).reshape(B, cout, 2 * n)
    first = pad - 2 * q_lo  # position of output frame 0 in the interleaved rows
    return out[:, :, first:first + t_out] + b[:, None]


def test_tf32_split_reproduces_float32():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(100_000, generator=g) * torch.exp(torch.randn(100_000, generator=g) * 4)
    tie = torch.tensor([1 + 2 ** -11, -(1 + 3 * 2 ** -11), 1 + 2 ** -12])
    assert _tf32(tie).tolist() == [1 + 2 ** -10, -(1 + 2 * 2 ** -10), 1.0]
    assert _tf32_trunc(torch.tensor([1 + 2 ** -10 + 2 ** -11])).item() == 1 + 2 ** -10
    hi = _tf32(x)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert ((hi - x).abs() <= x.abs() * 2.0 ** -11).all()
    err = (x.double() - hi.double()).abs() / x.abs().double()
    # lo rounded to TF32 as well: x to 2^-22; the kernels' lo (truncated by
    # the tensor core, one instruction less): x to 2^-21
    lo_rna = _tf32(x - hi)
    assert ((hi.double() + lo_rna.double() - x.double()).abs() / x.abs().double()
            <= 2.0 ** -22).all()
    hi_, lo = _split(x)
    assert torch.equal(hi_, hi) and not (lo.view(torch.int32) & 0x1FFF).any()
    rel = (hi.double() + lo.double() - x.double()).abs() / x.abs().double()
    assert (rel <= 2.0 ** -21).all() and rel.max() < err.max() * 2.0 ** -9
    # K4's split: hi truncated (x to 2^-10 alone), hi + lo to 2^-20
    hi_t, lo_t = _split_trunc(x)
    assert not ((hi_t.view(torch.int32) | lo_t.view(torch.int32)) & 0x1FFF).any()
    assert ((x - hi_t).abs() <= x.abs() * 2.0 ** -10).all() and (hi_t.abs() <= x.abs()).all()
    rel_t = (hi_t.double() + lo_t.double() - x.double()).abs() / x.abs().double()
    assert (rel_t <= 2.0 ** -20).all()


@pytest.mark.parametrize("kernel", ["downsample2d", "conv_transpose2d", "resblock2d",
                                    "mrf_stage", "upsample1d", "upsample1d 64->32",
                                    "resblock2d wgmma"])
def test_3xtf32_decomposition_holds_float32_tolerance(kernel):
    """The kernels' arithmetic on the CPU: their decomposition in 3xTF32 meets
    TOL_KERNEL against the plain version at C=128 (K = 1,152 for K2, 512 per
    class for K3), padded frames included, K1's at its deepest call,
    chunks (256, 256) -> 128 (K = 4,608 in the first conv, 512 in the
    residual projection), and K4's over a whole C=128 MRF stage (k 3/7/11,
    dilations 1/3/5, K up to 1,408, both sequence edges inside the 96
    frames), K1's block again with its 3x3 products in the `wgmma` route's
    order and split, and K5's polyphase
    GEMM at the vocoder's 128 -> 64 (K = 256)
    and 64 -> 32 (K = 128) upsamples, ragged T, at the padding of both
    vocoders (mel (k - u) // 2 and SPARC u // 2 + u % 2 with output padding
    u % 2 are both 1 and 0 at stride 2) and at padding 2 with output
    padding 1; the same decomposition in one TF32 pass misses it, which is
    why the kernels split."""
    from arttts_tpu_torch.ops import upsample
    from arttts_tpu_torch.ops import updown

    g = torch.Generator().manual_seed(1)
    C, lengths = 128, torch.tensor([64, 41], dtype=torch.int32)
    if kernel == "downsample2d":
        x = torch.randn(2, C, 8, 64, generator=g)
        w = torch.randn(C, C, 3, 3, generator=g) * (9 * C) ** -0.5
        emulate, plain = _k2_by_split, updown.downsample2d_plain
    elif kernel == "conv_transpose2d":
        x = torch.randn(2, C, 6, 64, generator=g)
        w = torch.randn(C, C, 4, 4, generator=g) * (4 * C) ** -0.5
        emulate, plain = _k3_by_split, updown.conv_transpose2d_plain
    elif kernel.startswith("resblock2d"):
        x = [torch.randn(2, 256, 4, 16, generator=g) for _ in range(2)]
        lengths = torch.tensor([16, 11], dtype=torch.int32)
        temb = torch.randn(2, C, generator=g)
        w = BlockWeights(
            w1=torch.randn(C, 512, 3, 3, generator=g) * (9 * 512) ** -0.5,
            b1=torch.randn(C, generator=g) * 0.1, gn1_w=1 + 0.1 * torch.randn(C, generator=g),
            gn1_b=torch.randn(C, generator=g) * 0.1,
            w2=torch.randn(C, C, 3, 3, generator=g) * (9 * C) ** -0.5,
            b2=torch.randn(C, generator=g) * 0.1, gn2_w=1 + 0.1 * torch.randn(C, generator=g),
            gn2_b=torch.randn(C, generator=g) * 0.1,
            w_res=torch.randn(C, 512, generator=g) * 512 ** -0.5,
            b_res=torch.randn(C, generator=g) * 0.1)
        emulate = lambda x, lengths, w, b, passes=3: _k1_by_split(  # noqa: E731
            x, lengths, temb, w, passes, wgmma=kernel.endswith("wgmma"))
        plain = lambda x, lengths, w, b: K1.resblock2d_plain(  # noqa: E731
            x, lengths, temb, w, masked_stats=True, eps=1e-6)
    elif kernel.startswith("upsample1d"):  # K5 at chip_smoke.py's weight scales
        cin, T, pad, outpad = (128, 37, 1, 0) if kernel == "upsample1d" else (64, 41, 2, 1)
        x = torch.randn(2, cin, T, generator=g)
        w = torch.randn(cin, cin // 2, 4, generator=g) * (2 * cin) ** -0.5
        emulate = lambda x, lengths, w, b, passes=3: _k5_by_split(  # noqa: E731
            x, w, b[:w.shape[1]], pad, outpad, passes)
        plain = lambda x, lengths, w, b: upsample.upsample1d_plain(  # noqa: E731
            x, w, b[:w.shape[1]], 2, pad, outpad)
    else:  # K4 at chip_smoke.py's weight scales
        x = torch.randn(2, C, 96, generator=g)
        w = tuple(mrf.MRFBranch(
            w1=torch.randn(3, C, C, k, generator=g) * (k * C) ** -0.5,
            b1=torch.randn(3, C, generator=g) * 0.1,
            w2=torch.randn(3, C, C, k, generator=g) * (k * C) ** -0.5,
            b2=torch.randn(3, C, generator=g) * 0.1, dilations=(1, 3, 5)) for k in (3, 7, 11))
        emulate = lambda x, lengths, w, b, passes=3: mrf.stage_with_products(  # noqa: E731
            x, w, conv=lambda i, w_, b_, d: _k4_conv_by_split(i, w_, b_, d, passes))
        plain = lambda x, lengths, w, b: mrf.mrf_stage_plain(x, w)  # noqa: E731
    b = torch.randn(C, generator=g) * 0.1
    ref = plain(x, lengths, w, b)
    limit = TOL_KERNEL * max(1.0, ref.abs().max().item())
    got = emulate(x, lengths, w, b)
    assert got.shape == ref.shape
    assert (got - ref).abs().max().item() <= limit / 10
    one_pass = emulate(x, lengths, w, b, passes=1)
    assert (one_pass - ref).abs().max().item() > limit


# ---- K1's wrapper: where it runs, and what it refuses before a launch ----------
def _guard_block(c_in=64, c_out=64, attn=False):
    w = BlockWeights(w1=torch.zeros(c_out, c_in, 3, 3), b1=torch.zeros(c_out),
                     gn1_w=torch.ones(c_out), gn1_b=torch.zeros(c_out),
                     w2=torch.zeros(c_out, c_out, 3, 3), b2=torch.zeros(c_out),
                     gn2_w=torch.ones(c_out), gn2_b=torch.zeros(c_out),
                     w_res=torch.zeros(c_out, c_in) if c_in != c_out else None,
                     b_res=torch.zeros(c_out) if c_in != c_out else None)
    a = (AttnWeights(gain=torch.zeros(1), w_qkv=torch.zeros(384, c_out),
                     w_out=torch.zeros(c_out, 128), b_out=torch.zeros(c_out)) if attn else None)
    return w, a


def test_resblock_wrapper_runs_plain_on_cpu_and_kernels_only_on_cuda():
    """On CPU tensors the wrapper is the plain version (no launch counted);
    on a tensor that reports a CUDA device it goes to the kernels' library
    (which this machine cannot build, so it raises: no fallback); any other
    device raises."""
    g = torch.Generator().manual_seed(2)
    xs = [torch.randn(2, 64, 4, 16, generator=g)]
    lens = torch.tensor([16, 9], dtype=torch.int32)
    temb = torch.randn(2, 64, generator=g)
    w, a = _guard_block(attn=True)
    before = (K1.resblock2d.launches, K1.resblock2d_plain.cuda_calls)
    got = resblock2d(xs, lens, temb, w, masked_stats=True, eps=1e-6, attn=a)
    ref = K1.resblock2d_plain(xs, lens, temb, w, masked_stats=True, eps=1e-6, attn=a)
    assert torch.equal(got, ref)
    assert (K1.resblock2d.launches, K1.resblock2d_plain.cuda_calls) == before
    with pytest.raises(ValueError, match="cpu or cuda"):
        resblock2d([xs[0].to("meta")], lens.to("meta"), temb.to("meta"), w, masked_stats=True,
                   eps=1e-6)

    class OnCard(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda")

    with pytest.raises(RuntimeError, match="CUDA"):
        resblock2d([xs[0].as_subclass(OnCard)], lens, temb, w, masked_stats=True, eps=1e-6)
    assert K1.resblock2d.launches == before[0]


@pytest.mark.parametrize("fault,match", [
    ("three chunks", "one or two input chunks"),
    ("c_out 96", "multiple of 64"),
    ("empty chunk", "empty operand"),
    ("no frames", "empty operand"),
    ("chunk 1 rows", "input chunk 1"),
    ("lengths int64", "lengths"),
    ("w1 shape", "w1"),
    ("w_res shape", "w_res"),
    ("identity residual", "identity residual"),
    ("w_qkv shape", "w_qkv"),
    ("gain shape", "gain"),
])
def test_resblock_launcher_refuses_malformed_operands(fault, match):
    """The CUDA side checks every operand before a pointer reaches
    `conv3x3`/`conv1x1` (checked on CPU tensors with no library: the checks
    raise first)."""
    x = torch.zeros(1, 64, 4, 16)
    lens = torch.tensor([16], dtype=torch.int32)
    temb = torch.zeros(1, 64)
    xs, w, a = [x], *_guard_block(attn=True)
    if fault == "three chunks":
        xs = [x, x, x]
    elif fault == "c_out 96":
        w = dataclasses.replace(w, w1=torch.zeros(96, 64, 3, 3))
    elif fault == "empty chunk":
        xs = [x, torch.zeros(1, 0, 4, 16)]
    elif fault == "no frames":
        xs = [torch.zeros(1, 64, 4, 0)]
    elif fault == "chunk 1 rows":
        xs = [torch.zeros(1, 32, 4, 16), torch.zeros(1, 32, 5, 16)]
    elif fault == "lengths int64":
        lens = lens.long()
    elif fault == "w1 shape":
        w = dataclasses.replace(w, w1=torch.zeros(64, 32, 3, 3))
    elif fault == "w_res shape":
        w, a = _guard_block(c_in=128, attn=True)
        xs = [torch.zeros(1, 128, 4, 16)]
        w = dataclasses.replace(w, w_res=torch.zeros(64, 64))
    elif fault == "identity residual":
        xs = [torch.zeros(1, 128, 4, 16)]
        w = dataclasses.replace(w, w1=torch.zeros(64, 128, 3, 3))
    elif fault == "w_qkv shape":
        a = dataclasses.replace(a, w_qkv=torch.zeros(128, 64))
    elif fault == "gain shape":
        a = dataclasses.replace(a, gain=torch.zeros(()))
    with pytest.raises(ValueError, match=match):
        K1._resblock2d_cuda(None, xs, lens, temb, w, True, 1e-6, a)


# ---- K1's 3x3 route: which body each product of the v2 and v6 U-Nets takes ------
SMS = 132  # the H100's SMs
# the `mma.sync` body's tiles, largest first: (output channels, rows) x 32 frames
_MMA_TILES = ((64, 4), (64, 2), (32, 2))


def _mma_blocks(B, c_out, H, T):
    """Blocks of the `mma.sync` body's launch (csrc/resblock2d.cu:pick_tile)."""
    counts = [-(-H // r) * -(-T // 32) * (c_out // m) * B for m, r in _MMA_TILES]
    return next((n for n in counts[:2] if n >= SMS), counts[2])


def _unet_3x3_shapes(c_first):
    """(c_in, c_out, level) of every 3x3 product of one score evaluation of
    the flagship U-Net (dim 64, mults 1/2/4, `models/unet2d_fast.py`): the
    first and second product of ResnetBlock2d_0..11 in their call order, and
    the final Block2d's one; level l runs at rows F / 2^l and frames T / 2^l."""
    blocks = [(c_first, 64, 0), (64, 64, 0), (64, 128, 1), (128, 128, 1), (128, 256, 2),
              (256, 256, 2), (256, 256, 2), (256, 256, 2), (512, 128, 2), (128, 128, 2),
              (256, 64, 1), (64, 64, 1)]
    return ([(ci, co, lv) for ci, co, lv in blocks] + [(co, co, lv) for _, co, lv in blocks]
            + [(64, 64, 0)])


# (configuration, feature rows, input planes of the first block, batch sizes,
# frame buckets): v2 serving (B=1) and the CLI's batches (B=4); v6.batch
# (B=16, items of 2-8 s at 50 Hz)
_ROUTE_CONFIGS = [("v2", 80, 2, (1, 4), (128, 256, 384, 512, 768, 1024)),
                  ("v6", 16, 3, (1, 4, 16), (128, 256, 384, 512))]


@pytest.mark.parametrize("config", [c[0] for c in _ROUTE_CONFIGS])
def test_conv3x3_route_fills_the_card_where_the_old_tiles_did(config):
    """`conv3x3_route` at every 3x3 shape of the configuration's U-Net at each
    bucket: the first block's 2 or 3 planes and the bf16 mode keep the
    `mma.sync` body; a routed product takes the first `wgmma` tile that gives
    every SM a block, so it reaches 132 blocks wherever the old tiles did;
    and the route takes most of an evaluation's operations at bucket 1024."""
    _, F_, c_first, batches, buckets = next(c for c in _ROUTE_CONFIGS if c[0] == config)
    for B in batches:
        for bucket in buckets:
            routed_flops = total_flops = 0
            for c_in, c_out, lv in _unet_3x3_shapes(c_first):
                H, T = F_ >> lv, bucket >> lv
                rows = K1.conv3x3_route(B, c_in, c_out, H, T, False, SMS)
                assert K1.conv3x3_route(B, c_in, c_out, H, T, True, SMS) == 0
                flops = 2 * 9 * c_in * c_out * B * H * T
                total_flops += flops
                if c_in in (2, 3):
                    assert rows == 0, (B, bucket, c_in)
                    continue
                counts = {r: -(-H // r) * -(-T // 64) * (c_out // 64) * B for r in K1.WGMMA_ROWS}
                if rows:
                    routed_flops += flops
                    assert counts[rows] >= SMS
                    assert all(counts[r] < SMS for r in K1.WGMMA_ROWS if r > rows)
                else:
                    assert max(counts.values()) < SMS, (B, bucket, c_in, c_out, H, T)
                old = _mma_blocks(B, c_out, H, T)
                new = counts[rows] if rows else old
                assert new >= SMS or old < SMS, (B, bucket, c_in, c_out, H, T, rows)
            if config == "v2" and B == 1 and bucket == 1024:
                # the longest requests: all but ResnetBlock2d_0's first product
                # and the 128-channel outputs at 20 rows
                assert routed_flops / total_flops > 0.85, routed_flops / total_flops


class _RecordingK1Lib:
    """Stands in for K1's library: answers `conv_tiles` and `attn_chunks` as
    csrc/resblock2d.cu does and records every launcher `_build.call` runs."""

    def __init__(self):
        self.calls = []

    def conv_tiles(self, B, c_out, H, T, rows):
        if rows:
            return -(-H // rows) * -(-T // 64)
        counts = [-(-H // r) * -(-T // 32) * (c_out // m) * B for m, r in _MMA_TILES]
        r = next((r for (m, r), n in zip(_MMA_TILES[:2], counts[:2]) if n >= SMS), 2)
        return -(-H // r) * -(-T // 32)

    def attn_chunks(self, P):
        return -(-P // 512)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("shape", ["ResnetBlock2d_0 at 80x768", "ResnetBlock2d_5+attn2 at 20x256",
                                   "ResnetBlock2d_9+attn4 at 20x256"])
def test_resblock_launches_each_product_on_its_route(monkeypatch, shape, bf16):
    """The wrapper's launches, recorded on the CPU: each 3x3 product goes to
    `conv3x3_wgmma` with the rows `conv3x3_route` gives, or to the
    `mma.sync` launcher; its GroupNorm partials are reduced over that
    route's tiles; the 1x1 products and the bf16 mode keep their launchers;
    `wgmma_launches` counts the calls with a product on the route."""
    c_in, c_out, H, T, attn = {"ResnetBlock2d_0 at 80x768": (2, 64, 80, 768, False),
                               "ResnetBlock2d_5+attn2 at 20x256": (256, 256, 20, 256, True),
                               "ResnetBlock2d_9+attn4 at 20x256": (128, 128, 20, 256, True)}[shape]
    lib = _RecordingK1Lib()
    monkeypatch.setattr(K1._build, "call", lambda lib_, fn, *args: lib_.calls.append((fn, args)))
    monkeypatch.setattr(K1._build, "stream", lambda t: 0)
    monkeypatch.setattr(K1, "_sm_count", lambda index: SMS)
    xs = [torch.zeros(1, c_in, H, T)]
    lens = torch.tensor([T], dtype=torch.int32)
    w, a = _guard_block(c_in, c_out, attn)
    before = (K1.resblock2d.launches, K1.resblock2d.wgmma_launches, K1.resblock2d.bf16_launches)
    K1._resblock2d_cuda(lib, xs, lens, torch.zeros(1, c_out), w, True, 1e-6, a, bf16)
    routes = [K1.conv3x3_route(1, c, c_out, H, T, bf16, SMS) for c in (c_in, c_out)]
    want = []
    for rows in routes:
        want.append(("conv3x3_wgmma", rows) if rows else
                    ("conv3x3_bf16" if bf16 else "conv3x3", None))
        want.append(("gn_stats", lib.conv_tiles(1, c_out, H, T, rows)))
        want.append(("gn_act", None))
    one = "conv1x1_bf16" if bf16 else "conv1x1"
    if c_in != c_out:
        want.insert(5, (one, None))
    if attn:
        want += [(one, None), ("attention_core_bf16" if bf16 else "attention_core", None),
                 (one, None)]
    got = [(fn, args[-2] if fn == "conv3x3_wgmma" else args[5] if fn == "gn_stats" else None)
           for fn, args in lib.calls]
    assert got == want
    assert routes == ([0, 0] if bf16 else {"ResnetBlock2d_0 at 80x768": [0, 4],
                                           "ResnetBlock2d_5+attn2 at 20x256": [2, 2],
                                           "ResnetBlock2d_9+attn4 at 20x256": [0, 0]}[shape])
    after = (K1.resblock2d.launches, K1.resblock2d.wgmma_launches, K1.resblock2d.bf16_launches)
    assert after == (before[0] + 1, before[1] + any(routes), before[2] + bf16)


# ---- K4's wrapper: where it runs, and what it refuses before a launch ----------
def _mrf_branch(C, k, dilations=(1, 3, 5)):
    n = len(dilations)
    return mrf.MRFBranch(w1=torch.zeros(n, C, C, k), b1=torch.zeros(n, C),
                         w2=torch.zeros(n, C, C, k), b2=torch.zeros(n, C), dilations=dilations)


def test_mrf_wrapper_runs_plain_on_cpu_and_kernels_only_on_cuda():
    """On CPU tensors `mrf_stage` is the plain version (no launch counted);
    on a tensor that reports a CUDA device it goes to the kernel's library
    (which this machine cannot build, so it raises: no fallback); any other
    device raises."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 32, 40, generator=g)
    w = tuple(dataclasses.replace(
        _mrf_branch(32, k), w1=torch.randn(3, 32, 32, k, generator=g) * (k * 32) ** -0.5,
        b2=torch.randn(3, 32, generator=g) * 0.1) for k in (3, 7, 11))
    film = (1 + 0.3 * torch.randn(3, 3, 2, 32, generator=g), torch.randn(3, 3, 2, 32, generator=g))
    before = (mrf.mrf_stage.launches, mrf.mrf_stage.film_launches, mrf.mrf_stage_plain.cuda_calls)
    got = mrf.mrf_stage(x, w, film)
    assert torch.equal(got, mrf.mrf_stage_plain(x, w, film))
    assert not torch.equal(got, mrf.mrf_stage_plain(x, w))
    assert (mrf.mrf_stage.launches, mrf.mrf_stage.film_launches,
            mrf.mrf_stage_plain.cuda_calls) == before
    with pytest.raises(ValueError, match="cpu or cuda"):
        mrf.mrf_stage(x.to("meta"), w)

    class OnCard(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda")

    with pytest.raises(RuntimeError, match="CUDA"):
        mrf.mrf_stage(x.as_subclass(OnCard), w)
    assert mrf.mrf_stage.launches == before[0]


@pytest.mark.parametrize("fault,match", [
    ("C 48", "channels"),
    ("x 2-D", "want \\(B, C, T\\)"),
    ("no branch", "at least one branch"),
    ("k 5", "kernel size"),
    ("dilations mismatched", "dilations"),
    ("dilation 0", "dilations"),
    ("halo 70 frames", "halo"),
    ("w1 C_in", "branch 0 w1"),
    ("b2 shape", "branch 1 b2"),
    ("film batch", "film a"),
    ("x strided", "x"),
])
def test_mrf_launcher_refuses_malformed_operands(fault, match):
    """The CUDA side checks every operand before a pointer reaches
    `mrf_round` (checked on CPU tensors with no library: the checks raise
    first), including the kernel's own limit on conv1's halo, (k - 1) *
    dilation <= MAX_HALO frames."""
    x = torch.zeros(2, 64, 40)
    w = [_mrf_branch(64, 3), _mrf_branch(64, 11)]
    film = None
    if fault == "C 48":
        x, w = torch.zeros(2, 48, 40), [_mrf_branch(48, 3)]
    elif fault == "x 2-D":
        x = torch.zeros(64, 40)
    elif fault == "no branch":
        w = []
    elif fault == "k 5":
        w = [_mrf_branch(64, 5)]
    elif fault == "dilations mismatched":
        w = [w[0], _mrf_branch(64, 7, (1, 3))]
    elif fault == "dilation 0":
        w = [_mrf_branch(64, 3, (1, 0, 5))]
    elif fault == "halo 70 frames":  # k = 11 at dilation 7; dilation 6 is the largest it takes
        assert (11 - 1) * 6 <= mrf.MAX_HALO < (11 - 1) * 7
        w = [w[0], _mrf_branch(64, 11, (1, 3, 7))]
    elif fault == "w1 C_in":
        w = [dataclasses.replace(w[0], w1=torch.zeros(3, 64, 32, 3)), w[1]]
    elif fault == "b2 shape":
        w = [w[0], dataclasses.replace(w[1], b2=torch.zeros(3, 32))]
    elif fault == "film batch":
        film = (torch.zeros(2, 3, 1, 64), torch.zeros(2, 3, 2, 64))
    elif fault == "x strided":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match=match):
        mrf._mrf_stage_cuda(None, x, w, film)
