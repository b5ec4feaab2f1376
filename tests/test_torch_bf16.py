"""The bf16 mode of the port's kernels K1-K4 and the bf16 decoder, against
the JAX package on the CPU.

The JAX package's TPU serving path runs K1-K3 with bf16 dots by default
(`bf16=True` in `ops/resblock2d_pallas.py` and `ops/updown_pallas.py`) and
K4 with them on request (`ops/mrf_pallas.py`); the port's kernels take the
same mode with `bf16=True` (`kernel_bf16=True` on the serving entries).
Here each plain bf16 version, which the CUDA kernel is held against on the
card (`chip_smoke.py` phase 3b), is held against the JAX kernel in
interpret mode with `bf16=True`, within a stated band, and also to at most
half of the JAX kernel's own bf16-vs-float32 difference on the same
inputs: that shows the port rounds where the JAX kernel rounds, not merely
that it computes the float32 function. The `compute_dtype="bfloat16"`
decoder (the module path) is held the same way module by module against
the JAX modules. Whole networks (the port's bf16 score function against
the JAX package's `score2d_fast`, the bf16 estimator against the JAX one)
are chaotic at the ulp level, so there the port must be nearer than JAX's
float32 output with JAX's bf16 effect in size and direction, and the
port's float32 output must fail that. Inputs are numpy draws from fixed
seeds at small widths.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arttts_tpu.models.convs import ConvTranspose2dTorch
from arttts_tpu.models.unet2d import Block2d, Downsample2d, ResnetBlock2d
from arttts_tpu.ops import resblock2d_pallas as rp
from arttts_tpu.ops import updown_pallas as up
from arttts_tpu.ops.mrf_pallas import mrf_stage as j_mrf_stage
from arttts_tpu.ops.mrf_pallas import pack_mrf_weights
from arttts_tpu_torch.ops import mrf as K4
from arttts_tpu_torch.ops import resblock2d as K1
from arttts_tpu_torch.ops import updown as K23

# max |port bf16 - JAX bf16| <= BAND * max(1, max |JAX bf16|): the plain
# versions sum in another order than the interpret-mode dots, and where a
# float32 intermediate lands within an ulp of a bf16 rounding boundary the
# two round it apart. The attention's context (128 x 128 rounded entries
# each feeding every position) shows it most: measured 1.2e-3 with the
# fused attention at C=128, 5.7e-4 at C=64, at most 4.4e-4 elsewhere (K4),
# 2.6e-7 for K2/K3; at most 0.31 of JAX's own bf16-vs-f32 difference
BAND = 3e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite's parallel run
    shares the machine's cores (see tests/test_torch_cli.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _hold(got, jax_bf16, jax_f32, mask=None):
    """The two conditions on a plain bf16 version: within BAND of the JAX
    bf16 kernel, and at most half of the JAX kernel's own bf16-vs-f32
    difference. Returns (error, JAX's gap)."""
    got, ref, f32 = _np(got), _np(jax_bf16), _np(jax_f32)
    if mask is not None:
        got, ref, f32 = got * mask, ref * mask, f32 * mask
    err = float(np.abs(got - ref).max())
    gap = float(np.abs(ref - f32).max())
    assert np.isfinite(got).all()
    assert err <= BAND * max(1.0, float(np.abs(ref).max())), (err, gap)
    assert err <= 0.5 * gap, (err, gap)
    return err, gap


# ---- 1. the rounding helper ----------------------------------------------


def test_round_bf16_matches_jax_astype():
    """`round_bf16` (float32 -> bf16 -> float32) gives the bits of
    `jnp.asarray(v).astype(jnp.bfloat16)`: ties to even, values near the
    bf16 maximum (below the halfway point and at it), subnormals, signed
    zeros and the largest finite float32."""
    f = np.float32
    bits = [
        0x3F808000,  # 1 + 2^-8: halfway, ties to the even 1.0
        0x3F818000,  # 1 + 3 * 2^-8: halfway, ties to the even 1 + 2^-6
        0x3F808001,  # just above halfway: up
        0x3F807FFF,  # just below halfway: down
        0xBF818000,  # negative tie
        0x7F7F7FFF,  # bf16 max + less than half an ulp: bf16 max
        0x7F7F8000,  # bf16 max + half an ulp: ties to even, overflows to inf
        0x7F7FFFFF,  # float32 max: inf
        0xFF7F8000,  # the negative one: -inf
        0x00000001,  # smallest float32 subnormal: 0
        0x00008000,  # subnormal tie to even (0)
        0x00018000,  # subnormal tie to even (up)
        0x007FFFFF,  # largest subnormal: rounds to the smallest normal
        0x80000000,  # -0
        0x00000000,  # +0
        0x80012345,  # negative subnormal
    ]
    v = np.array(bits, np.uint32).view(f)
    v = np.concatenate([v, np.random.default_rng(0).standard_normal(1000).astype(f) * 1e3])
    want = np.asarray(jnp.asarray(v).astype(jnp.bfloat16).astype(jnp.float32)).view(np.uint32)
    got = K1.round_bf16(torch.from_numpy(v)).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)


# ---- 2. each kernel's plain bf16 version against the JAX kernel ----------


def _conv(p):  # flax (kh, kw, in, out) -> torch (out, in, kh, kw)
    return _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1))), _t(p["bias"])


def _block_weights(p):
    b0, b1 = p["Block2d_0"], p["Block2d_1"]
    w1, bb1 = _conv(b0["Conv_0"])
    w2, bb2 = _conv(b1["Conv_0"])
    w = dict(w1=w1, b1=bb1, gn1_w=_t(b0["GroupNorm_0"]["scale"]),
             gn1_b=_t(b0["GroupNorm_0"]["bias"]), w2=w2, b2=bb2,
             gn2_w=_t(b1["GroupNorm_0"]["scale"]), gn2_b=_t(b1["GroupNorm_0"]["bias"]))
    if "Conv_0" in p:
        w.update(w_res=_t(np.asarray(p["Conv_0"]["kernel"]).T), b_res=_t(p["Conv_0"]["bias"]))
    return K1.BlockWeights(**w)


def _attn_params(rng, C):
    la = {"Conv_0": {"kernel": rng.standard_normal((C, 384)).astype(np.float32) / np.sqrt(C)},
          "Conv_1": {"kernel": rng.standard_normal((128, C)).astype(np.float32) / np.sqrt(128),
                     "bias": 0.1 * rng.standard_normal(C).astype(np.float32)}}
    g = np.full((1,), 0.3, np.float32)
    port = K1.AttnWeights(gain=_t(g), w_qkv=_t(la["Conv_0"]["kernel"].T),
                          w_out=_t(la["Conv_1"]["kernel"].T), b_out=_t(la["Conv_1"]["bias"]))
    return la, g, port


def _nchw(y):
    return np.transpose(np.asarray(y), (0, 3, 1, 2))


@pytest.mark.parametrize(
    "layout,c_chunks,c_out,H,attn",
    [
        ("packed", (3,), 64, 8, False),        # ResnetBlock2d_0 with the speaker plane
        ("packed", (64,), 64, 8, True),        # ResnetBlock2d_1 + attention 0
        ("wide", (128,), 128, 8, True),        # ResnetBlock2d_3 + attention 1
        ("wide", (256, 256), 128, 4, False),   # ResnetBlock2d_8: two chunks of 256
        ("pad_in64", (64,), 128, 8, False),    # ResnetBlock2d_2: 64 channels in 128 lanes
        ("real64", (64,), 64, 8, True),        # ResnetBlock2d_11 + attention 5, 128 lanes
        ("block_only", (64,), 64, 8, False),   # the final Block2d
    ],
)
def test_resblock_bf16_plain_matches_jax_kernel(layout, c_chunks, c_out, H, attn):
    """K1's plain bf16 version against `resblock2d_packed` /
    `resblock2d_wide` with `bf16=True` in interpret mode at the layouts
    `score2d_fast` calls them in (masked statistics, padded frames), and
    within half of their bf16-vs-f32 gap."""
    rng = np.random.default_rng(sum(c_chunks) + c_out + attn)
    B, T, lengths, eps = 2, 128, [128, 83], 1e-5
    c_in = sum(c_chunks)
    mask = (np.arange(T)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)
    x = rng.standard_normal((B, H, T, c_in)).astype(np.float32) * mask[:, None, :, None]
    temb = rng.standard_normal((B, c_out)).astype(np.float32)
    if layout == "block_only":
        p = jax.jit(Block2d(c_out, masked_norm=True).init)(
            jax.random.PRNGKey(5), jnp.asarray(x), jnp.asarray(mask[:, None, :, None]))["params"]
    else:
        p = jax.jit(ResnetBlock2d(dim_out=c_out, masked_norm=True).init)(
            jax.random.PRNGKey(5), jnp.asarray(x), jnp.asarray(mask[:, None, :, None]),
            jnp.asarray(rng.standard_normal((B, 64)).astype(np.float32)))["params"]
    p = jax.tree_util.tree_map(np.asarray, p)
    la, g, aw = _attn_params(rng, c_out) if attn else (None, None, None)
    lens = jnp.asarray(lengths, jnp.int32)

    def jax_block(bf16):
        if layout == "block_only":
            out = rp.resblock2d_packed(
                rp.split_pack_image(jnp.asarray(x)), lens, jnp.zeros((B, 128)),
                rp.pack_block_params(p), c_in=64, block_only=True, eps=eps, interpret=True,
                bf16=bf16)
            return rp.unpack_image(out)
        if layout == "packed":
            out = rp.resblock2d_packed(
                rp.split_pack_image(jnp.asarray(x)), lens, jax.vmap(rp.pack_lane_vec)(temb),
                rp.pack_resblock_params(p, c_in), c_in=c_in, eps=eps, interpret=True,
                bf16=bf16, attn_params=rp.pack_attn_params(la, g) if attn else None)
            return rp.unpack_image(out)
        offs = np.cumsum((0,) + c_chunks)
        xs = [x[..., offs[j]:offs[j + 1]] for j in range(len(c_chunks))]
        real64 = layout == "real64"  # 64 channels carried in 128 lanes, in and out
        tv = jnp.asarray(temb)
        if layout == "pad_in64" or real64:
            xs = [np.pad(xs[0], ((0, 0),) * 3 + ((0, 64),))]
        if real64:
            tv = jnp.pad(tv, ((0, 0), (0, 64)))
        out = rp.resblock2d_wide(
            tuple(rp.pad_wide(jnp.asarray(a)) for a in xs), lens, tv,
            rp.pack_resblock_params_wide(p, c_chunks, c_out, real64=real64,
                                         pad_in64=layout == "pad_in64"),
            c_out=c_out, c_chunks=c_chunks, eps=eps, interpret=True, bf16=bf16, real64=real64,
            attn_params=rp.pack_attn_params_wide(la, g, real64=real64) if attn else None)
        return rp.unpad_wide(out)[..., :c_out]

    offs = np.cumsum((0,) + c_chunks)
    xt = np.transpose(x, (0, 3, 1, 2))
    xs = [_t(xt[:, offs[j]:offs[j + 1]]).contiguous() for j in range(len(c_chunks))]
    if layout == "block_only":
        w1, b1 = _conv(p["Conv_0"])
        w = K1.BlockWeights(w1=w1, b1=b1, gn1_w=_t(p["GroupNorm_0"]["scale"]),
                            gn1_b=_t(p["GroupNorm_0"]["bias"]))
    else:
        w = _block_weights(p)
    got = K1.resblock2d(xs, torch.tensor(lengths, dtype=torch.int32),
                        None if layout == "block_only" else _t(temb), w, masked_stats=True,
                        eps=eps, attn=aw, bf16=True)
    _hold(got, _nchw(jax_block(True)), _nchw(jax_block(False)))


@pytest.mark.parametrize("kind,C", [("down", 64), ("down", 128), ("convt", 128),
                                    ("convt", 64)])
def test_updown_bf16_plain_matches_jax_kernel(kind, C):
    """K2's and K3's plain bf16 versions against the four `updown_pallas`
    wrappers with `bf16=True` in interpret mode (one padded utterance of
    two), and within half of their bf16-vs-f32 gap."""
    rng = np.random.default_rng(C + (kind == "down"))
    B, H, T = 2, 16 if C == 64 else 8, 64
    lengths = [T, 41]
    m = (np.arange(T)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)
    x = rng.standard_normal((B, H, T, C)).astype(np.float32)
    lens = jnp.asarray(lengths, jnp.int32)
    if kind == "down":
        mod = Downsample2d(C)
        p = jax.jit(mod.init)(jax.random.PRNGKey(2), x)["params"]
        p = jax.tree_util.tree_map(np.asarray, p)
        m_out = (np.arange(T // 2)[None, :] < (np.asarray(lengths)[:, None] + 1) // 2)
        m_out = m_out.astype(np.float32)[:, None, None, :]

        def jax_down(bf16):
            if C == 64:
                out = up.downsample2d_to_real64(rp.pack_image(jnp.asarray(x)), lens,
                                                up.pack_downsample_params(p), interpret=True,
                                                bf16=bf16)
                return _nchw(rp.unpad_wide(out)[..., :64])
            out = up.downsample2d_wide(rp.pad_wide(jnp.asarray(x)), lens,
                                       up.pack_downsample_wide_params(p), interpret=True,
                                       bf16=bf16)
            return _nchw(rp.unpad_wide(out))

        got = K23.downsample2d(_t(np.transpose(x, (0, 3, 1, 2))).contiguous(),
                               torch.tensor(lengths, dtype=torch.int32), *_conv(p["Conv_0"]),
                               bf16=True)
        _hold(got, jax_down(True), jax_down(False), m_out)
        return
    mod = ConvTranspose2dTorch(C, C, 4, 2, 1)
    p = jax.tree_util.tree_map(np.asarray, jax.jit(mod.init)(jax.random.PRNGKey(3), x)["params"])
    p["bias"] = (0.1 * rng.standard_normal(C)).astype(np.float32)
    xm = x * m[:, None, :, None]
    m_out = (np.arange(2 * T)[None, :] < 2 * np.asarray(lengths)[:, None]).astype(np.float32)
    m_out = m_out[:, None, None, :]

    def jax_convt(bf16):
        if C == 64:  # a real64 buffer, lengths at the output's resolution
            out = up.conv_transpose2d_from_real64(
                rp.pad_wide(jnp.pad(jnp.asarray(xm), ((0, 0),) * 3 + ((0, 64),))),
                2 * lens, up.pack_convt_params(p), interpret=True, bf16=bf16)
            return _nchw(rp.unpack_image(out))
        out = up.conv_transpose2d_wide(rp.pad_wide(jnp.asarray(xm)), lens,
                                       up.pack_convt_wide_params(p), interpret=True, bf16=bf16)
        return _nchw(rp.unpad_wide(out))

    got = K23.conv_transpose2d(_t(np.transpose(xm, (0, 3, 1, 2))).contiguous(),
                               torch.tensor(lengths, dtype=torch.int32), _t(p["weight"]),
                               _t(p["bias"]), bf16=True)
    _hold(got, jax_convt(True), jax_convt(False), m_out)


DILS = (1, 3, 5)


def _mrf_params(rng, C, k):
    s = (k * C) ** -0.5
    return {f"{name}_{r}": {"kernel": (s * rng.standard_normal((k, C, C))).astype(np.float32),
                            "bias": (0.1 * rng.standard_normal(C)).astype(np.float32)}
            for r in range(len(DILS)) for name in ("conv1", "conv2")}


def _branch(p):
    def stack(name, key):
        arrs = [np.asarray(p[f"{name}_{r}"][key]) for r in range(len(DILS))]
        return _t(np.stack([np.transpose(a, (2, 1, 0)) if a.ndim == 3 else a for a in arrs]))
    return K4.MRFBranch(w1=stack("conv1", "kernel"), b1=stack("conv1", "bias"),
                        w2=stack("conv2", "kernel"), b2=stack("conv2", "bias"), dilations=DILS)


@pytest.mark.parametrize("C,T,film", [(32, 128, False), (64, 160, True), (128, 128, False)])
def test_mrf_bf16_plain_matches_jax_kernel(C, T, film):
    """K4's plain bf16 version against JAX `mrf_stage(bf16=True)` in
    interpret mode (three branches, k 3/7/11, B=2; FiLM on one case), and
    within half of its bf16-vs-f32 gap."""
    rng = np.random.default_rng(C + T)
    ks = (3, 7, 11)
    params = [_mrf_params(rng, C, k) for k in ks]
    x = rng.standard_normal((2, T, C)).astype(np.float32)
    f = None
    if film:
        f = ((1 + 0.3 * rng.standard_normal((3, 3, 2, C))).astype(np.float32),
             (0.1 * rng.standard_normal((3, 3, 2, C))).astype(np.float32))

    def jax_stage(bf16):
        out = j_mrf_stage(jnp.asarray(x), pack_mrf_weights(params, C), ks, DILS,
                          interpret=True, film=f, bf16=bf16)
        return np.transpose(np.asarray(out), (0, 2, 1))

    got = K4.mrf_stage(_t(x.transpose(0, 2, 1)).contiguous(), [_branch(p) for p in params],
                       None if f is None else (_t(f[0]), _t(f[1])), bf16=True)
    _hold(got, jax_stage(True), jax_stage(False))


# ---- 3. the wrappers take the mode on CPU tensors --------------------------


def test_wrappers_dispatch_bf16_on_cpu():
    """On CPU tensors each wrapper with `bf16=True` is its plain bf16
    version, bit for bit, and differs from the float32 mode; the Rezero
    gain is folded before W_o is rounded."""
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    B, H, T = 2, 4, 32
    lens = torch.tensor([32, 20], dtype=torch.int32)
    w = K1.BlockWeights(w1=r(64, 64, 3, 3) / 24, b1=r(64), gn1_w=1 + r(64) / 10, gn1_b=r(64),
                        w2=r(64, 64, 3, 3) / 24, b2=r(64), gn2_w=1 + r(64) / 10, gn2_b=r(64))
    a = K1.AttnWeights(gain=torch.full((1,), 0.3), w_qkv=r(384, 64) / 8, w_out=r(64, 128) / 11,
                       b_out=r(64))
    x, temb = r(B, 64, H, T), r(B, 64)
    kw = dict(masked_stats=True, eps=1e-5, attn=a)
    got = K1.resblock2d([x], lens, temb, w, bf16=True, **kw)
    assert torch.equal(got, K1.resblock2d_plain([x], lens, temb, w, bf16=True, **kw))
    assert not torch.equal(got, K1.resblock2d([x], lens, temb, w, **kw))
    folded = K1.AttnWeights(gain=torch.ones(1), w_qkv=a.w_qkv, w_out=a.gain * a.w_out,
                            b_out=a.gain * a.b_out)
    assert torch.equal(K1.resblock2d([x], lens, temb, w, bf16=True, **{**kw, "attn": folded}),
                       got)
    wd, bd = r(64, 64, 3, 3) / 24, r(64)
    wt, bt = r(64, 64, 4, 4) / 16, r(64)
    for fn, plain, wb in ((K23.downsample2d, K23.downsample2d_plain, (wd, bd)),
                          (K23.conv_transpose2d, K23.conv_transpose2d_plain, (wt, bt))):
        y = fn(x, lens, *wb, bf16=True)
        assert torch.equal(y, plain(x, lens, *wb, bf16=True))
        assert not torch.equal(y, fn(x, lens, *wb))
    br = [K4.MRFBranch(w1=r(3, 32, 32, k) / 10, b1=r(3, 32), w2=r(3, 32, 32, k) / 10,
                       b2=r(3, 32), dilations=DILS) for k in (3, 7)]
    xv = r(2, 32, 100)
    y = K4.mrf_stage(xv, br, bf16=True)
    assert torch.equal(y, K4.mrf_stage_plain(xv, br, bf16=True))
    assert not torch.equal(y, K4.mrf_stage(xv, br))


# ---- 4. the slice: the whole bf16 score function ----------------------------


def _jax_cfg(**decoder):
    from arttts_tpu.core.config import DecoderConfig, EncoderConfig, ModelConfig

    return ModelConfig(
        name="grad_tts", n_feats=16,
        encoder=EncoderConfig(kind="text", n_vocab=149, n_channels=32, filter_channels=64,
                              filter_channels_dp=32, n_heads=2, n_layers=1),
        decoder=DecoderConfig(**decoder))


def _port_model(jcfg, seed, gains):
    """The port's model for a JAX config, seeded weights, Rezero gains
    `gains` * (1 + k / 3) * (-1)^k at attention site k (0 silences them)."""
    from arttts_tpu_torch.core import config as pconfig
    from arttts_tpu_torch.models.tts import GradTTSModel

    d = dataclasses.asdict(jcfg)
    cfg = pconfig.ModelConfig(**{**d, "encoder": pconfig.EncoderConfig(**d["encoder"]),
                                 "decoder": pconfig.DecoderConfig(**d["decoder"])})
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        pm = GradTTSModel(cfg).eval()
    est = pm.decoder.estimator
    with torch.no_grad():
        for k, site in enumerate([lv[2] for lv in est.downs] + [est.mid_attn]
                                 + [u[2] for u in est.ups]):
            site.fn.g.fill_(gains * (1 + k / 3) * (-1) ** k)
    return pm


def _tracks_jax_bf16(got, j16, j32):
    """The whole-network rule, beside the distance checks: thirteen blocks
    deep the bf16 function is chaotic at the ulp level (a float32
    intermediate that crosses a bf16 rounding boundary flips one operand by
    an ulp, and the U-Net carries it on), so no second implementation that
    sums in another order lands within half of JAX's bf16-vs-f32 gap there;
    the rounding points are held to that closer bound module by module.
    Here the output's bf16 effect, `got - j32`, must be JAX's effect
    `j16 - j32` in size (between half and twice) and direction (cosine at
    least 0.3), and `got` nearer to JAX's bf16 output than JAX's float32 is
    (the L2 distance under the gap). The port's float32 output reads an
    effect of at most 3e-4 and a cosine of at most 0.08, so it fails; its
    bf16 output reads 1.0 and 0.74 on the slice, 1.0 and 0.63 on the
    decoder. Returns (ok, the three numbers)."""
    e, ej = (_np(got) - _np(j32)).ravel(), (_np(j16) - _np(j32)).ravel()
    n = dict(dist=float(np.linalg.norm(_np(got).ravel() - _np(j16).ravel()) / np.linalg.norm(ej)),
             effect=float(np.linalg.norm(e) / np.linalg.norm(ej)),
             cos=float(e @ ej / max(np.linalg.norm(e) * np.linalg.norm(ej), 1e-30)))
    return n["dist"] < 1 and 0.5 <= n["effect"] <= 2 and n["cos"] >= 0.3, n


def test_score_function_bf16_tracks_jax_score2d_fast():
    """The port's whole bf16 score function (`make_score_fn(...,
    kernel_bf16=True)`, K1-K3's plain bf16 versions on the CPU) against the
    JAX package's `score2d_fast` in interpret mode, whose kernels run in
    bf16 by default: 16 rows, 256 frames, dim 64, masked statistics, B=1
    (all four boundaries on K2/K3, as there). The port's float32 score
    function is held to the float32 module and must fail the bf16 rule
    (`_tracks_jax_bf16`); its largest distance from JAX's bf16 output
    equals JAX's own gap to four digits, so the max-abs check alone cannot
    tell the modes apart."""
    from arttts_tpu.models.tts import GradTTSModel as JGradTTS
    from arttts_tpu.models.unet2d_fast import score2d_fast
    from arttts_tpu.utils.torch_convert_acoustic import convert_grad_tts
    from arttts_tpu_torch.models.unet2d_fast import make_score_fn

    jcfg = dataclasses.replace(_jax_cfg(masked_norm=True), n_feats=16)
    pm = _port_model(jcfg, 0, 0.05)
    params = convert_grad_tts(pm.state_dict(), n_enc_layers=1)
    rng = np.random.default_rng(11)
    B, T, F = 1, 256, 16
    xt = rng.standard_normal((B, T, F)).astype(np.float32)
    mu = rng.standard_normal((B, T, F)).astype(np.float32)
    mask = np.ones((B, T, 1), np.float32)
    t = np.array([0.3], np.float32)
    args = tuple(map(jnp.asarray, (xt, mask, mu, t)))
    j_bf16 = np.asarray(jax.jit(lambda *a: score2d_fast(
        jcfg, params["estimator"], *a, interpret=True))(*args))
    j_f32 = np.asarray(jax.jit(lambda *a: JGradTTS(config=jcfg).apply(
        {"params": params}, *a, method="estimate_noise"))(*args))
    with torch.inference_mode():
        got = make_score_fn(pm, T, kernel_bf16=True)(*map(torch.from_numpy, (xt, mask, mu, t)))
        f32 = make_score_fn(pm, T)(*map(torch.from_numpy, (xt, mask, mu, t)))
    np.testing.assert_allclose(f32.numpy(), j_f32, atol=2e-4, rtol=2e-4)  # the float32 path
    err = float(np.abs(got.numpy() - j_bf16).max())
    gap = float(np.abs(j_bf16 - j_f32).max())
    assert gap > 1e-3  # the mode is in effect on both sides
    ok, n = _tracks_jax_bf16(got, j_bf16, j_f32)
    assert err < gap and ok, (err, gap, n)
    assert not _tracks_jax_bf16(f32, j_bf16, j_f32)[0]  # the control


# ---- 5. the compute_dtype="bfloat16" decoder (module path) -----------------


def _rel(a, b):
    return float(np.linalg.norm(_np(a) - _np(b)) / np.linalg.norm(_np(b)))


def _flax_conv(m):  # torch conv -> flax (kh, kw, in, out)
    return {"kernel": _np(m.weight).transpose(2, 3, 1, 0), "bias": _np(m.bias)}


def _flax_block(b):
    return {"Conv_0": _flax_conv(b.block[0]),
            "GroupNorm_0": {"scale": _np(b.block[1].weight), "bias": _np(b.block[1].bias)}}


def _flax_dense(m):  # nn.Linear or a 1x1 nn.Conv2d -> flax Dense
    w = _np(m.weight)
    p = {"kernel": (w[:, :, 0, 0] if w.ndim == 4 else w).T}
    return p if m.bias is None else {**p, "bias": _np(m.bias)}


def _module_case(kind, rng):
    """One decoder module of the port in float32 and bf16 on the same
    seeded weights, the JAX module on them, and bf16-exact inputs (B=2, 8
    rows, 32 frames, C=64, the second utterance padded from frame 20).
    Returns (port(dtype), jax(dtype or None)), outputs in the JAX layout."""
    from arttts_tpu.models.unet2d import LinearAttention2d, Rezero, SinusoidalPosEmb
    from arttts_tpu.models.unet2d import mish as jmish
    from arttts_tpu_torch.models import unet2d as P

    import flax.linen as fnn

    B, H, T, C = 2, 8, 32, 64
    c_in = 32 if kind == "resnet_res" else C
    bf = lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))  # noqa
    x = bf(rng.standard_normal((B, H, T, c_in)).astype(np.float32))
    mask = np.ones((B, 1, T, 1), np.float32)
    mask[1, :, 20:] = 0
    temb = bf(rng.standard_normal((B, 64)).astype(np.float32))
    t = np.array([0.3, 0.8], np.float32)
    nchw = lambda a, d: torch.from_numpy(a.transpose(0, 3, 1, 2).copy()).to(d)  # noqa: E731
    j = lambda a, d: jnp.asarray(a).astype(d or jnp.float32)  # noqa: E731
    dts = (torch.float32, torch.bfloat16)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(int(rng.integers(1 << 30)))
        if kind in ("block", "block_masked"):
            masked = kind == "block_masked"
            mods = {d: P.Block(c_in, C, 8, masked, dtype=d) for d in dts}
        elif kind.startswith("resnet"):
            mods = {d: P.ResnetBlock(c_in, C, 64, 8, True, dtype=d) for d in dts}
        elif kind == "attention":
            mods = {d: P.attention(C, dtype=d) for d in dts}
        elif kind == "time_mlp":
            mods = {d: P.GradLogPEstimator2d(64, compute_dtype=str(d).split(".")[1])
                    for d in dts}
        else:
            mods = {d: (P.Downsample if kind == "downsample" else P.Upsample)(C, dtype=d)
                    for d in dts}
    m = mods[torch.bfloat16]
    with torch.no_grad():
        if kind == "attention":
            m.fn.g.fill_(0.7)
        for v in m.modules():  # GroupNorm affine parameters away from 1 and 0
            if isinstance(v, P.GroupNorm):
                n = v.weight.shape[0]
                v.weight.copy_(_t(1 + 0.2 * rng.standard_normal(n)))
                v.bias.copy_(_t(0.1 * rng.standard_normal(n)))
    mods[torch.float32].load_state_dict(m.state_dict())

    if kind in ("block", "block_masked"):
        def jax_out(d):
            return Block2d(C, 8, kind == "block_masked", d).apply(
                {"params": _flax_block(m)}, j(x, d), j(mask, d))

        def port_out(d):
            return mods[d](nchw(x, d), nchw(mask, d))
    elif kind.startswith("resnet"):
        p = {"Block2d_0": _flax_block(m.block1), "Block2d_1": _flax_block(m.block2),
             "Dense_0": _flax_dense(m.mlp[1])}
        if m.res_conv is not None:
            p["Conv_0"] = _flax_dense(m.res_conv)

        def jax_out(d):
            return ResnetBlock2d(C, 8, True, d).apply({"params": p}, j(x, d), j(mask, d),
                                                      j(temb, d))

        def port_out(d):
            return mods[d](nchw(x, d), nchw(mask, d), torch.from_numpy(temb.copy()).to(d))
    elif kind == "attention":
        a = m.fn.fn
        p = {"fn": {"Conv_0": _flax_dense(a.to_qkv), "Conv_1": _flax_dense(a.to_out)},
             "g": np.full((1,), 0.7, np.float32)}

        def jax_out(d):
            return Rezero(LinearAttention2d(dtype=d)).apply({"params": p}, j(x, d))

        def port_out(d):
            return mods[d](nchw(x, d))
    elif kind == "time_mlp":  # the JAX estimator's lines for it (unet2d.py:222-229)
        def jax_out(d):
            cdt = d or jnp.float32
            emb = SinusoidalPosEmb(64).apply({}, jnp.asarray(t), scale=1000.0).astype(cdt)
            h = fnn.Dense(256, dtype=cdt).apply({"params": _flax_dense(m.mlp[0])}, emb)
            return fnn.Dense(64, dtype=cdt).apply({"params": _flax_dense(m.mlp[2])}, jmish(h))

        def port_out(d):
            return mods[d].time_embedding(torch.from_numpy(t))
    else:
        c = m.conv

        def jax_out(d):
            if kind == "downsample":
                return Downsample2d(C, d).apply({"params": {"Conv_0": _flax_conv(c)}}, j(x, d))
            return ConvTranspose2dTorch(C, C, 4, 2, 1, dtype=d).apply(
                {"params": {"weight": _np(c.weight), "bias": _np(c.bias)}}, j(x, d))

        def port_out(d):
            return mods[d](nchw(x, d))

    def port(d):
        with torch.inference_mode():
            o = port_out(d).float()
        return (o.permute(0, 2, 3, 1) if o.dim() == 4 else o).numpy()

    return port, lambda d: np.asarray(jax_out(d), np.float32)


@pytest.mark.parametrize("kind", ["block", "block_masked", "resnet_res", "resnet_id",
                                  "attention", "time_mlp", "downsample", "upsample"])
def test_bf16_decoder_module_matches_jax(kind):
    """Each module of the bf16 decoder (Block with flax GroupNorm and with
    masked statistics, ResnetBlock with a 1x1 and with an identity
    residual, Rezero(LinearAttention), the time MLP, Downsample, Upsample)
    against the JAX module with `dtype=bfloat16` on the same weights: the
    relative L2 error at most half of the JAX module's own bf16-vs-f32
    distance, so the port rounds where the JAX module rounds (the per-op
    mish, GroupNorm and the k softmax in float32, the time phases in
    float32). Measured 0 (time MLP, Downsample) to 0.069 of it
    (attention); the port's float32 module reads 1.0 and must fail."""
    port, jax_out = _module_case(kind, np.random.default_rng(7))
    j16, j32 = jax_out(jnp.bfloat16), jax_out(None)
    gap = _rel(j16, j32)
    assert gap > 1e-3  # the mode is in effect
    assert _rel(port(torch.bfloat16), j16) <= 0.5 * gap, (_rel(port(torch.bfloat16), j16), gap)
    assert _rel(port(torch.float32), j16) > 0.5 * gap  # the control


def test_bf16_decoder_matches_jax():
    """The port's v2 estimator with `compute_dtype="bfloat16"` against the
    JAX one on the same weights (B=2, 64 frames, 80 rows, one padded
    utterance, Rezero gains on): the relative L2 error under the JAX
    estimator's own bf16-vs-f32 gap and under `tests/test_compute_dtype.py`'s
    0.03, and the bf16 effect JAX's in size and direction
    (`_tracks_jax_bf16`), which the port's float32 estimator must fail.
    Both sides round every module output, so a single ulp flipped by another
    summation order is carried through the U-Net: measured 0.0177 against a
    gap of 0.0206 (ratio 0.86) here, 0.82-0.89 over other seeds and the
    preblock decoder; half the gap holds module by module
    (`test_bf16_decoder_module_matches_jax`). The output is float32."""
    from arttts_tpu.core.config import get_preset
    from arttts_tpu.models.tts import GradTTSModel as JGradTTS
    from arttts_tpu.utils.torch_convert_acoustic import convert_grad_tts

    j32 = get_preset("v2").model
    j32 = dataclasses.replace(j32, encoder=dataclasses.replace(j32.encoder, n_layers=1))
    j16 = dataclasses.replace(j32, decoder=dataclasses.replace(j32.decoder,
                                                               compute_dtype="bfloat16"))
    pm = _port_model(j16, 0, 0.3)
    v = {"params": convert_grad_tts(pm.state_dict(), n_enc_layers=1)}
    rng = np.random.default_rng(0)
    B, T, F = 2, 64, 80
    xt = rng.standard_normal((B, T, F)).astype(np.float32)
    mu = rng.standard_normal((B, T, F)).astype(np.float32)
    mask = np.ones((B, T, 1), np.float32)
    mask[1, 50:] = 0
    t = np.array([0.3, 0.8], np.float32)
    args = tuple(map(jnp.asarray, (xt, mask, mu, t)))
    # float32 through jit; bf16 op by op, each operation rounded as the
    # port's modules round it
    o32 = jax.jit(lambda *a: JGradTTS(config=j32).apply(v, *a, method="estimate_noise"))(*args)
    o16 = JGradTTS(config=j16).apply(v, *args, method="estimate_noise")
    p32 = _port_model(j32, 0, 0.3)
    p32.load_state_dict(pm.state_dict())
    with torch.inference_mode():
        got = pm.estimate_noise(*map(torch.from_numpy, (xt, mask, mu, t)))
        f32 = p32.estimate_noise(*map(torch.from_numpy, (xt, mask, mu, t)))
    assert got.dtype == torch.float32
    gap, err = _rel(o16, o32), _rel(got, o16)
    ok, n = _tracks_jax_bf16(got, o16, o32)
    assert err < gap and err < 0.03 and ok, (err, gap, n)
    assert not _tracks_jax_bf16(f32, o16, o32)[0]  # the control


def test_bf16_masked_norm_padding_invariance():
    """`tests/test_compute_dtype.py:58` on the port: with masked statistics
    the bf16 estimator's valid frames barely move when the input is padded
    to twice its frames (Rezero gains 0, as the JAX test has them at init:
    the attention's softmax spans the padded frames)."""
    from arttts_tpu.core.config import get_preset

    j = get_preset("v2").model
    j = dataclasses.replace(j, encoder=dataclasses.replace(j.encoder, n_layers=1),
                            decoder=dataclasses.replace(j.decoder, compute_dtype="bfloat16",
                                                        masked_norm=True))
    pm = _port_model(j, 1, 0.0)  # the attention (over padded frames too) silent, as at init
    rng = np.random.default_rng(1)
    B, T, F = 1, 32, 80
    xt, mu = (torch.from_numpy(rng.standard_normal((B, T, F)).astype(np.float32))
              for _ in range(2))
    mask, t = torch.ones(B, T, 1), torch.tensor([0.5])
    pad = lambda a: torch.nn.functional.pad(a, (0, 0, 0, T))  # noqa: E731
    with torch.inference_mode():
        out = pm.estimate_noise(xt, mask, mu, t)
        out_p = pm.estimate_noise(pad(xt), pad(mask), pad(mu), t)
    assert _rel(out_p[:, :T], out) < 0.02


def test_bf16_decoder_serves_on_the_module_path_and_trains(tmp_path):
    """A bf16 decoder takes no kernel (the JAX package's `unet2d_fast_supported`
    is false for it): `make_score_fn` returns the module path whatever
    `kernel_bf16` says, and its statistics are masked only with
    `masked_norm`. `Trainer` takes it, with float32 parameters and Adam
    (its step is held against the JAX package's in
    `tests/test_torch_train_bf16.py`); the 1D decoder ignores the field, as
    in the JAX package."""
    from arttts_tpu_torch.core.config import get_preset
    from arttts_tpu_torch.models.tts import build_model
    from arttts_tpu_torch.models.unet2d_fast import make_score_fn, masked_statistics
    from arttts_tpu_torch.train.trainer import Trainer

    exp = get_preset("v2")
    cfg = dataclasses.replace(exp.model, decoder=dataclasses.replace(
        exp.model.decoder, compute_dtype="bfloat16"))
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, n_layers=1))
    model = build_model(cfg, device="cpu")
    assert model.decoder.estimator.dtype == torch.bfloat16
    assert not masked_statistics(cfg, 256)
    g = torch.Generator().manual_seed(0)
    xt, mu = torch.randn(1, 32, 80, generator=g), torch.randn(1, 32, 80, generator=g)
    mask, t = torch.ones(1, 32, 1), torch.tensor([0.4])
    with torch.inference_mode():
        got = make_score_fn(model, 32, kernel_bf16=True)(xt, mask, mu, t)
        assert torch.equal(got, model.estimate_noise(xt, mask, mu, t))

    class Lengths(list):
        def lengths(self):
            return np.array([64, 48])

    trainer = Trainer(dataclasses.replace(exp, model=cfg), Lengths([{}, {}]), device="cpu",
                      log_dir=str(tmp_path))
    assert trainer.model.decoder.estimator.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
    assert all(p.dtype == torch.float32 for grp in trainer.optimizer.param_groups
               for p in grp["params"])
    exp1 = get_preset("v5").model  # the 1D decoder
    m1 = build_model(dataclasses.replace(exp1, decoder=dataclasses.replace(
        exp1.decoder, compute_dtype="bfloat16")), device="cpu")
    assert all(p.dtype == torch.float32 for p in m1.parameters())
