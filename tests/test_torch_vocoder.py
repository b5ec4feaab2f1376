"""Parity of the port's vocoders (`arttts_tpu_torch/models/hifigan.py`,
`ops/mrf.py`, `ops/upsample.py`, `infer/chunked.py`) with the JAX package,
on the CPU at small widths.

The plain versions of kernels K4 (`mrf_stage`) and K5 (`upsample1d`) are
what the kernels are held against on the card (`chip_smoke.py`), so here
they are held against the JAX package's Pallas kernels in interpret mode
and against the flax modules those kernels replace. The fast paths
(`hifigan_forward_fast`, `spk_sparc_forward_fast`), which on CPU tensors
run the plain versions, are held against the JAX fast paths
(interpret mode) and the JAX modules. Inputs are numpy draws from a fixed
seed; weights reach the port through the weight bridge or the JAX
converters. Tolerance atol/rtol 2e-4 (float32 both sides, sums in other
orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arttts_tpu.ops.upsample_pallas as jups
from arttts_tpu.infer import chunked as jchunked
from arttts_tpu.models import hifigan as jh
from arttts_tpu.models.convs import conv_transpose_1d
from arttts_tpu.ops.mrf_pallas import mrf_stage as j_mrf_stage
from arttts_tpu.ops.mrf_pallas import pack_mrf_weights
from arttts_tpu.utils.torch_convert import convert_hifigan_generator, convert_spk_sparc
from arttts_tpu_torch.infer import chunked as pchunked
from arttts_tpu_torch.models import hifigan as ph
from arttts_tpu_torch.ops.mrf import MRFBranch, mrf_stage_plain
from arttts_tpu_torch.ops.upsample import upsample1d_plain
from arttts_tpu_torch.utils.from_jax import spk_sparc_state_dict


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs (`tests/test_torch_cli.py`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N_MELS = 16
RATES = dict(upsample_rates=(2, 2, 2, 2), upsample_kernel_sizes=(4, 4, 4, 4))
SPARC_RATES = dict(upsample_scales=(2, 2, 2, 2), upsample_kernel_sizes=(4, 4, 4, 4))
DILS = (1, 3, 5)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, ref, atol=2e-4, rtol=2e-4):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), atol=atol, rtol=rtol)


def _lrelu(x):
    return jnp.where(x >= 0, x, 0.1 * x)


def _resblock_params(rng, C, k):
    """Flax ResBlock params (conv1_{r}/conv2_{r}, kernels (k, in, out))."""
    s = (k * C) ** -0.5
    p = {}
    for r in range(len(DILS)):
        for name in ("conv1", "conv2"):
            p[f"{name}_{r}"] = {
                "kernel": (s * rng.standard_normal((k, C, C))).astype(np.float32),
                "bias": (0.1 * rng.standard_normal(C)).astype(np.float32)}
    return p


def _branch(p):
    """Flax ResBlock params -> the port's MRFBranch."""
    def stack(name, key):
        arrs = [np.asarray(p[f"{name}_{r}"][key]) for r in range(len(DILS))]
        return _t(np.stack([np.transpose(a, (2, 1, 0)) if a.ndim == 3 else a for a in arrs]))
    return MRFBranch(w1=stack("conv1", "kernel"), b1=stack("conv1", "bias"),
                     w2=stack("conv2", "kernel"), b2=stack("conv2", "bias"), dilations=DILS)


@pytest.mark.parametrize("film", [False, True], ids=["plain", "film"])
@pytest.mark.parametrize("C,T", [(32, 300), (64, 300), (128, 200)])
def test_mrf_stage_plain_matches_jax(rng, C, T, film):
    """K4's plain version against JAX `mrf_stage` (interpret mode, f32
    dots) and, without FiLM, against the flax ResBlock composite: all three
    kernel sizes, B=2, sequence edges inside the tile."""
    ks = (3, 7, 11)
    params = [_resblock_params(rng, C, k) for k in ks]
    x = rng.standard_normal((2, T, C)).astype(np.float32)
    fa = fb = None
    if film:
        fa = (1 + 0.3 * rng.standard_normal((3, 3, 2, C))).astype(np.float32)
        fb = (0.1 * rng.standard_normal((3, 3, 2, C))).astype(np.float32)
    got = mrf_stage_plain(_t(x.transpose(0, 2, 1)), [_branch(p) for p in params],
                          None if fa is None else (_t(fa), _t(fb)))
    got = got.numpy().transpose(0, 2, 1)
    want = j_mrf_stage(jnp.asarray(x), pack_mrf_weights(params, C), ks, DILS,
                       interpret=True, film=None if fa is None else (fa, fb), bf16=False)
    _close(got, want)
    if not film:
        ref = sum(jh.ResBlock(channels=C, kernel_size=k, dilations=DILS).apply(
            {"params": p}, jnp.asarray(x)) for k, p in zip(ks, params)) / 3
        _close(got, ref)


def _pack(x, r):
    B, T, C = x.shape
    return x.reshape(B, T // r, r * C)


@pytest.mark.parametrize("cin,cout,T", [(128, 64, 256), (64, 32, 512)])
def test_upsample1d_plain_matches_jax_kernel(rng, cin, cout, T):
    """K5's plain version against JAX `upsample_packed` (interpret mode),
    unpacked, at both stride-2 stage shapes."""
    x = rng.standard_normal((2, T, cin)).astype(np.float32)
    w = (0.1 * rng.standard_normal((cin, cout, 4))).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    r_in, r_out = 128 // cin, 128 // cout
    want = jups.upsample_packed(_pack(jnp.asarray(x), r_in), jnp.asarray(w), jnp.asarray(b),
                                2, 1, r_in=r_in, r_out=r_out, interpret=True)
    want = np.asarray(want).reshape(2, 2 * T, cout)
    got = upsample1d_plain(_t(x.transpose(0, 2, 1)), _t(w), _t(b), 2, 1)
    _close(got.numpy().transpose(0, 2, 1), want)


@pytest.mark.parametrize("u,k", [(2, 4), (3, 6), (8, 16)])
def test_upsample1d_plain_sparc_padding(rng, u, k):
    """K5's plain version with SPARC's padding u // 2 + u % 2 and output
    padding u % 2 against lrelu + the JAX torch-exact conv_transpose_1d."""
    pad, outpad = u // 2 + u % 2, u % 2
    x = rng.standard_normal((2, 33, 32)).astype(np.float32)
    w = (0.1 * rng.standard_normal((32, 32, k))).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    want = conv_transpose_1d(_lrelu(jnp.asarray(x)), jnp.asarray(w), u, pad,
                             output_padding=outpad) + b
    got = upsample1d_plain(_t(x.transpose(0, 2, 1)), _t(w), _t(b), u, pad, outpad)
    assert got.shape == (2, 32, 33 * u)
    _close(got.numpy().transpose(0, 2, 1), want)


_CACHE = {}


def _mel_vocoders():
    """(JAX generator, its variables, port generator): 512 initial channels
    at rates (2, 2, 2, 2), so the stages are C=256 (plain blocks), 128, 64
    and 32 (K4), every upsample stride 2 (K5 in the port)."""
    if "mel" not in _CACHE:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(4)
            pv = ph.HiFiGANGenerator(n_mels=N_MELS, **RATES).eval()
        params = convert_hifigan_generator(pv.state_dict())
        _CACHE["mel"] = (jh.HiFiGANGenerator(**RATES), {"params": params}, pv)
    return _CACHE["mel"]


@pytest.mark.parametrize("packed_chain", [False, True], ids=["unchained", "chained"])
def test_hifigan_forward_fast_parity(rng, packed_chain, monkeypatch):
    """The port's fast vocoder against JAX `hifigan_forward_fast`
    (interpret mode, with and without its packed stride-2 chain) and
    against `HiFiGANGenerator.apply`."""
    monkeypatch.setattr(jups, "ENABLE_PACKED_CHAIN", packed_chain)
    jv, vv, pv = _mel_vocoders()
    mel = rng.standard_normal((2, 8, N_MELS)).astype(np.float32)
    got = ph.hifigan_forward_fast(pv, _t(mel))
    assert tuple(got.shape) == (2, 8 * 16, 1)
    _close(got, jh.hifigan_forward_fast(jv, vv, jnp.asarray(mel), interpret=True))
    _close(got, jax.jit(jv.apply)(vv, jnp.asarray(mel)))


def _sparc_ckpt(sd):
    """The port's SpkSparc state dict -> the checkpoint form
    `convert_spk_sparc` reads."""
    parts = {"spk_ft": {}, "generator": {}}
    for k, v in sd.items():
        head, rest = k.split(".", 1)
        parts[head][rest] = v
    return {"state_dict": parts}


def _sparc_features(rng, B, T):
    c = rng.standard_normal((B, T, 14)).astype(np.float32)
    c[..., 12] = 120 + 30 * c[..., 12]  # pitch in Hz, rescaled inside
    return c


def test_spk_sparc_parity(rng):
    """SPARC generator at 512 channels, rates (2, 2, 2, 2), spk_ft 64: the
    bridge round trip, then the port's module path and fast path against
    JAX `apply` and `spk_sparc_forward_fast` (interpret mode). The caller's
    features are not rescaled in place."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(5)
        pm = ph.SpkSparcHiFiGANGenerator(spk_ft_size=64, **SPARC_RATES).eval()
    params = convert_spk_sparc(_sparc_ckpt(pm.state_dict()))
    sd = spk_sparc_state_dict(params)
    assert sd.keys() == pm.state_dict().keys()
    for k, v in pm.state_dict().items():
        assert torch.equal(sd[k], v), k
    jm = jh.SpkSparcHiFiGANGenerator(
        spk_ft_size=64, generator=jh.SparcHiFiGANGenerator(**SPARC_RATES))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 14)),
                            jnp.zeros((1, 64)))["params"]
    assert jax.tree_util.tree_map(lambda a: a.shape, shapes) == (
        jax.tree_util.tree_map(lambda a: np.shape(a), params))

    c = _sparc_features(rng, 2, 8)
    c_before = c.copy()
    spk = rng.standard_normal((2, 64)).astype(np.float32)
    ct = _t(c)
    with torch.inference_mode():
        module = pm(ct, _t(spk))
    fast = ph.spk_sparc_forward_fast(pm, ct, _t(spk))
    np.testing.assert_array_equal(ct.numpy(), c_before)
    assert tuple(fast.shape) == (2, 8 * 16, 1)
    v = {"params": params}
    want = jax.jit(jm.apply)(v, jnp.asarray(c), jnp.asarray(spk))
    _close(module, want)
    _close(fast, want)
    _close(fast, jh.spk_sparc_forward_fast(jm, v, jnp.asarray(c), jnp.asarray(spk),
                                           interpret=True))


def _small_pair(kind):
    """(JAX apply, port apply, feature width, spk width) for narrow
    generators (32 channels) of either family."""
    key = f"small {kind}"
    if key not in _CACHE:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(6)
            if kind == "mel":
                pm = ph.HiFiGANGenerator(n_mels=N_MELS, upsample_initial_channel=32).eval()
            else:
                pm = ph.SpkSparcHiFiGANGenerator(spk_ft_size=16, spk_emb_size=8,
                                                 channels=32).eval()
        if kind == "mel":
            jm = jh.HiFiGANGenerator(upsample_initial_channel=32)
            v = {"params": convert_hifigan_generator(pm.state_dict())}
            _CACHE[key] = (jax.jit(lambda c: jm.apply(v, c)),
                            lambda c: ph.hifigan_forward_fast(pm, c), N_MELS, None)
        else:
            jm = jh.SpkSparcHiFiGANGenerator(
                spk_ft_size=16, spk_emb_size=8,
                generator=jh.SparcHiFiGANGenerator(channels=32, spk_emb_size=8))
            v = {"params": convert_spk_sparc(_sparc_ckpt(pm.state_dict()))}
            _CACHE[key] = (jax.jit(lambda c, s: jm.apply(v, c, s)),
                            lambda c, s: ph.spk_sparc_forward_fast(pm, c, s), 14, 16)
    return _CACHE[key]


@pytest.mark.parametrize("kind", ["mel", "sparc"])
@pytest.mark.parametrize("T", [70, 29], ids=["windows", "short"])
def test_vocode_chunked_parity(rng, kind, T):
    """`vocode_chunked`, port against JAX, on the module apply functions of
    both (chunk 24, halo 8, win_batch 2): a track of several windows, the
    last group padded, and one shorter than a window (two placements)."""
    japply, papply, width, spk_width = _small_pair(kind)
    feats = (0.5 * rng.standard_normal((T, width))).astype(np.float32)
    spk = None if spk_width is None else rng.standard_normal(spk_width).astype(np.float32)
    kw = dict(chunk=24, halo=8, win_batch=2)
    assert pchunked._window_starts(T, 24, 8) == jchunked._window_starts(T, 24, 8)
    want = jchunked.vocode_chunked(
        (lambda v, c: japply(c)) if spk is None else (lambda v, c, s: japply(c, s)),
        None, feats, spk=spk, **kw)
    got = pchunked.vocode_chunked(papply, feats, spk=spk, device="cpu", **kw)
    assert got.shape == (T * 256,)
    _close(got, want)


def test_vocode_sparc_takes_the_fast_path(rng, monkeypatch):
    """`vocode_sparc` is `vocode_chunked` over `spk_sparc_forward_fast`, on
    a module that must live on the asked device."""
    _, papply, _, _ = _small_pair("sparc")
    calls = []
    real = pchunked.spk_sparc_forward_fast
    monkeypatch.setattr(pchunked, "spk_sparc_forward_fast",
                        lambda m, c, s: calls.append(c.shape) or real(m, c, s))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(6)
        pm = ph.SpkSparcHiFiGANGenerator(spk_ft_size=16, spk_emb_size=8, channels=32).eval()
    feats = _sparc_features(rng, 1, 40)[0]
    spk = rng.standard_normal(16).astype(np.float32)
    got = pchunked.vocode_sparc(pm, feats, spk, device="cpu", chunk=16, halo=8, win_batch=2)
    want = pchunked.vocode_chunked(papply, feats, spk=spk, device="cpu", chunk=16, halo=8,
                                   win_batch=2)
    np.testing.assert_array_equal(got, want)
    assert calls and all(s == (2, 32, 14) for s in calls)
    with pytest.raises(ValueError, match="lives on cpu"):
        pchunked.vocode_sparc(pm, feats, spk, device="meta")
