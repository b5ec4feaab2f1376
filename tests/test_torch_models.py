"""Parity of the PyTorch port (`arttts_tpu_torch`) with the JAX package on
the v2 text -> wav path, on the CPU at small widths.

Inputs come from numpy with a fixed seed and go through both packages; the
JAX weights reach the port through the weight bridge
(`arttts_tpu_torch/utils/from_jax.py`). On CPU tensors the port's kernel
wrappers run their plain versions, so these tests pin the port's arithmetic
and wiring; the kernels themselves are held against those plain versions on
the card by `chip_smoke.py`.

Tolerances: RNG-free forwards atol 2e-4 (float32 on both sides, sums in
other orders); the sampler's few Euler steps grow that to about 4e-4
relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arttts_tpu.core.config import DecoderConfig, EncoderConfig, ModelConfig
from arttts_tpu.infer import sampler as jsampler
from arttts_tpu.models.hifigan import HiFiGANGenerator as JHiFiGAN
from arttts_tpu.models.tts import GradTTSModel as JGradTTS
from arttts_tpu.models.unet2d_fast import make_score_fn as j_make_score_fn
from arttts_tpu.models.unet2d_fast import unet2d_fast_supported
from arttts_tpu.utils.torch_convert import convert_hifigan_generator
from arttts_tpu.utils.torch_convert_acoustic import convert_grad_tts
from arttts_tpu_torch.core import config as pconfig
from arttts_tpu_torch.infer import sampler as psampler
from arttts_tpu_torch.models.hifigan import HiFiGANGenerator as PHiFiGAN
from arttts_tpu_torch.models.tts import GradTTSModel as PGradTTS
from arttts_tpu_torch.models.unet2d_fast import make_score_fn, masked_statistics
from arttts_tpu_torch.utils.from_jax import grad_tts_state_dict, hifigan_state_dict


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs (`tests/test_torch_cli.py`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N_FEATS = 16
VOC = dict(upsample_initial_channel=32)


def _jcfg(masked_norm=False):
    """v2's shape (text encoder, 2D U-Net dim 64 x (1, 2, 4), 8 groups) at
    small encoder widths and 16 feature rows."""
    return ModelConfig(
        name="grad_tts", n_feats=N_FEATS,
        encoder=EncoderConfig(kind="text", n_vocab=149, n_channels=32, filter_channels=64,
                              filter_channels_dp=32, n_heads=2, n_layers=2),
        decoder=DecoderConfig(masked_norm=masked_norm),
    )


def _pcfg(j):
    d = dataclasses.asdict(j)
    return pconfig.ModelConfig(**{**d, "encoder": pconfig.EncoderConfig(**d["encoder"]),
                                  "decoder": pconfig.DecoderConfig(**d["decoder"])})


_MODELS = {}


def _models(masked_norm=False):
    """(JAX model, JAX variables, port model) with the same random weights:
    the port's seeded weights, with small distinct Rezero gains (they start
    at 0, which silences attention), carried to JAX by the JAX package's
    own converter."""
    if masked_norm not in _MODELS:
        jcfg = _jcfg(masked_norm)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            pm = PGradTTS(_pcfg(jcfg)).eval()
        est = pm.decoder.estimator
        sites = [lv[2] for lv in est.downs] + [est.mid_attn] + [u[2] for u in est.ups]
        with torch.no_grad():
            for k, site in enumerate(sites):
                site.fn.g.fill_((0.03 + 0.01 * k) * (-1) ** k)
        params = convert_grad_tts(pm.state_dict(), n_enc_layers=jcfg.encoder.n_layers)
        _MODELS[masked_norm] = (JGradTTS(config=jcfg), {"params": params}, pm)
    return _MODELS[masked_norm]


def _vocoders():
    if "voc" not in _MODELS:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(1)
            pv = PHiFiGAN(n_mels=N_FEATS, **VOC).eval()
        params = convert_hifigan_generator(pv.state_dict())
        _MODELS["voc"] = (JHiFiGAN(**VOC), {"params": params}, pv)
    return _MODELS["voc"]


def _text(rng, B=2, T_x=12, lengths=(12, 9)):
    x = rng.integers(1, 149, size=(B, T_x)).astype(np.int32)
    return x, np.asarray(lengths, np.int32)


def _close(got, ref, atol=2e-4, rtol=2e-4):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), atol=atol, rtol=rtol)


def _same_tree(a, b):
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_bridge_round_trip():
    """The bridge covers the whole JAX tree and the JAX converters are its
    exact inverse, for the acoustic model and the vocoder."""
    jm, jv, pm = _models()
    shapes = jax.eval_shape(
        jm.init, {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.ones((1, 12), jnp.int32), jnp.full((1,), 12, jnp.int32),
        jnp.zeros((1, 64, N_FEATS)), jnp.ones((1, 64, 1)), jnp.zeros((1,)),
    )["params"]
    assert jax.tree_util.tree_map(lambda x: x.shape, shapes) == jax.tree_util.tree_map(
        lambda x: x.shape, jv["params"])
    sd = grad_tts_state_dict(jv["params"])
    assert sd.keys() == pm.state_dict().keys()
    _same_tree(convert_grad_tts(sd, n_enc_layers=2), jv["params"])
    jvoc, vv, pv = _vocoders()
    shapes = jax.eval_shape(jvoc.init, jax.random.PRNGKey(2), jnp.zeros((1, 8, N_FEATS)))
    assert jax.tree_util.tree_map(lambda x: x.shape, shapes["params"]) == (
        jax.tree_util.tree_map(lambda x: x.shape, vv["params"]))
    _same_tree(convert_hifigan_generator(hifigan_state_dict(vv["params"])), vv["params"])


def test_encode_text_parity(rng):
    jm, jv, pm = _models()
    x, lens = _text(rng)
    j = jsampler.encode_text(jm, jv, jnp.asarray(x), jnp.asarray(lens))
    p = psampler.encode_text(pm, torch.from_numpy(x), torch.from_numpy(lens), device="cpu")
    for name, a, b in zip(("mu_x", "logw", "x_mask", "pred_frames"), p, j):
        assert tuple(a.shape) == tuple(b.shape), name
        _close(a, b)
    _close(psampler.predict_lengths(pm, x, lens, device="cpu"),
           jsampler.predict_lengths(jm, jv, jnp.asarray(x), jnp.asarray(lens)))


def test_presets_and_shape_ops_match_jax(rng):
    """The port's copies of the presets, the symbol table and the shape
    helpers agree with the JAX package's."""
    from arttts_tpu.core.config import get_preset
    from arttts_tpu.ops import shape as jshape
    from arttts_tpu.text.symbols import symbols
    from arttts_tpu_torch.ops import shape as pshape
    from arttts_tpu_torch.text import symbols as psymbols

    assert psymbols.symbols == symbols
    for name in ("v0", "v1", "v1_1", "v2", "v2_phnmtext", "v3", "v4", "v4_phnmtext", "v5",
                 "v5_preblock", "v6", "v6_zhCN", "msml1h"):
        assert dataclasses.asdict(pconfig.get_preset(name)) == dataclasses.asdict(
            get_preset(name)), name
    dur = rng.integers(0, 5, size=(3, 7)).astype(np.float32)
    lens = np.asarray([7, 4, 1], np.int32)
    x_mask = (np.arange(7)[None] < lens[:, None]).astype(np.float32)
    mask = x_mask[:, :, None] * np.ones((1, 1, 20), np.float32)
    got = pshape.generate_path(torch.from_numpy(dur * x_mask), torch.from_numpy(mask))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jshape.generate_path(jnp.asarray(dur * x_mask), jnp.asarray(mask))))
    np.testing.assert_array_equal(
        pshape.sequence_mask(torch.from_numpy(lens), 9).numpy(),
        np.asarray(jshape.sequence_mask(jnp.asarray(lens), 9)))
    assert [pshape.fix_len_compatibility(n) for n in range(1, 40)] == [
        jshape.fix_len_compatibility(n) for n in range(1, 40)]


@pytest.mark.parametrize(
    "masked_norm,B,T,lengths",
    [
        (True, 2, 256, [256, 181]),   # masked statistics, eps 1e-5, padded batch
        (False, 2, 128, [128, 75]),   # bucket 128: statistics over padded frames
        (False, 1, 256, [256]),       # bucket 256 unpadded
    ],
)
def test_score_network_dispatch_parity(masked_norm, B, T, lengths):
    """The port's score function (kernel wrappers, plain versions on CPU)
    against the JAX package's dispatch (the module path on the CPU)."""
    jm, jv, pm = _models(masked_norm)
    rng = np.random.default_rng(T + B)
    xt = rng.standard_normal((B, T, N_FEATS)).astype(np.float32)
    mu = rng.standard_normal((B, T, N_FEATS)).astype(np.float32)
    mask = (np.arange(T)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)[..., None]
    t = rng.uniform(0.05, 0.95, size=(B,)).astype(np.float32)
    ref = jax.jit(j_make_score_fn(jm, jv, T))(*map(jnp.asarray, (xt, mask, mu, t)), None)
    with torch.inference_mode():
        got = make_score_fn(pm, T)(*map(torch.from_numpy, (xt, mask, mu, t)))
        module = pm.estimate_noise(*map(torch.from_numpy, (xt, mask, mu, t)))
    _close(got, ref)
    if not masked_norm and lengths[0] == T and T == 256:
        _close(module, ref)  # the module path, where both statistics agree


def test_masked_statistics_matches_jax_gate():
    """The port reproduces where the JAX package's TPU fast path (masked
    statistics) runs, including its VMEM limit at long buckets."""
    for n_feats, n_spks in ((16, 1), (80, 1), (16, 2)):  # n_spks 2: the v6 family
        j = dataclasses.replace(_jcfg(), n_feats=n_feats, n_spks=n_spks)
        p = _pcfg(j)
        for T in list(range(128, 4097, 128)) + [100, 2052]:
            assert masked_statistics(p, T) == unet2d_fast_supported(j, T), (n_feats, n_spks, T)
    assert masked_statistics(_pcfg(_jcfg(masked_norm=True)), 128)


@pytest.mark.parametrize("stoc", [False, True])
def test_reverse_diffusion_same_z(stoc):
    """Euler sampling from the same z. With `stoc` the two packages draw
    different numbers, so one step is held against the JAX score and the
    update formula fed the port generator's draw."""
    jm, jv, pm = _models(masked_norm=True)
    B, T = 2, 128
    n = 1 if stoc else 3
    rng = np.random.default_rng(11)
    z = rng.standard_normal((B, T, N_FEATS)).astype(np.float32)
    mu = rng.standard_normal((B, T, N_FEATS)).astype(np.float32)
    mask = (np.arange(T)[None, :] < np.asarray([128, 97])[:, None]).astype(np.float32)[..., None]
    got = psampler.reverse_diffusion(pm, *map(torch.from_numpy, (z, mask, mu)), n, stoc=stoc,
                                     generator=torch.Generator().manual_seed(5))
    if not stoc:
        ref = jsampler.reverse_diffusion(jm, jv, *map(jnp.asarray, (z, mask, mu)), n)
    else:
        eps = torch.randn((B, T, N_FEATS), generator=torch.Generator().manual_seed(5)).numpy()
        d = jm.config.decoder
        t = np.full((B,), 0.5, np.float32)
        beta = d.beta_min + (d.beta_max - d.beta_min) * 0.5
        xt = z * mask
        score = np.asarray(jax.jit(j_make_score_fn(jm, jv, T))(*map(jnp.asarray, (xt, mask, mu, t)), None))
        dxt = (0.5 * (mu - xt) - score) * beta + eps * np.sqrt(beta)
        ref = (xt - dxt) * mask
    _close(got, ref, atol=4e-4, rtol=4e-4)


def test_hifigan_parity(rng):
    jv, vv, pv = _vocoders()
    mel = rng.standard_normal((2, 20, N_FEATS)).astype(np.float32)
    ref = jax.jit(jv.apply)(vv, jnp.asarray(mel))
    with torch.inference_mode():
        got = pv(torch.from_numpy(mel))
    assert tuple(got.shape) == (2, 20 * 256, 1)
    _close(got, ref)


def test_synthesize_to_wav_parity(rng):
    """Text -> wav end to end against JAX `pallas=False`, durations from the
    predictor, temperature 1e6 (so z == mu_y to 1e-6), bucket 128."""
    jm, jv, pm = _models()
    jvoc, vv, pvoc = _vocoders()
    x, lens = _text(rng)
    wav_j, yl_j = jsampler.synthesize_to_wav(
        jm, jv, jvoc, vv, jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(lens),
        n_timesteps=3, max_frames=128, temperature=1e6, pallas=False,
    )
    wav_p, yl_p = psampler.synthesize_to_wav(
        pm, pvoc, torch.Generator().manual_seed(3), x, lens, n_timesteps=3,
        max_frames=128, temperature=1e6, device="cpu",
    )
    np.testing.assert_array_equal(yl_p.numpy(), np.asarray(yl_j))
    assert tuple(wav_p.shape) == (2, 128 * 256, 1)
    _close(wav_p, wav_j, atol=4e-4, rtol=4e-4)


def test_synthesize_pinned_durations(rng):
    """Pinned `x_durations` (the bench shape's protocol) give y_lengths and
    mu_y exactly as JAX does, with length_scale applied after the ceil."""
    jm, jv, pm = _models()
    x, lens = _text(rng, B=1, lengths=(12,))
    dur = np.full((1, 12), 5.3, np.float32)
    j = jsampler.synthesize(jm, jv, jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(lens),
                            n_timesteps=1, max_frames=64, temperature=1e6,
                            x_durations=jnp.asarray(dur), pallas=False)
    p = psampler.synthesize(pm, torch.Generator().manual_seed(0), x, lens, n_timesteps=1,
                            max_frames=64, temperature=1e6, x_durations=dur, device="cpu")
    assert int(p[3][0]) == int(j[3][0]) == 64  # 12 * ceil(5.3) = 72, clipped to 64
    _close(p[0], j[0])
    _close(p[2], j[2])


def test_serve_text_to_wav_bucket(rng, monkeypatch):
    """The request path picks the bucket exactly as the JAX package does."""
    jm, jv, pm = _models()
    x, lens = _text(rng, B=1, lengths=(12,))
    seen = {}

    def fake_decode(model, vocoder, generator, mu_x, logw, x_mask, n_timesteps, max_frames,
                    *a, **k):
        seen["bucket"] = max_frames
        return torch.zeros((1, max_frames * 256, 1)), torch.ones(1, dtype=torch.int32)

    monkeypatch.setattr(psampler, "synthesize_to_wav_from_encoding", fake_decode)
    _, _, _, pred = jsampler.encode_text(jm, jv, jnp.asarray(x), jnp.asarray(lens))
    pred_frames = int(np.ceil(float(jnp.max(pred))))
    want = jsampler.frame_bucket(
        min(jsampler.fix_len_compatibility(max(pred_frames, 4)), 2048))
    _, _, bucket = psampler.serve_text_to_wav(pm, None, torch.Generator(), x, lens,
                                              device="cpu")
    assert bucket == seen["bucket"] == want
    for f in (1, 4, 5, 128, 129, 700, 1024, 1025, 3001):
        assert psampler.frame_bucket(f) == jsampler.frame_bucket(f)
