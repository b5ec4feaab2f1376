"""Parity of the port's multi-speaker articulatory model (GradTTArtic, the
v6 / v6_zhCN / msml1h presets) with the JAX package's, on the CPU.

The model is v6's shape at small encoder widths: 26 trait inputs, the 64-d
speaker embedding concatenated (transformer width 90, 2 heads of 45), no
duration predictor, the flagship 2D U-Net (dim 64) at 16 rows with the
speaker plane, a 1024-d speaker pre-embedding. The single-speaker ArtTTS
shape (v1: 25 inputs, 1 head, `proj_w`) is held beside it. Weights are the
port's, seeded, with small distinct Rezero gains, carried to JAX by the JAX
package's own converters; the bridge (`utils/from_jax.py`) must invert them
exactly. On CPU tensors the port's kernel wrappers run their plain
versions. Tolerances: RNG-free forwards atol/rtol 2e-4 (`_close`); the
vocoder through `run_sparc_vocoder` TOL_VOC 1e-3 on the wav, as
`chip_smoke.py` holds it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arttts_tpu.audio.io import load_wav, save_wav
from arttts_tpu.core.config import (DataConfig, DecoderConfig, EncoderConfig, ExperimentConfig,
                                    ModelConfig, TrainConfig)
from arttts_tpu.data.ms_datasets import MsPhnmDataset as JMsPhnmDataset
from arttts_tpu.infer import pipeline as jpipe
from arttts_tpu.infer import sampler as jsampler
from arttts_tpu.models import hifigan as jh
from arttts_tpu.models.tts import GradTTSModel as JGradTTS
from arttts_tpu.models.unet2d_fast import make_score_fn as j_make_score_fn
from arttts_tpu.utils.torch_convert import convert_spk_sparc
from arttts_tpu.utils.torch_convert_acoustic import convert_grad_ttartic, convert_grad_tts
from arttts_tpu.voxcommunis.data import FeatureTokenizer as JTokenizer
from arttts_tpu.voxcommunis.decoder import FeatureDecoder as JDecoder
from arttts_tpu.voxcommunis.io import write_manifest
from arttts_tpu_torch.core import config as pconfig
from arttts_tpu_torch.data.ms_datasets import MsPhnmDataset as PMsPhnmDataset
from arttts_tpu_torch.infer import pipeline as ppipe
from arttts_tpu_torch.infer import sampler as psampler
from arttts_tpu_torch.models import hifigan as ph
from arttts_tpu_torch.models.tts import GradTTSModel as PGradTTS
from arttts_tpu_torch.models.unet2d_fast import make_score_fn, masked_statistics
from arttts_tpu_torch.ops.resblock2d import resblock2d
from arttts_tpu_torch.utils.from_jax import grad_ttartic_state_dict, grad_tts_state_dict
from arttts_tpu_torch.voxcommunis.data import FeatureTokenizer as PTokenizer
from arttts_tpu_torch.voxcommunis.decoder import FeatureDecoder as PDecoder

N_LAYERS = 2
TOL_VOC = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite's parallel run
    (six pytest workers) shares the machine's cores, and torch's default of
    a thread a core then oversubscribes them (six concurrent runs of
    `tests/test_torch_cli.py`'s Heun gate took 1182 s with 8 threads each
    against 17 s with one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(kind="v6", masked_norm=False):
    enc = dict(n_channels=16, filter_channels=32, filter_channels_dp=16, n_layers=N_LAYERS)
    if kind == "v6":
        return ModelConfig(
            name="grad_ttartic", n_feats=16, n_spks=2,
            encoder=EncoderConfig(kind="ipa_trait", n_input_feats=26, n_heads=2,
                                  use_duration_predictor=False, **enc),
            decoder=DecoderConfig(masked_norm=masked_norm))
    return ModelConfig(name="art_tts", n_feats=16,
                       encoder=EncoderConfig(kind="ipa_trait", n_input_feats=25, n_heads=1,
                                             **enc),
                       decoder=DecoderConfig(masked_norm=masked_norm))


def _pcfg(j):
    d = dataclasses.asdict(j)
    return pconfig.ModelConfig(**{**d, "encoder": pconfig.EncoderConfig(**d["encoder"]),
                                  "decoder": pconfig.DecoderConfig(**d["decoder"])})


_MODELS = {}


def _models(kind="v6", masked_norm=False):
    """(JAX model, JAX variables, port model) with the same weights."""
    key = (kind, masked_norm)
    if key not in _MODELS:
        jcfg = _jcfg(kind, masked_norm)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(3)
            pm = PGradTTS(_pcfg(jcfg)).eval()
        est = pm.decoder.estimator
        sites = [lv[2] for lv in est.downs] + [est.mid_attn] + [u[2] for u in est.ups]
        with torch.no_grad():
            for k, site in enumerate(sites):
                site.fn.g.fill_((0.03 + 0.01 * k) * (-1) ** k)
        sd = pm.state_dict()
        params = (convert_grad_ttartic(sd, n_enc_layers=N_LAYERS) if kind == "v6"
                  else convert_grad_tts(sd, n_enc_layers=N_LAYERS))
        _MODELS[key] = (JGradTTS(config=jcfg), {"params": params}, pm)
    return _MODELS[key]


def _close(got, ref, atol=2e-4, rtol=2e-4):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), atol=atol, rtol=rtol)


def _traits(rng, B, T_x, n_in, lengths):
    x = rng.integers(-1, 2, size=(B, T_x, n_in)).astype(np.float32)
    if n_in == 26:
        x[..., -1] = rng.integers(1, 6, size=(B, T_x))  # repetition counts
    for b, n in enumerate(lengths):
        x[b, n:] = 0
    return x, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("kind", ["v6", "v1"])
def test_bridge_round_trip(kind):
    """The bridge covers the JAX tree (`init`'s shapes) and is the exact
    inverse of `convert_grad_ttartic` (v6) / `convert_grad_tts` (v1)."""
    jm, jv, pm = _models(kind)
    n_in = 26 if kind == "v6" else 25
    spk = jnp.zeros((1, 1024)) if kind == "v6" else None
    shapes = jax.eval_shape(
        jm.init, {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.ones((1, 12, n_in)), jnp.full((1,), 12, jnp.int32), jnp.zeros((1, 64, 16)),
        jnp.ones((1, 64, 1)), jnp.zeros((1,)), spk)["params"]
    assert jax.tree_util.tree_map(lambda a: a.shape, shapes) == jax.tree_util.tree_map(
        lambda a: np.shape(a), jv["params"])
    sd = (grad_ttartic_state_dict if kind == "v6" else grad_tts_state_dict)(jv["params"])
    assert sd.keys() == pm.state_dict().keys()
    for k, v in pm.state_dict().items():
        assert torch.equal(sd[k], v), k
    back = (convert_grad_ttartic(sd, n_enc_layers=N_LAYERS) if kind == "v6"
            else convert_grad_tts(sd, n_enc_layers=N_LAYERS))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(jv["params"])
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jv["params"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    if kind == "v6":
        assert not any(k.startswith("encoder.proj_w") for k in sd)
        assert pm.encoder.encoder.attn_layers[0].k_channels == 45  # (26 + 64) / 2 heads


@pytest.mark.parametrize("kind", ["v6", "v1"])
def test_encoder_and_speaker_layer_parity(kind, rng):
    """`encode` (the ipa_trait kind; v6 with the speaker concatenated and
    zero logw, v1 with its duration predictor) and `SpeakerEncodingLayer`."""
    jm, jv, pm = _models(kind)
    n_in = 26 if kind == "v6" else 25
    x, lens = _traits(rng, 2, 14, n_in, (14, 9))
    spk = rng.standard_normal((2, 1024)).astype(np.float32) if kind == "v6" else None
    j = jax.jit(lambda v, *a: jm.apply(v, *a, method="encode"))(
        jv, jnp.asarray(x), jnp.asarray(lens), None if spk is None else jnp.asarray(spk))
    with torch.inference_mode():
        p = pm.encode(torch.from_numpy(x), torch.from_numpy(lens),
                      None if spk is None else torch.from_numpy(spk))
    for a, b in zip(p, j):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a, b)
    if kind == "v6":
        assert float(p[1].abs().max()) == 0.0
        with torch.inference_mode():
            emb = pm.embed_speaker(torch.from_numpy(spk))
        _close(emb, jm.apply(jv, jnp.asarray(spk), method="embed_speaker"))
        assert tuple(emb.shape) == (2, 64)
        # the request path's one encoder pass: one frame a token without a predictor
        _, _, _, pred = psampler.encode_text(pm, x, lens, spk, device="cpu")
        np.testing.assert_array_equal(pred.numpy(), lens.astype(np.float32))
    else:
        _close(psampler.predict_lengths(pm, x, lens, device="cpu"),
               jnp.exp(j[1]) * j[2])
        _close(ppipe.predict_frames(pm, x, lens, device="cpu"),
               jpipe.predict_frames(jm, jv, jnp.asarray(x), jnp.asarray(lens)))


def _score_inputs(B, T, lengths, seed):
    rng = np.random.default_rng(seed)
    xt = rng.standard_normal((B, T, 16)).astype(np.float32)
    mu = rng.standard_normal((B, T, 16)).astype(np.float32)
    mask = (np.arange(T)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)[..., None]
    t = rng.uniform(0.05, 0.95, size=(B,)).astype(np.float32)
    spk = rng.standard_normal((B, 1024)).astype(np.float32)
    return xt, mask, mu, t, spk


@pytest.mark.parametrize("masked_norm", [False, True])
def test_estimator_module_path_with_speaker_plane(masked_norm):
    """The module path with the speaker plane at padded lengths: the plane
    is masked with the others before ResnetBlock2d_0."""
    jm, jv, pm = _models("v6", masked_norm)
    args = _score_inputs(2, 64, [64, 37], 5)
    ref = jax.jit(lambda v, *a: jm.apply(v, *a, method="estimate_noise"))(
        jv, *map(jnp.asarray, args))
    with torch.inference_mode():
        got = pm.estimate_noise(*map(torch.from_numpy, args))
    _close(got, ref)


@pytest.mark.parametrize(
    "masked_norm,B,T,lengths",
    [
        (True, 2, 256, [256, 181]),   # masked statistics, eps 1e-5, padded batch
        (False, 2, 128, [128, 75]),   # bucket 128: statistics over padded frames
        (False, 1, 256, [256]),       # bucket 256 unpadded
    ],
)
def test_score_network_with_speaker_parity(masked_norm, B, T, lengths):
    """The port's score function with `spk` (kernel wrappers, plain on the
    CPU: ResnetBlock2d_0 at c_in 3) against the JAX package's dispatch."""
    jm, jv, pm = _models("v6", masked_norm)
    xt, mask, mu, t, spk = _score_inputs(B, T, lengths, T + B)
    ref = jax.jit(j_make_score_fn(jm, jv, T))(*map(jnp.asarray, (xt, mask, mu, t, spk)))
    with torch.inference_mode():
        got = make_score_fn(pm, T)(*map(torch.from_numpy, (xt, mask, mu, t, spk)))
    _close(got, ref)


def test_resblock_c_in_3_plain_matches_pallas_interpret():
    """K1's plain version at ResnetBlock2d_0's shape with the speaker plane
    (c_in 3 -> 64, 16 rows, residual projection, masked statistics at eps
    1e-6: v6 at buckets of 256 frames and up) against the TPU kernel
    `resblock2d_packed` in interpret mode with f32 dots."""
    from arttts_tpu.models.unet2d import ResnetBlock2d
    from arttts_tpu.ops import resblock2d_pallas as rp

    rng = np.random.default_rng(23)
    B, H, T, lengths = 2, 16, 128, [128, 83]
    x = rng.standard_normal((B, H, T, 3)).astype(np.float32)
    mask = (np.arange(T)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)
    mask = mask[:, None, :, None]
    temb = rng.standard_normal((B, 64)).astype(np.float32)
    mod = ResnetBlock2d(dim_out=64, masked_norm=True)
    p = jax.tree_util.tree_map(np.asarray, mod.init(
        jax.random.PRNGKey(4), jnp.asarray(x), jnp.asarray(mask), jnp.asarray(temb))["params"])
    m = temb * np.tanh(np.logaddexp(0.0, temb))
    tv = m @ p["Dense_0"]["kernel"] + p["Dense_0"]["bias"]
    out = rp.resblock2d_packed(
        rp.split_pack_image(jnp.asarray(x)), jnp.asarray(lengths, jnp.int32),
        jax.vmap(rp.pack_lane_vec)(jnp.asarray(tv)), rp.pack_resblock_params(p, 3), c_in=3,
        eps=1e-6, interpret=True, bf16=False)
    ref = np.transpose(np.asarray(rp.unpack_image(out)), (0, 3, 1, 2))

    def conv(q):
        return (torch.from_numpy(np.transpose(q["kernel"], (3, 2, 0, 1)).copy()),
                torch.from_numpy(np.array(q["bias"])))

    from arttts_tpu_torch.ops.resblock2d import BlockWeights

    b0, b1 = p["Block2d_0"], p["Block2d_1"]
    (w1, bb1), (w2, bb2) = conv(b0["Conv_0"]), conv(b1["Conv_0"])
    w = BlockWeights(w1=w1, b1=bb1, gn1_w=torch.from_numpy(np.array(b0["GroupNorm_0"]["scale"])),
                     gn1_b=torch.from_numpy(np.array(b0["GroupNorm_0"]["bias"])), w2=w2, b2=bb2,
                     gn2_w=torch.from_numpy(np.array(b1["GroupNorm_0"]["scale"])),
                     gn2_b=torch.from_numpy(np.array(b1["GroupNorm_0"]["bias"])),
                     w_res=torch.from_numpy(p["Conv_0"]["kernel"].T.copy()),
                     b_res=torch.from_numpy(np.array(p["Conv_0"]["bias"])))
    got = resblock2d([torch.from_numpy(np.transpose(x, (0, 3, 1, 2)).copy())],
                     torch.tensor(lengths, dtype=torch.int32), torch.from_numpy(tv), w,
                     masked_stats=True, eps=1e-6)
    _close(got, ref)


def test_masked_statistics_at_v6_buckets():
    """v6 takes masked GroupNorm statistics at buckets 256 / 512 / 768 and
    unmasked ones at 128 / 384, where the JAX package's TPU gate holds."""
    p = _pcfg(_jcfg("v6"))
    assert [masked_statistics(p, T) for T in (128, 256, 384, 512, 768)] == [
        False, True, False, True, True]


def _ms_layout(root, rng, utterances):
    """The synthetic VoxCommunis layout of `tests/test_ms_inference.py`: one
    language, a manifest, a 100 Hz alignment of (phone, frames) runs, SPARC
    tracks and 1024-d speaker pre-embeddings."""
    lang = "ab"
    wavs = root / "wavs"
    wavs.mkdir()
    enc = root / "encoded_audio_multi" / lang
    (enc / "emasrc").mkdir(parents=True)
    (enc / "spk_preemb").mkdir(parents=True)
    lines = []
    for i, runs in enumerate(utterances):
        fid = f"cv_ab_{lang}_{i:04d}"
        save_wav(wavs / f"{fid}.wav", rng.standard_normal(1600) * 0.1, 16000)
        np.save(enc / "emasrc" / f"{fid}.npy", rng.standard_normal((40, 14)).astype(np.float32))
        np.save(enc / "spk_preemb" / f"{fid}.npy", rng.standard_normal(1024).astype(np.float32))
        lines.append(f"{fid}\t{' '.join(p for p, n in runs for _ in range(n))}")
    write_manifest(wavs, root / "man.tsv")
    (root / "align.align").write_text("\n".join(lines) + "\n")
    args = (root, root / "man.tsv", root / "align.align")
    return (JMsPhnmDataset(*args, JTokenizer(JDecoder(sum_diphthong=True))),
            PMsPhnmDataset(*args, PTokenizer(PDecoder(sum_diphthong=True))))


def test_run_acoustic_inference_and_sparc_vocoder_parity(tmp_path, rng):
    """`run_acoustic_inference(use_align=True)` over `MsPhnmDataset`: the
    (29, L) artifacts against the JAX package's (temperature 1e6, so z is
    mu_y to 1e-6): enc / dec rows within 2e-4, the input map and L exact.
    Then `run_sparc_vocoder` on one artifact against the JAX package's,
    with the FiLM vocoder at 32 channels, within TOL_VOC."""
    jds, pds = _ms_layout(tmp_path, rng, [
        [("SIL", 20), ("a", 40), ("t", 20)],                         # 40 frames
        [("SIL", 8), ("t͡ʃ", 30), ("aɪ", 52), ("kʰ", 14), ("ɛ", 70), ("˥", 36), ("SIL", 16)],
    ])
    jm, jv, pm = _models("v6")
    jexp = ExperimentConfig("tiny_ms", jm.config, DataConfig(dataset="ms_phnm_artic"),
                            TrainConfig())
    pexp = pconfig.ExperimentConfig("tiny_ms", pm.config)
    kw = dict(n_timesteps=2, temperature=1e6, use_align=True)
    jpaths = jpipe.run_acoustic_inference(jexp, jv, jds, str(tmp_path / "jax"), **kw)
    ppaths = ppipe.run_acoustic_inference(pexp, pm, pds, str(tmp_path / "port"), device="cpu",
                                          **kw)
    assert [p.rsplit("/", 1)[1] for p in ppaths] == [p.rsplit("/", 1)[1] for p in jpaths]
    for i, (pp, jp) in enumerate(zip(ppaths, jpaths)):
        a, b = np.load(pp), np.load(jp)
        L = int(np.ceil(pds[i]["durations"]).sum())
        assert a.shape == b.shape == (29, L)
        np.testing.assert_array_equal(a[28], b[28])
        _close(a[:28], b[:28])
        assert 0 <= a[28].min() and a[28].max() < pds[i]["x"].shape[0]
    assert np.load(ppaths[0]).shape[1] == 40

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(6)
        pvoc = ph.SpkSparcHiFiGANGenerator(spk_ft_size=1024, spk_emb_size=8, channels=32).eval()
    parts = {"spk_ft": {}, "generator": {}}
    for k, v in pvoc.state_dict().items():
        head, rest = k.split(".", 1)
        parts[head][rest] = v
    jvoc = jh.SpkSparcHiFiGANGenerator(spk_ft_size=1024, spk_emb_size=8,
                                       generator=jh.SparcHiFiGANGenerator(channels=32,
                                                                          spk_emb_size=8))
    vv = {"params": convert_spk_sparc({"state_dict": parts})}
    spk_ft = pds[0]["spk"]
    stats = dict(pitch_stats=(140.0, 25.0), loudness_stats=(-2.0, 0.5))
    jw = jpipe.run_sparc_vocoder(jvoc, vv, ppaths[:1], spk_ft, str(tmp_path / "jwav"), **stats)
    pw = ppipe.run_sparc_vocoder(pvoc, ppaths[:1], spk_ft, str(tmp_path / "pwav"),
                                 device="cpu", **stats)
    (wa, sa), (wb, sb) = load_wav(pw[0]), load_wav(jw[0])
    assert sa == sb == 16000 and wa.shape == wb.shape == (40 * 256,)
    assert np.isfinite(wa).all()
    np.testing.assert_allclose(wa, wb, atol=TOL_VOC, rtol=0)
    enc, dec, imap = ppipe.split_acoustic_artifact(np.load(ppaths[0]))
    je, jd, ji = jpipe.split_acoustic_artifact(np.load(ppaths[0]))
    for a, b in ((enc, je), (dec, jd), (imap, ji)):
        np.testing.assert_array_equal(a, b)
    for loud in (None, (-2.0, 0.5)):
        np.testing.assert_array_equal(
            ppipe.denormalize_sparc_features(dec, (140.0, 25.0), loud),
            jpipe.denormalize_sparc_features(dec, (140.0, 25.0), loud))


def test_sampler_threads_spk_through_every_solver(rng):
    """`synthesize` with `spk` and pinned durations against the JAX
    package's, with each solver: Euler (1 step), Heun (1 step, 2
    evaluations) and DPM-Solver++(2M) (2 steps, its least)."""
    jm, jv, pm = _models("v6")
    x, lens = _traits(rng, 1, 10, 26, (10,))
    spk = rng.standard_normal((1, 1024)).astype(np.float32)
    dur = np.full((1, 10), 6.0, np.float32)
    for solver, steps in (("euler", 1), ("heun", 1), ("dpm", 2)):
        j = jsampler.synthesize(jm, jv, jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(lens),
                                n_timesteps=steps, max_frames=64, temperature=1e6,
                                spk=jnp.asarray(spk), x_durations=jnp.asarray(dur),
                                solver=solver, pallas=False)
        p = psampler.synthesize(pm, torch.Generator().manual_seed(0), x, lens,
                                n_timesteps=steps, max_frames=64, temperature=1e6,
                                x_durations=dur, device="cpu", spk=spk, solver=solver)
        assert int(p[3][0]) == int(j[3][0]) == 60
        _close(p[0], j[0])
        _close(p[2], j[2])
        # DPM's data prediction divides by alpha(t=1) = 0.0066, so its
        # float32 rounding scales with its outputs: 2e-4 of max(1, max|ref|)
        scale = max(1.0, float(np.abs(np.asarray(j[1])).max())) if solver == "dpm" else 1.0
        _close(p[1], j[1], atol=2e-4 * scale)


def test_speaker_table_model_through_the_bridge(rng):
    """A multi-speaker model that is not GradTTArtic conditions on a speaker
    id through an embedding table (JAX `spk_table`, the port's `spk_emb`):
    the bridge maps the whole JAX tree (`init`'s shapes) to the port's
    state dict exactly, and `encode` and `estimate_noise` agree with JAX's."""
    jcfg = ModelConfig(name="grad_tts", n_feats=16, n_spks=3,
                       encoder=EncoderConfig(kind="text", n_vocab=149, n_channels=16,
                                             filter_channels=32, filter_channels_dp=16,
                                             n_heads=2, n_layers=1),
                       decoder=DecoderConfig(dim=8))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(4)
        pm = PGradTTS(_pcfg(jcfg)).eval()
    sd = pm.state_dict()
    params = convert_grad_tts(sd, n_enc_layers=1)  # no speaker parts: added as JAX names them
    params["spk_table"] = {"embedding": sd["spk_emb.weight"].numpy()}
    for k, name in ((2, "spk_mlp.0"), (3, "spk_mlp.2")):
        params["estimator"][f"Dense_{k}"] = {
            "kernel": sd[f"decoder.estimator.{name}.weight"].numpy().T,
            "bias": sd[f"decoder.estimator.{name}.bias"].numpy()}
    jm = JGradTTS(config=jcfg)
    shapes = jax.eval_shape(
        jm.init, {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.ones((1, 8), jnp.int32), jnp.full((1,), 8, jnp.int32), jnp.zeros((1, 64, 16)),
        jnp.ones((1, 64, 1)), jnp.zeros((1,)), jnp.zeros((1,), jnp.int32))["params"]
    assert jax.tree_util.tree_map(lambda a: a.shape, shapes) == jax.tree_util.tree_map(
        lambda a: np.shape(a), params)
    back = grad_tts_state_dict(params)
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    jv = {"params": params}
    x = rng.integers(1, 149, size=(2, 10)).astype(np.int32)
    lens, spk = np.array([10, 7], np.int32), np.array([2, 0], np.int32)
    j = jax.jit(lambda v, *a: jm.apply(v, *a, method="encode"))(
        jv, jnp.asarray(x), jnp.asarray(lens), jnp.asarray(spk))
    with torch.inference_mode():
        p = pm.encode(torch.from_numpy(x).long(), torch.from_numpy(lens),
                      torch.from_numpy(spk).long())
    for a, b in zip(p, j):
        _close(a, b)
    xt, mask, mu, t, _ = _score_inputs(2, 64, [64, 40], 8)
    ref = jax.jit(lambda v, *a: jm.apply(v, *a, method="estimate_noise"))(
        jv, *map(jnp.asarray, (xt, mask, mu, t, spk)))
    with torch.inference_mode():
        got = pm.estimate_noise(*map(torch.from_numpy, (xt, mask, mu, t)),
                                torch.from_numpy(spk).long())
    _close(got, ref)
