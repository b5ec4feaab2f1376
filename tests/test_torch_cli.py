"""Parity of the port's serving path for the single-speaker presets with the
JAX package's, on the CPU: the Heun and DPM-Solver++(2M) solvers, the 1D
U-Net and the preblock decoder, batched synthesis, the mel vocoder runner,
and the `synthesize` / `vocode` CLIs end to end on a tiny registered preset.

Models are seeded on the port's side (small distinct Rezero gains so the
linear attentions count) and carried to JAX by the JAX package's own
converters; the bridge (`utils/from_jax.py`) must invert them exactly. The
2D U-Net is the flagship one (dim 64) at 16 rows, on the kernels' plain
versions here; the 1D decoders run their modules at dim 16. Tolerances:
RNG-free forwards and solvers atol/rtol 2e-4 (`_close`); wavs through the
chunked vocoder TOL_VOC 1e-3, as `chip_smoke.py` holds them.
"""

import argparse
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arttts_tpu.audio.io import load_wav
from arttts_tpu.core.config import (DataConfig, DecoderConfig, EncoderConfig, ExperimentConfig,
                                    ModelConfig, TrainConfig)
from arttts_tpu.infer import pipeline as jpipe
from arttts_tpu.infer import sampler as jsampler
from arttts_tpu.models import hifigan as jh
from arttts_tpu.models.tts import GradTTSModel as JGradTTS
from arttts_tpu.text.phnms import build_phnm3
from arttts_tpu.utils.torch_convert import convert_hifigan_generator, convert_spk_sparc
from arttts_tpu.utils.torch_convert_acoustic import convert_estimator1d, convert_grad_tts
from arttts_tpu_torch.cli import synthesize as psynth
from arttts_tpu_torch.cli import vocode as pvocode
from arttts_tpu_torch.core import config as pconfig
from arttts_tpu_torch.core.checkpoint import save_checkpoint
from arttts_tpu_torch.infer import pipeline as ppipe
from arttts_tpu_torch.infer import sampler as psampler
from arttts_tpu_torch.models import hifigan as ph
from arttts_tpu_torch.models.tts import GradTTSModel as PGradTTS
from arttts_tpu_torch.models.unet1d import GradLogPEstimator1d
from arttts_tpu_torch.ops.resblock2d import resblock2d
from arttts_tpu_torch.utils.from_jax import estimator1d_state_dict, grad_tts_state_dict

N_LAYERS = 1
TOL_VOC = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite's parallel run
    (six pytest workers) shares the machine's cores, and torch's default of
    a thread a core then oversubscribes them (six concurrent runs of the
    Heun gate below took 1182 s with 8 threads each against 17 s with one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(decoder="unet2d", masked_norm=False, kind="ipa_trait"):
    enc = EncoderConfig(kind=kind, n_vocab=50 if kind == "text" else 0, n_input_feats=25,
                        n_channels=16, filter_channels=32, filter_channels_dp=16, n_heads=1,
                        n_layers=N_LAYERS)
    dim = 64 if decoder == "unet2d" else 16
    name = {"unet2d": "art_tts", "unet1d": "attention_tts",
            "unet1d_preblock": "attention_tts_preblock"}[decoder]
    return ModelConfig(name=name, n_feats=16, encoder=enc,
                       decoder=DecoderConfig(kind=decoder, dim=dim, masked_norm=masked_norm))


def _pcfg(j):
    d = dataclasses.asdict(j)
    return pconfig.ModelConfig(**{**d, "encoder": pconfig.EncoderConfig(**d["encoder"]),
                                  "decoder": pconfig.DecoderConfig(**d["decoder"])})


@functools.lru_cache(maxsize=None)
def _models(decoder="unet2d", masked_norm=False, kind="ipa_trait"):
    """(JAX model, JAX variables, port model) with the same weights."""
    jcfg = _jcfg(decoder, masked_norm, kind)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(5)
        pm = PGradTTS(_pcfg(jcfg)).eval()
    est = pm.decoder.estimator
    sites = [lv[2] for lv in est.downs] + [est.mid_attn] + [u[2] for u in est.ups]
    with torch.no_grad():
        for k, site in enumerate(sites):
            site.fn.g.fill_((0.03 + 0.01 * k) * (-1) ** k)
    params = convert_grad_tts(pm.state_dict(), n_enc_layers=N_LAYERS,
                              decoder_kind="unet1d" if decoder == "unet1d" else "unet2d")
    return JGradTTS(config=jcfg), {"params": params}, pm


def _close(got, ref, atol=2e-4, rtol=2e-4):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), atol=atol, rtol=rtol)


def _decoder_inputs(rng, B=2, T=64, F=16, lengths=(64, 40)):
    mask = (np.arange(T)[None, :, None] < np.asarray(lengths)[:, None, None]).astype(np.float32)
    mu = (0.3 * rng.standard_normal((B, T, F))).astype(np.float32) * mask
    z = (mu + 0.5 * rng.standard_normal((B, T, F)).astype(np.float32)) * mask
    return z, mask, mu


@pytest.mark.parametrize("solver,steps", [("heun", 3), ("dpm", 4)])
def test_solvers_match_jax(solver, steps, rng):
    """Heun and DPM-2M on a shared z, the U-Net on the kernels' plain
    versions, against the JAX solvers on the module path."""
    jm, jv, pm = _models()
    z, mask, mu = _decoder_inputs(rng)
    jfn = {"heun": jsampler.reverse_diffusion_heun, "dpm": jsampler.reverse_diffusion_dpm2m}
    pfn = {"heun": psampler.reverse_diffusion_heun, "dpm": psampler.reverse_diffusion_dpm2m}
    ref = jfn[solver](jm, jv, *map(jnp.asarray, (z, mask, mu)), steps, pallas=False)
    before = resblock2d.launches
    got = pfn[solver](pm, *map(torch.from_numpy, (z, mask, mu)), steps)
    assert resblock2d.launches == before  # CPU tensors: the plain versions, no launch
    assert got.shape == (2, 64, 16) and torch.isfinite(got).all()
    # DPM's first data prediction divides by alpha(t=1) = 0.0066: with a
    # random score field its outputs reach |x| ~ 120, and float32 rounding
    # scales with them (measured: max diff 3.8e-4, 3e-6 of max|ref|), so its
    # 2e-4 is taken relative to max(1, max|ref|); Heun's is absolute
    scale = max(1.0, float(np.abs(np.asarray(ref)).max())) if solver == "dpm" else 1.0
    _close(got, ref, atol=2e-4 * scale)


def test_dpm_schedule_and_step_count(rng):
    """The port's side of `test_dpm_runs_and_is_finite`: n < 2 raises; the
    schedule is the JAX package's float64 one (t from 1 down to t_end)."""
    _, _, pm = _models()
    z, mask, mu = map(torch.from_numpy, _decoder_inputs(rng))
    for n in (0, 1):
        with pytest.raises(ValueError, match="n_timesteps >= 2"):
            psampler.reverse_diffusion_dpm2m(pm, z, mask, mu, n)
    sched = psampler.dpm2m_schedule(0.05, 20.0, 10)
    assert sched.dtype == np.float64 and sched.shape == (10, 7)
    assert sched[0, 0] == pytest.approx(1.0) and sched[-1, 0] == pytest.approx(1e-2)
    assert np.all(np.diff(sched[:, 0]) < 0)
    calls = []

    def counting(xt, m, mu_, t, spk):
        calls.append(float(t[0]))
        return torch.zeros_like(xt)

    out = psampler.reverse_diffusion_dpm2m(pm, z, mask, mu, 5, score_fn=counting)
    assert len(calls) == 5 and torch.isfinite(out).all()  # one evaluation a step
    calls.clear()
    psampler.reverse_diffusion_heun(pm, z, mask, mu, 5, score_fn=counting)
    assert len(calls) == 10  # two a step
    # an unknown solver name runs Euler, as in the JAX package (its `else` branch)
    x, xl = np.ones((1, 5, 25), np.float32), np.array([5])
    other, euler = (psampler.synthesize(pm, torch.Generator().manual_seed(3), x, xl, 2, 64,
                                        device="cpu", solver=s)[1] for s in ("rk4", "euler"))
    assert torch.equal(other, euler)


def test_heun15_quality_gate_vs_euler50():
    """The port's side of the JAX gate `test_heun15_quality_gate_vs_euler50`:
    end-to-end `synthesize` with pinned durations (B=2, 40 frames in a
    48-frame bucket), Heun@15 against Euler@50, the same bounds (rel RMSE
    <= 0.2 and < half of Euler@15's)."""
    _, _, pm = _models(kind="text")
    r = np.random.default_rng(3)
    x = r.integers(1, 50, size=(2, 11))
    lens = np.array([11, 7])
    dur = np.full((2, 11), 40 / 11, np.float32)

    def synth(steps, solver):
        _, dec, _, yl = psampler.synthesize(pm, torch.Generator().manual_seed(7), x, lens,
                                            steps, 48, x_durations=dur, device="cpu",
                                            solver=solver)
        return dec.numpy(), yl.numpy()

    dec50, yl = synth(50, "euler")
    dec15h, _ = synth(15, "heun")
    dec15e, _ = synth(15, "euler")
    mask = (np.arange(48)[None, :, None] < yl[:, None, None]).astype(np.float32)

    def rel_rmse(a, b):
        d = (a - b) * mask
        sig = np.sqrt(((b * mask) ** 2).sum() / mask.sum())
        return float(np.sqrt((d ** 2).sum() / mask.sum()) / sig)

    e_heun, e_euler = rel_rmse(dec15h, dec50), rel_rmse(dec15e, dec50)
    assert e_heun <= 0.20, e_heun
    assert e_heun < 0.5 * e_euler, (e_heun, e_euler)


@pytest.mark.parametrize("masked_norm", [False, True], ids=["plain_norm", "masked_norm"])
@pytest.mark.parametrize("decoder", ["unet1d", "unet1d_preblock"])
def test_1d_decoders_match_jax(decoder, masked_norm, rng):
    """`GradLogPEstimator1d` (v5) and the preblock decoder (v5_preblock: the
    2D body behind `PreBlock`) against JAX `estimate_noise`, padded frames
    in the batch; the sampler's score function is the module here."""
    jm, jv, pm = _models(decoder, masked_norm)
    est = pm.decoder.estimator
    assert isinstance(est, GradLogPEstimator1d) == (decoder == "unet1d")
    assert (est.preblock is not None) == (decoder == "unet1d_preblock")
    z, mask, mu = _decoder_inputs(rng, T=32, lengths=(32, 21))
    t = np.array([0.7, 0.2], np.float32)
    ref = jax.jit(lambda v, *a: jm.apply(v, *a, method="estimate_noise"))(
        jv, *map(jnp.asarray, (z, mask, mu, t)))
    from arttts_tpu_torch.models.unet2d_fast import make_score_fn

    score = make_score_fn(pm, T=32)
    with torch.inference_mode():
        got = score(*map(torch.from_numpy, (z, mask, mu, t)))
    _close(got, ref)
    _close(got * torch.from_numpy(1 - mask), np.zeros_like(z))


@pytest.mark.parametrize("decoder", ["unet1d", "unet1d_preblock"])
def test_1d_bridge_round_trip(decoder):
    """The bridge covers the JAX tree (`init`'s shapes) and inverts
    `convert_estimator1d` / the preblock converter exactly."""
    jm, jv, pm = _models(decoder)
    shapes = jax.eval_shape(
        jm.init, {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.ones((1, 12, 25)), jnp.full((1,), 12, jnp.int32), jnp.zeros((1, 32, 16)),
        jnp.ones((1, 32, 1)), jnp.zeros((1,)))["params"]
    assert jax.tree_util.tree_map(lambda a: a.shape, shapes) == jax.tree_util.tree_map(
        lambda a: np.shape(a), jv["params"])
    sd = grad_tts_state_dict(jv["params"])
    assert sd.keys() == pm.state_dict().keys()
    for k, v in pm.state_dict().items():
        assert torch.equal(sd[k], v), k
    if decoder == "unet1d":
        est = estimator1d_state_dict(jv["params"]["estimator"])
        back = convert_estimator1d({k: v.numpy() for k, v in est.items()})
        for a, b in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(jv["params"]["estimator"])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        assert any(k.startswith("decoder.estimator.preblock.block.1.to_qkv") for k in sd)


class _Traits:
    """Five trait inputs of varied lengths, named by a filelist's first field."""

    def __init__(self, n=5):
        self.entries = [[f"DUMMY/wavs/utt{i:03d}.wav", "-"] for i in range(n)]

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        r = np.random.default_rng(i)
        return {"x": r.integers(-1, 2, size=(6 + 3 * i, 25)).astype(np.float32)}


def test_batched_inference_matches_jax(tmp_path):
    """`run_acoustic_inference_batched` (masked statistics turned on, B=3 and
    a ragged B=2 batch) against the JAX package's, temperature 1e6: the
    same file names and shapes, the input map equal, the rest within 2e-4;
    each batched artifact also matches per-sentence synthesis."""
    jm, jv, pm = _models()
    jexp = ExperimentConfig("tiny_b", jm.config, DataConfig(dataset="phnm_artic"),
                            TrainConfig())
    pexp = pconfig.ExperimentConfig("tiny_b", pm.config)
    kw = dict(batch_size=3, n_timesteps=2, temperature=1e6)
    jp = jpipe.run_acoustic_inference_batched(jexp, jv, _Traits(), str(tmp_path / "j"), **kw)
    pp = ppipe.run_acoustic_inference_batched(pexp, pm, _Traits(), str(tmp_path / "p"),
                                              device="cpu", **kw)
    name = lambda p: p.rsplit("/", 1)[1]  # noqa: E731
    assert [name(p) for p in pp] == [name(p) for p in jp]
    assert sorted(map(name, pp)) == [f"utt{i:03d}.npy" for i in range(5)]
    single = ppipe.run_acoustic_inference(pexp, ppipe.with_masked_norm(pm), _Traits(),
                                          str(tmp_path / "s"), n_timesteps=2,
                                          temperature=1e6, device="cpu")
    assert not pm.config.decoder.masked_norm  # the twin shares the weights, not the config
    for a_fp, b_fp in zip(pp, jp):
        a, b = np.load(a_fp), np.load(b_fp)
        assert a.shape == b.shape and a.shape[0] == 29 and np.isfinite(a).all()
        np.testing.assert_array_equal(a[28], b[28])
        _close(a[:28], b[:28])
        s = np.load(str(tmp_path / "s" / name(a_fp)))
        assert s.shape == a.shape
        _close(a, s)


def _mel_vocoder_pair(weight_norm=False):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(8)
        pv = ph.HiFiGANGenerator(upsample_initial_channel=32).eval()
    jv = jh.HiFiGANGenerator(upsample_initial_channel=32)
    return pv, jv, {"params": convert_hifigan_generator(pv.state_dict())}


def _mel_artifacts(tmp_path, lengths=(40, 700)):
    r = np.random.default_rng(4)
    paths = []
    tmp_path.mkdir(parents=True, exist_ok=True)
    for i, T in enumerate(lengths):
        arr = np.concatenate([r.standard_normal((160, T)) - 4, r.integers(0, 9, (1, T))])
        paths.append(str(tmp_path / f"utt{i:03d}.npy"))
        np.save(paths[-1], arr.astype(np.float32))
    return paths


def test_mel_vocoder_matches_jax(tmp_path):
    """`run_mel_vocoder` (HiFi-GAN fast path through `vocode_chunked`, a
    one-window and a multi-window track) against the JAX package's."""
    pv, jvoc, vv = _mel_vocoder_pair()
    arts = _mel_artifacts(tmp_path / "art")
    jw = jpipe.run_mel_vocoder(jvoc, vv, arts, str(tmp_path / "jw"))
    pw = ppipe.run_mel_vocoder(pv, arts, str(tmp_path / "pw"), device="cpu")
    assert [p.rsplit("/", 1)[1] for p in pw] == ["utt000.wav", "utt001.wav"]
    for a, b, T in zip(pw, jw, (40, 700)):
        (wa, sa), (wb, sb) = load_wav(a), load_wav(b)
        assert sa == sb == 22050 and wa.shape == wb.shape == (T * 256,)
        np.testing.assert_allclose(wa, wb, atol=TOL_VOC, rtol=0)


def _weight_norm(sd):
    """A plain state dict in the reference's weight-norm form (conv weights
    as `weight_g` (out, 1, 1) and `weight_v`)."""
    out = {}
    for k, v in sd.items():
        if k.endswith(".weight") and v.dim() == 3:
            g = v.pow(2).sum(dim=(1, 2), keepdim=True).sqrt() * 1.5
            out[k[:-6] + "weight_g"], out[k[:-6] + "weight_v"] = g, v / 1.5
        else:
            out[k] = v
    return out


@pytest.fixture
def tiny_preset():
    """A v1-shaped preset at test widths, registered under its name."""
    cfg = pconfig.ExperimentConfig(
        "tiny_cli_v1", _pcfg(_jcfg()), pconfig.DataConfig(dataset="phnm_artic"))
    pconfig.register_preset(cfg)
    yield cfg
    del pconfig.PRESETS[cfg.name]


def test_clis_end_to_end_on_cpu(tiny_preset, tmp_path, monkeypatch):
    """`cli.synthesize` (per sentence with --use-align, and batched) and
    `cli.vocode` (both modes) with `--device cpu` on a tiny registered
    preset: a phnm3 filelist in, wavs out. The vocoders load the
    reference's checkpoint layouts (weight-norm pairs folded) and agree
    with the JAX package's runners on the same checkpoints."""
    root = tmp_path / "data"
    (root / "phnm3").mkdir(parents=True)
    (root / "encoded_audio_en" / "emasrc").mkdir(parents=True)
    r = np.random.default_rng(2)
    lines = []
    for i in range(3):
        n = 4 + i
        bounds = np.concatenate([[0.0], np.cumsum(r.uniform(0.06, 0.16, n))])
        phones = list(r.choice(["h", "ə", "l", "oʊ", "t", "s", "aɪ", "n"], n))
        np.save(root / "phnm3" / f"utt{i:03d}_phnm3.npy", build_phnm3(phones, bounds))
        np.save(root / "encoded_audio_en" / "emasrc" / f"utt{i:03d}.npy",
                r.standard_normal((int(bounds[-1] * 50) + 1, 14)).astype(np.float32))
        lines.append(f"DUMMY/wavs/utt{i:03d}.wav|DUMMY/phnm3/utt{i:03d}_phnm3.npy")
    (root / "test.txt").write_text("\n".join(lines))
    _, _, pm = _models()
    ckpt = save_checkpoint(str(tmp_path / "ckpt"), "grad_best", pm.state_dict())
    common = ["--preset", tiny_preset.name, "--ckpt", ckpt, "--filelist",
              str(root / "test.txt"), "--data-root", str(root), "--n-timesteps", "2",
              "--device", "cpu"]
    # (DPM at 2 steps is no leg here: on this random tiny model one of its
    # data predictions reaches |x| ~ 700 and the U-Net gives NaN there, in
    # the JAX package too; the solvers are held against JAX above)
    arts = psynth.main(common + ["--save-dir", str(tmp_path / "art"), "--use-align"])
    batched = psynth.main(common + ["--save-dir", str(tmp_path / "art_b"), "--batch-size",
                                    "2", "--solver", "heun", "--temperature", "1e6"])
    assert sorted(a.rsplit("/", 1)[1] for a in arts) == [f"utt{i:03d}.npy" for i in range(3)]
    assert sorted(a.rsplit("/", 1)[1] for a in batched) == sorted(
        a.rsplit("/", 1)[1] for a in arts)
    for a in arts:
        arr = np.load(a)
        assert arr.shape[0] == 29 and arr.shape[1] > 0 and np.isfinite(arr).all()

    # sparc mode: a SPARC checkpoint {config, state_dict: {spk_ft, generator}}
    sparc_kw = dict(spk_emb_size=8, channels=32)
    monkeypatch.setattr(ph, "SpkSparcHiFiGANGenerator",
                        functools.partial(ph.SpkSparcHiFiGANGenerator, **sparc_kw))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(6)
        sparc = ph.SpkSparcHiFiGANGenerator().eval()
    parts = {"spk_ft": {}, "generator": {}}
    for k, v in sparc.state_dict().items():
        head, rest = k.split(".", 1)
        parts[head][rest] = v
    parts["generator"] = _weight_norm(parts["generator"])
    torch.save({"config": {"sr": 16000}, "state_dict": parts}, tmp_path / "sparc.ckpt")
    np.save(tmp_path / "spk.npy", r.standard_normal(1024).astype(np.float32))
    vargs = ["--pred-dir", str(tmp_path / "art"), "--device", "cpu"]
    wavs = pvocode.main(["--mode", "sparc", "--torch-ckpt", str(tmp_path / "sparc.ckpt"),
                         "--spk-ft", str(tmp_path / "spk.npy"), "--pitch-stats", "140", "30",
                         "--save-dir", str(tmp_path / "wav_s")] + vargs)
    jvoc = jh.SpkSparcHiFiGANGenerator(
        spk_ft_size=1024, spk_emb_size=8,
        generator=jh.SparcHiFiGANGenerator(channels=32, spk_emb_size=8))
    jw = jpipe.run_sparc_vocoder(
        jvoc, {"params": convert_spk_sparc(torch.load(tmp_path / "sparc.ckpt"))},
        sorted(arts), np.load(tmp_path / "spk.npy"), str(tmp_path / "jw_s"),
        pitch_stats=(140.0, 30.0))
    assert len(wavs) == 3
    for a, b in zip(wavs, jw):
        (wa, sa), (wb, sb) = load_wav(a), load_wav(b)
        assert sa == sb == 16000 and wa.shape == wb.shape
        np.testing.assert_allclose(wa, wb, atol=TOL_VOC, rtol=0)

    # mel mode: a hifigan.pt {"generator": ...} in weight-norm form
    pv, jmel, _ = _mel_vocoder_pair()
    monkeypatch.setattr(ph, "HiFiGANGenerator",
                        functools.partial(ph.HiFiGANGenerator, upsample_initial_channel=32))
    torch.save({"generator": _weight_norm(pv.state_dict())}, tmp_path / "hifigan.pt")
    mel_arts = _mel_artifacts(tmp_path / "mel_art", lengths=(30,))
    (mw,) = pvocode.main(["--mode", "mel", "--torch-ckpt", str(tmp_path / "hifigan.pt"),
                          "--pred-dir", str(tmp_path / "mel_art"), "--save-dir",
                          str(tmp_path / "wav_m"), "--device", "cpu"])
    (jmw,) = jpipe.run_mel_vocoder(
        jmel, {"params": convert_hifigan_generator(
            torch.load(tmp_path / "hifigan.pt")["generator"])}, mel_arts,
        str(tmp_path / "jw_m"))
    (wa, sa), (wb, sb) = load_wav(mw), load_wav(jmw)
    assert sa == sb == 22050 and wa.shape == wb.shape == (30 * 256,)
    np.testing.assert_allclose(wa, wb, atol=TOL_VOC, rtol=0)


def test_cli_parsers_mirror_jax():
    """The port's parsers (synthesize, vocode, score, pipeline, encode_audio,
    demo) take the JAX parsers' flags, plus `--device`."""
    import arttts_tpu.cli.synthesize as jsynth_cli
    import arttts_tpu.cli.vocode as jvocode_cli

    def flags(mod):
        seen = []
        real = argparse.ArgumentParser.parse_args

        def grab(self, argv=None, ns=None):
            seen.extend(a.option_strings[-1] for a in self._actions if a.option_strings)
            raise SystemExit(0)

        argparse.ArgumentParser.parse_args = grab
        try:
            with pytest.raises(SystemExit):
                mod.main([])
        finally:
            argparse.ArgumentParser.parse_args = real
        return set(seen)

    import arttts_tpu.cli.demo as jdemo
    import arttts_tpu.cli.encode_audio as jencode
    import arttts_tpu.cli.pipeline as jpipeline
    import arttts_tpu.cli.score as jscore
    from arttts_tpu_torch.cli import demo, encode_audio, pipeline, score

    for p, j in ((psynth, jsynth_cli), (pvocode, jvocode_cli), (score, jscore),
                 (pipeline, jpipeline), (encode_audio, jencode), (demo, jdemo)):
        assert flags(p) == flags(j) | {"--device"}, p.__name__
