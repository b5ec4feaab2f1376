"""Parity of the port's SPARC encoder stack with the JAX package's, on the
CPU: WavLM in both variants (`models/wavlm.py`), the HF loader
(`utils/reference_weights.py:load_hf_wavlm`) and the bridge
(`utils/from_jax.py`), YIN and loudness (`audio/pitch.py`), `SparcEncoder`,
`reencode_wavs` and `cli.encode_audio --native` with `--device cpu`, and the
full-width UTMOS and SparcEncoder's structure on the meta device.

Models are seeded on the port's side and carried to JAX by the JAX
package's converter. The configs are the JAX tests' own (two-layer WavLMs of
both variants after `tests/test_wavlm.py`, `tests/test_sparc_encoder.py:
SMALL`). Tolerances: WavLM, EMA columns, speaker means and loudness atol
1e-4; f0 within 0.01 Hz on the frames voiced on both sides, with the same
voiced mask on clean signals (tones, harmonics, a glide, silence); on noisy
input the share of frames whose voicing differs is measured and bounded
(NOISY_FLIP_SHARE).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arttts_tpu.audio import pitch as jpitch
from arttts_tpu.eval.quanti import reencode_wavs as j_reencode
from arttts_tpu.models import sparc_encoder as jsparc
from arttts_tpu.models.wavlm import WavLMEncoder as JWavLM
from arttts_tpu.utils.torch_convert_wavlm import convert_wavlm
from arttts_tpu_torch.audio import pitch as ppitch
from arttts_tpu_torch.audio.io import save_wav
from arttts_tpu_torch.models import sparc_encoder as psparc
from arttts_tpu_torch.models.wavlm import WavLMConfig, WavLMEncoder, relative_position_buckets
from arttts_tpu_torch.utils import from_jax
from arttts_tpu_torch.utils.reference_weights import load_hf_wavlm
from tests.test_sparc_encoder import SMALL as JSPARC_SMALL
from tests.test_wavlm import SMALL_BASE_STYLE, SMALL_LARGE_STYLE, _hf_config

TOL = 1e-4
TOL_F0_HZ = 0.01
# measured 0.0 on the signals below (noise sigma 0.11 and 0.3 on a harmonic
# tone, white noise); a flip needs a frame's CMND minimum within float32
# rounding of the threshold
NOISY_FLIP_SHARE = 0.02
SR = 16000

# two-layer WavLMs of both variants, the JAX tests' widths
LARGE2, BASE2 = (dataclasses.replace(c, num_layers=2) for c in (SMALL_LARGE_STYLE,
                                                                 SMALL_BASE_STYLE))


def _port_cfg(j):
    d = dataclasses.asdict(j)
    if "wavlm" in d:
        return psparc.SparcEncoderConfig(wavlm=_port_cfg(j.wavlm), tap_layer=j.tap_layer,
                                         n_ema=j.n_ema, pitch=ppitch.PitchConfig(**d["pitch"]))
    return WavLMConfig(**d)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs (see tests/test_torch_cli.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _wavlm_pair(jcfg):
    """(port WavLM, JAX params, jitted JAX apply) with the same weights."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        pm = WavLMEncoder(_port_cfg(jcfg)).eval()
    params = convert_wavlm(pm.state_dict(), jcfg)
    return pm, params, jax.jit(JWavLM(jcfg).apply, static_argnames=("tap_layer",))


def _fwd(pm, wav, **kw):
    with torch.no_grad():
        return pm(torch.from_numpy(wav), **{k: torch.from_numpy(v) if isinstance(v, np.ndarray)
                                            else v for k, v in kw.items()}).numpy()


@pytest.mark.parametrize("jcfg", [LARGE2, BASE2], ids=["large_style", "base_style"])
def test_wavlm_matches_jax(jcfg, rng):
    """Full stack, each tap, and a padded batch (masked frames) on both
    sides, and for the Large style (per-frame conv norms) against the same
    clips unpadded; the bridge inverts the converter."""
    pm, params, japply = _wavlm_pair(jcfg)
    back = from_jax.wavlm_state_dict(params, _port_cfg(jcfg))
    assert sorted(back) == sorted(pm.state_dict())
    for k, v in pm.state_dict().items():
        assert torch.equal(back[k], v), k
    wav = rng.standard_normal((2, 800)).astype(np.float32)
    v = {"params": params}
    # Base has no final LayerNorm, so its tap 2 is its full stack
    for tap in (None, 1, 2) if jcfg.stable_layer_norm else (None, 1):
        got = _fwd(pm, wav, tap_layer=tap)
        want = np.asarray(japply(v, jnp.asarray(wav), tap_layer=tap))
        assert got.shape == want.shape == (2, pm.num_frames(800), jcfg.hidden_dim)
        np.testing.assert_allclose(got, want, atol=TOL)
    pad = np.concatenate([wav, np.zeros((2, 400), np.float32)], axis=1)
    n_a = pm.num_frames(800)
    mask = (np.arange(pm.num_frames(1200)) < n_a).astype(np.float32)[None].repeat(2, 0)
    padded = _fwd(pm, pad, frame_mask=mask)
    if jcfg.conv_norm == "layer":  # Base's GroupNorm takes its statistics over time
        np.testing.assert_allclose(padded[:, :n_a], _fwd(pm, wav), atol=TOL)
    want = np.asarray(japply(v, jnp.asarray(pad), frame_mask=jnp.asarray(mask)))
    np.testing.assert_allclose(padded, want, atol=TOL)


def test_relative_position_buckets_are_the_jax_ones():
    from arttts_tpu.models.wavlm import relative_position_buckets as jbuckets

    for T in (1, 7, 250, 801):
        np.testing.assert_array_equal(relative_position_buckets(T, 320, 800),
                                      jbuckets(T, 320, 800))


@pytest.mark.parametrize("form", ["bare", "prefixed_weight_g"])
def test_hf_loader_matches_convert_wavlm(form, rng, monkeypatch):
    """A `transformers.WavLMModel` state dict, as it is (torch's
    parametrized weight norm) or under `wavlm.` with `weight_g`/`weight_v`:
    the port's loader and the JAX converter give the same outputs (and both
    HF's own)."""
    monkeypatch.setenv("USE_TF", "0")  # a first import of transformers skips TensorFlow
    from transformers import WavLMModel

    torch.manual_seed(0)
    hf = WavLMModel(_hf_config(LARGE2)).eval()
    sd = hf.state_dict()
    if form == "prefixed_weight_g":
        pre = "encoder.pos_conv_embed.conv."
        g, v = sd.pop(pre + "parametrizations.weight.original0"), sd.pop(
            pre + "parametrizations.weight.original1")
        sd[pre + "weight_g"], sd[pre + "weight_v"] = g, v
        sd = {f"wavlm.{k}": t for k, t in sd.items()}
    else:
        assert any("parametrizations.weight.original0" in k for k in sd)
    with torch.device("meta"):
        pm = WavLMEncoder(_port_cfg(LARGE2))
    load_hf_wavlm(pm, sd)
    pm.eval()
    wav = rng.standard_normal((1, 800)).astype(np.float32)
    want = np.asarray(JWavLM(LARGE2).apply({"params": convert_wavlm(sd, LARGE2)},
                                           jnp.asarray(wav)))
    np.testing.assert_allclose(_fwd(pm, wav), want, atol=TOL)
    with torch.no_grad():
        hf_out = hf(torch.from_numpy(wav)).last_hidden_state.numpy()
    np.testing.assert_allclose(_fwd(pm, wav), hf_out, atol=TOL)
    sd.pop(next(k for k in sd if k.endswith("gru_rel_pos_const")))
    with pytest.raises(KeyError, match="lacks 1 keys"):
        load_hf_wavlm(WavLMEncoder(_port_cfg(LARGE2)), sd)


def _tone(freq, seconds=1.5, amp=1.0):
    t = np.arange(int(SR * seconds)) / SR
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def _harmonic(f0_of_t, seconds=1.5, partials=((1, 1.0), (2, 0.5), (3, 0.25)), noise=0.0,
              seed=0):
    t = np.arange(int(SR * seconds)) / SR
    phase = 2 * np.pi * np.cumsum(f0_of_t(t)) / SR
    wav = sum(a * np.sin(k * phase) for k, a in partials)
    if noise:
        wav = wav + noise * np.random.default_rng(seed).standard_normal(len(t))
    return wav.astype(np.float32)


_jtrack = jax.jit(jpitch.track_pitch, static_argnames=("config",))


def _pitch_both(wavs):
    f0_p, v_p = (a.numpy() for a in ppitch.track_pitch(torch.from_numpy(wavs)))
    f0_j, v_j = (np.asarray(a) for a in _jtrack(jnp.asarray(wavs)))
    return f0_p, v_p, f0_j, v_j


def _f0_close(f0_p, v_p, f0_j, v_j):
    both = v_p & v_j
    assert both.any()
    np.testing.assert_allclose(f0_p[both], f0_j[both], atol=TOL_F0_HZ, rtol=0)
    np.testing.assert_array_equal(f0_p[~v_p], 0.0)


def test_yin_and_loudness_match_jax():
    """Tones (82.5-441 Hz), a harmonic complex, a 100 -> 250 Hz glide and
    silence: the same voiced masks, f0 within 0.01 Hz; loudness atol 1e-4
    dB."""
    clean = np.stack([_tone(f) for f in (82.5, 110.0, 220.0, 441.0)]
                     + [_harmonic(lambda t: np.full_like(t, 150.0)),
                        _harmonic(lambda t: 100.0 + 150.0 * t / 1.5),
                        np.zeros(int(SR * 1.5), np.float32)])
    f0_p, v_p, f0_j, v_j = _pitch_both(clean)
    assert f0_p.shape == (7, ppitch.PitchConfig().num_frames(clean.shape[1]))
    np.testing.assert_array_equal(v_p, v_j)
    assert v_p[:6, 5:-5].all() and not v_p[6].any()
    _f0_close(f0_p, v_p, f0_j, v_j)
    loud_p = ppitch.frame_loudness(torch.from_numpy(clean)).numpy()
    loud_j = np.asarray(jpitch.frame_loudness(jnp.asarray(clean)))
    np.testing.assert_allclose(loud_p, loud_j, atol=TOL)


def test_yin_noisy_voicing_share_is_bounded():
    noisy = np.stack([_harmonic(lambda t: np.full_like(t, 160.0), noise=0.11),
                      _harmonic(lambda t: np.full_like(t, 120.0), noise=0.3, seed=1),
                      np.random.default_rng(2).standard_normal(int(SR * 1.5)).astype(
                          np.float32)])
    f0_p, v_p, f0_j, v_j = _pitch_both(noisy)
    flipped = float((v_p != v_j).mean())
    print(f"\nYIN voicing decisions differing on noisy input: {flipped:.4f}")
    assert flipped <= NOISY_FLIP_SHARE
    _f0_close(f0_p, v_p, f0_j, v_j)


@functools.lru_cache(maxsize=None)
def _sparc_pair():
    """(port SparcEncoder at SMALL, JAX encoder, JAX variables, jitted apply)."""
    cfg = _port_cfg(JSPARC_SMALL)
    pm = psparc.build_encoder(config=cfg, generator=torch.Generator().manual_seed(5),
                              device="cpu")
    sd = pm.state_dict()
    params = {"wavlm": convert_wavlm({k[len("wavlm."):]: v for k, v in sd.items()
                                      if k.startswith("wavlm.")}, JSPARC_SMALL.wavlm),
              "ema_probe": {"kernel": sd["ema_probe.weight"].numpy().T,
                            "bias": sd["ema_probe.bias"].numpy()}}
    jenc = jsparc.SparcEncoder(JSPARC_SMALL)
    return pm, jenc, {"params": params}, jax.jit(jenc.apply)


def _sparc_close(got, want):
    (feats, spk), (jfeats, jspk) = got, [np.asarray(a) for a in want]
    assert feats.shape == jfeats.shape and spk.shape == jspk.shape
    np.testing.assert_allclose(feats[..., :12], jfeats[..., :12], atol=TOL)
    np.testing.assert_allclose(feats[..., 13], jfeats[..., 13], atol=TOL)
    _f0_close(feats[..., 12], feats[..., 12] > 0, jfeats[..., 12], jfeats[..., 12] > 0)
    np.testing.assert_array_equal(feats[..., 12] > 0, jfeats[..., 12] > 0)
    np.testing.assert_allclose(spk, jspk, atol=TOL)


def test_sparc_encoder_matches_jax(rng):
    """EMA columns, f0, loudness and the speaker mean, without and with a
    frame mask (one clip padded in a batch of two); the bridge inverts."""
    pm, jenc, jv, japply = _sparc_pair()
    params = psparc.build_encoder_params(config=pm.config,
                                         generator=torch.Generator().manual_seed(5))
    assert all(torch.equal(params[k], v) for k, v in pm.state_dict().items())
    back = from_jax.sparc_encoder_state_dict(jv["params"], pm.config)
    assert sorted(back) == sorted(pm.state_dict())
    for k, v in pm.state_dict().items():
        assert torch.equal(back[k], v), k
    t = np.arange(16000) / SR
    tone = 0.5 * np.sin(2 * np.pi * 220.0 * t) + 0.05 * rng.standard_normal(16000)
    wav = np.stack([tone, 0.3 * rng.standard_normal(16000)]).astype(np.float32)
    with torch.no_grad():
        got = [a.numpy() for a in pm(torch.from_numpy(wav))]
    _sparc_close(got, japply(jv, jnp.asarray(wav)))
    assert got[0].shape == (2, pm.num_frames(16000), 14)
    wav[1, 9000:] = 0.0
    mask = (np.arange(pm.num_frames(16000)) < pm.num_frames(9000)).astype(np.float32)
    mask = np.stack([np.ones_like(mask), mask])
    with torch.no_grad():
        got = [a.numpy() for a in pm(torch.from_numpy(wav), torch.from_numpy(mask))]
    _sparc_close(got, japply(jv, jnp.asarray(wav), frame_mask=jnp.asarray(mask)))
    assert not got[0][1, pm.num_frames(9000):].any()


def _wavs(root, rng):
    root.mkdir(parents=True)
    for name, sec, sr in (("a", 1.0, 16000), ("b", 2.6, 22050)):
        n = int(sec * sr)
        t = np.arange(n) / sr
        save_wav(root / f"{name}.wav", 0.4 * np.sin(2 * np.pi * 180 * t)
                 + 0.05 * rng.standard_normal(n), sr)
    return root


def test_reencode_wavs_and_encode_audio_cli_on_cpu(tmp_path, rng, monkeypatch):
    """`reencode_wavs` against the JAX function on the same files (2 s
    buckets, masked frames), and `cli.encode_audio --native` on a filelist
    with a saved backbone and probe: its emasrc / spk_preemb files equal the
    same encoder's output; sharding from SLURM_ARRAY_*, --dry-run, and the
    external-coder branch's exit without the `sparc` package."""
    from arttts_tpu_torch.cli import encode_audio
    from arttts_tpu_torch.eval.quanti import reencode_wavs

    pm, _, jv, _ = _sparc_pair()
    wav_dir = _wavs(tmp_path / "wavs", rng)
    assert reencode_wavs(str(wav_dir), str(tmp_path / "p"), pm, device="cpu") == 2
    assert j_reencode(str(wav_dir), str(tmp_path / "j"), jv, JSPARC_SMALL) == 2
    for name in ("a", "b"):
        got, want = np.load(tmp_path / "p" / f"{name}.npy"), np.load(tmp_path / "j" / f"{name}.npy")
        assert got.shape == want.shape and got.shape[1] == 14
        np.testing.assert_allclose(got[:, :12], want[:, :12], atol=TOL)
        np.testing.assert_allclose(got[:, 13], want[:, 13], atol=TOL)
        _f0_close(got[:, 12], got[:, 12] > 0, want[:, 12], want[:, 12] > 0)

    monkeypatch.setattr(psparc, "SparcEncoderConfig", lambda: pm.config)
    sd = pm.state_dict()
    torch.save({k[len("wavlm."):]: v for k, v in sd.items() if k.startswith("wavlm.")},
               tmp_path / "wavlm.pt")
    np.savez(tmp_path / "probe.npz", weight=sd["ema_probe.weight"].numpy(),
             bias=sd["ema_probe.bias"].numpy())
    (tmp_path / "list.txt").write_text(
        "\n".join(f"{wav_dir}/{n}.wav|text" for n in ("a", "b")))
    common = ["--manifest", str(tmp_path / "list.txt"), "--save-dir", str(tmp_path / "enc")]
    monkeypatch.setenv("SLURM_ARRAY_TASK_ID", "1")
    monkeypatch.setenv("SLURM_ARRAY_TASK_COUNT", "2")
    encode_audio.main(common + ["--native", "--wavlm-ckpt", str(tmp_path / "wavlm.pt"),
                                "--probe", str(tmp_path / "probe.npz"), "--device", "cpu"])
    assert sorted(p.name for p in (tmp_path / "enc" / "emasrc").iterdir()) == ["b.npy"]
    encode_audio.main(common + ["--native", "--wavlm-ckpt", str(tmp_path / "wavlm.pt"),
                                "--probe", str(tmp_path / "probe.npz"), "--device", "cpu",
                                "--shard-id", "0"])
    from arttts_tpu_torch.audio.io import load_wav
    from arttts_tpu_torch.eval.quanti import encode_padded

    for name in ("a", "b"):
        wav, _ = load_wav(wav_dir / f"{name}.wav", target_sr=16000)
        feats, spk = encode_padded(pm, wav, torch.device("cpu"))
        np.testing.assert_array_equal(np.load(tmp_path / "enc" / "emasrc" / f"{name}.npy"),
                                      feats)
        np.testing.assert_array_equal(np.load(tmp_path / "enc" / "spk_preemb" / f"{name}.npy"),
                                      spk)
    encode_audio.main(common[:2] + ["--save-dir", str(tmp_path / "dry"), "--dry-run"])
    assert not list((tmp_path / "dry" / "emasrc").iterdir())
    with pytest.raises(SystemExit, match="sparc"):
        encode_audio.main(common[:2] + ["--save-dir", str(tmp_path / "ext")])


def test_entries_need_the_card_by_default(monkeypatch, tmp_path):
    """The new entry points take the card unless asked for the CPU, and
    raise where there is none."""
    from arttts_tpu_torch.cli import demo, encode_audio, pipeline, score
    from arttts_tpu_torch.eval.utmos_scorer import UTMOSScorer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        UTMOSScorer(model=torch.nn.Linear(1, 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        psparc.build_encoder(config=_port_cfg(JSPARC_SMALL))
    (tmp_path / "l.txt").write_text("w.wav|t")
    for main, argv in ((score.main, ["--ckpt", "u.ckpt", "--wav-dir", ".", "--out-csv", "s"]),
                       (pipeline.main, ["--ckpt", "c", "--filelist", "f", "--workdir", "w"]),
                       (demo.main, []),
                       (encode_audio.main, ["--manifest", str(tmp_path / "l.txt"),
                                            "--save-dir", str(tmp_path / "e"), "--native"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
    assert not list((tmp_path / "e" / "emasrc").iterdir())


def _shapes(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.broadcast_to(np.zeros((), np.float32), v.shape)
    return out


def _unflatten(flat):
    tree = {}
    for k, v in flat.items():
        *head, last = k.split("/")
        node = tree
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return tree


@pytest.mark.parametrize("model", ["utmos", "sparc_encoder"])
def test_full_width_structure_on_meta(model, monkeypatch):
    """The port's full-width UTMOS (wav2vec2-base, 3,000 judges) and
    SparcEncoder (WavLM-Large, tap 9) built on the meta device: the bridge of
    `jax.eval_shape` of the JAX init gives their state-dict names and shapes
    (the tapped JAX init holds layers 0-8 only: the port's other keys are
    layers >= 9 and the final LayerNorm)."""
    from arttts_tpu.models.utmos import UTMOSPredictor as JUTMOS
    from arttts_tpu_torch.models.utmos import UTMOSPredictor

    monkeypatch.setattr(from_jax, "_t", lambda a: torch.empty(np.shape(a), device="meta"))
    if model == "utmos":
        jm, args = JUTMOS(), (jnp.zeros((1, 16000)), jnp.zeros((1,), jnp.int32),
                              jnp.zeros((1,), jnp.int32))
        with torch.device("meta"):
            pm = UTMOSPredictor()
        to_sd = from_jax.utmos_state_dict
    else:
        jm, args = jsparc.SparcEncoder(), (jnp.zeros((1, 16000)),)
        with torch.device("meta"):
            pm = psparc.SparcEncoder()
        to_sd = functools.partial(from_jax.sparc_encoder_state_dict, config=pm.config)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args))["params"]
    got = to_sd(_unflatten(_shapes(shapes)))
    want = {k: tuple(v.shape) for k, v in pm.state_dict().items()}
    assert set(got) <= set(want)
    extra = set(want) - set(got)
    if model == "utmos":
        assert not extra
    else:
        assert len(pm.wavlm.encoder.layers) == 24 and pm.config.tap_layer == 9
        assert all(k == "wavlm.encoder.layer_norm.weight" or k == "wavlm.encoder.layer_norm.bias"
                   or int(k.split(".")[3]) >= 9 for k in extra), sorted(extra)[:4]
    for k, v in got.items():
        assert tuple(v.shape) == want[k], k
    n = sum(int(np.prod(s)) for s in want.values())
    assert n > (90e6 if model == "utmos" else 300e6), n
