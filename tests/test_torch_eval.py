"""Parity of the port's evaluation stage with the JAX package's, on the CPU:
the BiLSTM, wav2vec2 and UTMOS (`models/{lstm,wav2vec2,utmos}.py`), the
lightning loader (`utils/reference_weights.py`) and the bridge
(`utils/from_jax.py`), `score_directory`, `quanti_mel` / `quanti_art`,
and the `score`, `pipeline` and `demo` CLIs end to end with `--device cpu`.

Models are seeded on the port's side and carried to JAX by the JAX
package's own converters; the bridge must invert them. The configs are the
JAX tests' own (`tests/test_utmos.py:SMALL`). Tolerances: the BiLSTM atol
2e-5; wav2vec2 and UTMOS's per-frame output and score atol 1e-4; scored
directories and quanti CSVs 1e-5.
"""

import csv
import dataclasses
import functools
import http.client
import io
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arttts_tpu.eval import quanti as jquanti
from arttts_tpu.eval.utmos_scorer import UTMOSScorer as JScorer
from arttts_tpu.models.lstm import BiLSTM as JBiLSTM
from arttts_tpu.models.utmos import UTMOSPredictor as JUTMOS
from arttts_tpu.models.wav2vec2 import Wav2Vec2Encoder as JW2V
from arttts_tpu.utils.torch_convert_utmos import convert_utmos, convert_wav2vec2
from arttts_tpu_torch.audio.io import load_wav, save_wav
from arttts_tpu_torch.core import config as pconfig
from arttts_tpu_torch.core.checkpoint import save_checkpoint
from arttts_tpu_torch.eval import quanti as pquanti
from arttts_tpu_torch.eval import utmos_scorer as pscorer
from arttts_tpu_torch.models import hifigan as ph
from arttts_tpu_torch.models.lstm import BiLSTM
from arttts_tpu_torch.models.utmos import UTMOSPredictor, build_utmos
from arttts_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Encoder
from arttts_tpu_torch.utils.from_jax import utmos_state_dict, wav2vec2_state_dict
from tests.test_utmos import SMALL as JSMALL

SMALL = Wav2Vec2Config(**dataclasses.asdict(JSMALL))
SMALL_HEAD = dict(lstm_hidden=16, projection_hidden=32)
TOL = 1e-4
TOL_CSV = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs (the suite's six workers
    share the cores; see tests/test_torch_cli.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _utmos_pair():
    """(port UTMOS at SMALL, JAX module, JAX variables, jitted JAX score)."""
    pm = build_utmos(device="cpu", seed=4, ssl_config=SMALL, **SMALL_HEAD)
    jm = JUTMOS(ssl_config=JSMALL, **SMALL_HEAD)
    jv = {"params": convert_utmos(pm.state_dict(), num_layers=SMALL.num_layers,
                                  num_heads=SMALL.num_heads)}
    return pm, jm, jv, jax.jit(jm.score)


@functools.lru_cache(maxsize=None)
def _jax_scorer():
    """One JAX scorer for the file: its jit cache is per instance."""
    _, jm, jv, _ = _utmos_pair()
    return JScorer(jm, jv)


def _weight_norm(sd, key):
    """`key`'s weight in fairseq's weight-norm form (dim=2: g (1, 1, k))."""
    out = dict(sd)
    w = out.pop(f"{key}.weight")
    g = w.pow(2).sum(dim=(0, 1), keepdim=True).sqrt()
    out[f"{key}.weight_g"], out[f"{key}.weight_v"] = g, w * 1.5  # folds back to w
    return out


def test_bilstm_matches_jax(rng):
    I, H, B, T = 12, 8, 3, 9
    x = rng.standard_normal((B, T, I)).astype(np.float32)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        lstm = BiLSTM(I, H)
    sd = {k: v.numpy() for k, v in lstm.state_dict().items()}
    want = JBiLSTM(input_size=I, hidden_size=H).apply({"params": sd}, jnp.asarray(x))
    with torch.no_grad():
        got = lstm(torch.from_numpy(x))
    assert got.shape == (B, T, 2 * H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_wav2vec2_matches_jax_and_bridge_inverts(rng):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        pm = Wav2Vec2Encoder(SMALL).eval()
    params = convert_wav2vec2(pm.state_dict(), SMALL.num_layers, SMALL.num_heads, "fairseq")
    back = wav2vec2_state_dict(params)
    ref = pm.state_dict()
    assert sorted(back) == sorted(ref)
    for k, v in ref.items():
        assert back[k].shape == v.shape and torch.equal(back[k], v), k
    wav = rng.standard_normal((2, 800)).astype(np.float32) * 0.1
    want = np.asarray(jax.jit(JW2V(JSMALL).apply)({"params": params}, jnp.asarray(wav)))
    with torch.no_grad():
        got = pm(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (2, pm.num_frames(800), SMALL.hidden_dim)
    np.testing.assert_allclose(got, want, atol=TOL)


def test_utmos_frames_and_score_match_jax(rng):
    pm, jm, jv, jscore = _utmos_pair()
    wav = rng.standard_normal((2, 1600)).astype(np.float32) * 0.1
    dom, judge = np.array([0, 2]), np.array([288, 7])
    want = jax.jit(jm.apply)(jv, jnp.asarray(wav), jnp.asarray(dom), jnp.asarray(judge))
    with torch.no_grad():
        got = pm(torch.from_numpy(wav), torch.from_numpy(dom), torch.from_numpy(judge))
        score = pm.score(torch.from_numpy(wav))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    np.testing.assert_allclose(score.numpy(), np.asarray(jscore(jv, jnp.asarray(wav))),
                               atol=TOL)
    back = utmos_state_dict(jv["params"])
    assert sorted(back) == sorted(pm.state_dict())
    for k, v in pm.state_dict().items():
        assert torch.equal(back[k], v), k
    pm.train()  # dropout 0.3 acts only in training mode
    with torch.no_grad():
        assert not torch.equal(pm.score(torch.from_numpy(wav)), score)
    pm.eval()


def test_lightning_loader_matches_jax_converter(tmp_path, rng):
    """A lightning file in the reference's form (pos_conv weight-normed over
    dim 2, keys the converter ignores) gives the port and JAX one score."""
    pm, jm, _, jscore = _utmos_pair()
    sd = _weight_norm(pm.state_dict(), "feature_extractors.0.ssl_model.encoder.pos_conv.0")
    sd["feature_extractors.0.ssl_model.mask_emb"] = torch.zeros(SMALL.hidden_dim)
    sd["feature_extractors.0.ssl_model.quantizer.vars"] = torch.zeros(1, 4, 8)
    torch.save({"state_dict": sd, "hyper_parameters": {"lr": 1e-4}}, tmp_path / "u.ckpt")
    small = functools.partial(UTMOSPredictor, ssl_config=SMALL, **SMALL_HEAD)
    scorer = pscorer.UTMOSScorer(small().eval(), device="cpu")
    from arttts_tpu_torch.utils.reference_weights import load_utmos_lightning

    load_utmos_lightning(scorer.model, torch.load(tmp_path / "u.ckpt", weights_only=False))
    jv = {"params": convert_utmos(sd, SMALL.num_layers, SMALL.num_heads)}
    wav = rng.standard_normal((3, 1600)).astype(np.float32) * 0.1
    np.testing.assert_allclose(scorer.score_batch(list(wav)),
                               np.asarray(jscore(jv, jnp.asarray(wav))), atol=TOL)
    del sd["output_layers.0.decoder_rnn.weight_hh_l0"]
    with pytest.raises(KeyError, match="lacks 1 keys"):
        load_utmos_lightning(small(), {"state_dict": sd})


def _wav_dir(root, rng):
    """Clips at 16 and 22.05 kHz over two sample buckets."""
    root.mkdir(parents=True, exist_ok=True)
    for i, (sec, sr) in enumerate([(0.3, 16000), (1.3, 22050), (0.5, 16000), (0.9, 22050)]):
        save_wav(root / f"c{i}.wav", rng.standard_normal(int(sr * sec)) * 0.1, sr)
    return root


def _csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _same_rows(a, b, tol=TOL_CSV):
    assert len(a) == len(b) and all(len(x) == len(y) for x, y in zip(a, b))
    for x, y in zip(a, b):
        assert x[0] == y[0]
        for u, v in zip(x[1:], y[1:]):
            assert u == v or abs(float(u) - float(v)) <= tol, (x, y)


def test_score_directory_matches_jax(tmp_path, rng):
    pm = _utmos_pair()[0]
    wav_dir = _wav_dir(tmp_path / "wavs", rng)
    assert pscorer.repeat_pad(np.arange(5, dtype=np.float32), 12).tolist() == \
        [0, 1, 2, 3, 4, 0, 1, 2, 3, 4, 0, 1]
    assert [pscorer._bucket(n) for n in (1, 16000, 16001, 400000)] == [16000, 16000, 32000,
                                                                      400000]
    got = pscorer.UTMOSScorer(pm, device="cpu").score_directory(
        str(wav_dir), str(tmp_path / "p.csv"), batch_size=2)
    want = _jax_scorer().score_directory(str(wav_dir), str(tmp_path / "j.csv"),
                                         batch_size=2)
    assert list(got) == list(want) and sorted(got) == [f"c{i}.wav" for i in range(4)]
    for k in want:
        assert abs(got[k] - want[k]) <= TOL_CSV, k
    _same_rows(_csv(tmp_path / "p.csv"), _csv(tmp_path / "j.csv"))


def _quanti_files(root, rng, n_feats, ref_rows, names=("a", "b", "c")):
    (root / "pred").mkdir(parents=True)
    (root / "ref").mkdir()
    for i, n in enumerate(names):
        T = 30 + 7 * i
        np.save(root / "pred" / f"{n}.npy",
                rng.standard_normal((2 * n_feats + 1, T)).astype(np.float32))
        if n != "c":  # "c" has no reference: skipped by both
            ref = rng.standard_normal((T + 3 - 5 * i, ref_rows)).astype(np.float32)
            np.save(root / "ref" / f"{n}.npy", ref.T if i == 1 and ref_rows == 80 else ref)


def test_quanti_matches_jax(tmp_path, rng):
    for kind, n_feats, rows in (("mel", 80, 80), ("art", 14, 16)):
        root = tmp_path / kind
        _quanti_files(root, rng, n_feats, rows)
        pfn, jfn = getattr(pquanti, f"quanti_{kind}"), getattr(jquanti, f"quanti_{kind}")
        for _ in range(2):  # the second call appends rows, the header once
            got = pfn(str(root / "pred"), str(root / "ref"), str(root / "p.csv"))
            want = jfn(str(root / "pred"), str(root / "ref"), str(root / "j.csv"))
        assert sorted(got) == sorted(want) == ["a", "b"]
        for sid in want:
            assert list(got[sid]) == list(want[sid])
            for k in want[sid]:
                assert abs(got[sid][k] - want[sid][k]) <= TOL_CSV, (kind, sid, k)
        rows_p = _csv(root / "p.csv")
        assert len(rows_p) == 5 and rows_p[0][0] == "sample_id"
        _same_rows(rows_p, _csv(root / "j.csv"))


@pytest.fixture
def small_models(monkeypatch):
    """The CLIs' full-width UTMOS and vocoders at test widths."""
    monkeypatch.setattr(pscorer, "UTMOSPredictor",
                        functools.partial(UTMOSPredictor, ssl_config=SMALL, **SMALL_HEAD))
    monkeypatch.setattr(ph, "SpkSparcHiFiGANGenerator",
                        functools.partial(ph.SpkSparcHiFiGANGenerator, spk_emb_size=8,
                                          channels=32))
    monkeypatch.setattr(ph, "HiFiGANGenerator",
                        functools.partial(ph.HiFiGANGenerator, upsample_initial_channel=32))


def _lightning(path, pm):
    torch.save({"state_dict": _weight_norm(
        pm.state_dict(), "feature_extractors.0.ssl_model.encoder.pos_conv.0")}, path)


def test_score_cli_on_cpu(tmp_path, rng, small_models):
    from arttts_tpu_torch.cli import score

    pm = _utmos_pair()[0]
    _lightning(tmp_path / "u.ckpt", pm)
    wav_dir = _wav_dir(tmp_path / "wavs", rng)
    got = score.main(["--ckpt", str(tmp_path / "u.ckpt"), "--wav-dir", str(wav_dir),
                      "--out-csv", str(tmp_path / "s.csv"), "--bs", "2", "--device", "cpu"])
    _jax_scorer().score_directory(str(wav_dir), str(tmp_path / "j.csv"), batch_size=2)
    assert sorted(got) == [f"c{i}.wav" for i in range(4)]
    _same_rows(_csv(tmp_path / "s.csv"), _csv(tmp_path / "j.csv"))


def _tiny_artic_preset():
    enc = pconfig.EncoderConfig(kind="ipa_trait", n_vocab=0, n_input_feats=25, n_channels=16,
                                filter_channels=32, filter_channels_dp=16, n_heads=1,
                                n_layers=1)
    model = pconfig.ModelConfig(name="art_tts", n_feats=16, encoder=enc,
                                decoder=pconfig.DecoderConfig(kind="unet2d", dim=64))
    return pconfig.ExperimentConfig("tiny_eval_v1", model,
                                    pconfig.DataConfig(dataset="phnm_artic"))


def test_pipeline_cli_on_cpu(tmp_path, rng, small_models):
    """The four stages on a tiny v1-shaped preset: artifacts, quanti_art
    (equal to the JAX function on the same files), SPARC wavs and UTMOS
    (equal to the JAX scorer on the same wavs)."""
    from arttts_tpu.text.phnms import build_phnm3
    from arttts_tpu_torch.cli import pipeline
    from arttts_tpu_torch.models.tts import build_model

    cfg = _tiny_artic_preset()
    pconfig.register_preset(cfg)
    try:
        root = tmp_path / "data"
        for d in ("phnm3", "encoded_audio_en/emasrc", "refs"):
            (root / d).mkdir(parents=True)
        lines = []
        for i in range(2):
            n = 5 + i
            bounds = np.concatenate([[0.0], np.cumsum(rng.uniform(0.06, 0.16, n))])
            phones = list(rng.choice(["h", "ə", "l", "oʊ", "t", "s"], n))
            np.save(root / "phnm3" / f"utt{i:03d}_phnm3.npy", build_phnm3(phones, bounds))
            art = rng.standard_normal((int(bounds[-1] * 50) + 1, 14)).astype(np.float32)
            np.save(root / "encoded_audio_en" / "emasrc" / f"utt{i:03d}.npy", art)
            np.save(root / "refs" / f"utt{i:03d}.npy", art + 0.1)
            lines.append(f"DUMMY/wavs/utt{i:03d}.wav|DUMMY/phnm3/utt{i:03d}_phnm3.npy")
        (root / "test.txt").write_text("\n".join(lines))
        ckpt = save_checkpoint(str(tmp_path / "ckpt"), "grad_best",
                               build_model(cfg.model, device="cpu", seed=3).state_dict())
        sparc = ph.build_sparc_vocoder(device="cpu", seed=6)
        parts = {"spk_ft": {}, "generator": {}}
        for k, v in sparc.state_dict().items():
            head, rest = k.split(".", 1)
            parts[head][rest] = v
        torch.save({"config": {"sr": 16000}, "state_dict": parts}, tmp_path / "sparc.ckpt")
        np.save(tmp_path / "spk.npy", rng.standard_normal(1024).astype(np.float32))
        pm = _utmos_pair()[0]
        _lightning(tmp_path / "u.ckpt", pm)
        work = tmp_path / "out"
        pipeline.main(["--preset", cfg.name, "--ckpt", ckpt, "--filelist",
                       str(root / "test.txt"), "--data-root", str(root), "--workdir",
                       str(work), "--n-timesteps", "2", "--vocoder-ckpt",
                       str(tmp_path / "sparc.ckpt"), "--spk-ft", str(tmp_path / "spk.npy"),
                       "--pitch-stats", "140", "30", "--utmos-ckpt", str(tmp_path / "u.ckpt"),
                       "--ref-art-dir", str(root / "refs"), "--device", "cpu"])
    finally:
        del pconfig.PRESETS[cfg.name]
    preds = sorted(p.name for p in (work / "preds").glob("*.npy"))
    assert preds == ["utt000.npy", "utt001.npy"]
    jquanti.quanti_art(str(work / "preds"), str(root / "refs"), str(tmp_path / "jq.csv"))
    _same_rows(_csv(work / "quanti_art.csv"), _csv(tmp_path / "jq.csv"))
    for p in (work / "wavs").glob("*.wav"):
        wav, sr = load_wav(p)
        assert sr == 16000 and np.isfinite(wav).all() and len(wav) > 0
    _jax_scorer().score_directory(str(work / "wavs"), str(tmp_path / "ju.csv"))
    rows = _csv(work / "utmos.csv")
    assert [r[0] for r in rows] == ["utt000.wav", "utt001.wav"]
    _same_rows(rows, _csv(tmp_path / "ju.csv"))


@pytest.fixture(scope="module")
def demo_server():
    from arttts_tpu_torch.cli.demo import DemoApp, serve

    cfg = pconfig.ExperimentConfig(
        "tiny_eval_demo",
        pconfig.ModelConfig(name="grad_tts", n_feats=80, encoder=pconfig.EncoderConfig(
            kind="text", n_vocab=149, n_channels=16, filter_channels=32,
            filter_channels_dp=16, n_heads=2, n_layers=1),
            decoder=pconfig.DecoderConfig(dim=64)),
        pconfig.DataConfig(dataset="text_mel"))
    pconfig.register_preset(cfg)
    pm, _, _, _ = _utmos_pair()
    app = DemoApp(cfg.name, vocoder=ph.build_vocoder(device="cpu", upsample_initial_channel=32),
                  scorer=pscorer.UTMOSScorer(pm, device="cpu"), max_frames_cap=128,
                  device="cpu")
    srv = serve(app, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield app, srv.server_address
    srv.shutdown()
    t.join(timeout=10)
    srv.server_close()
    del pconfig.PRESETS[cfg.name]


def _request(addr, method, path, body=None):
    conn = http.client.HTTPConnection(*addr, timeout=120)
    conn.request(method, path, body=body)
    r = conn.getresponse()
    out = (r.status, r.getheader("Content-Type"), r.read())
    conn.close()
    return out


def test_demo_routes_on_cpu(demo_server):
    """GET /, /api/tts (an unknown solver name gives Euler's wav), /api/mos
    on the returned wav (the scorer's score of it, resampled and tiled), a
    bad route, and a failing request that answers 500."""
    from scipy.io import wavfile
    from scipy.signal import resample_poly

    app, addr = demo_server
    status, ctype, body = _request(addr, "GET", "/")
    assert status == 200 and ctype.startswith("text/html") and b"/api/tts" in body
    wavs = {}
    for solver in ("euler", "Euler", "rk4"):
        np.random.seed(7)  # the request's generator seed comes from np.random
        status, ctype, body = _request(addr, "POST", "/api/tts", json.dumps(
            {"text": "hello world.", "n_timesteps": 2, "solver": solver}))
        assert status == 200 and ctype == "audio/wav", body[:200]
        wavs[solver] = body
    assert wavs["Euler"] == wavs["euler"] == wavs["rk4"]
    sr, audio = wavfile.read(io.BytesIO(wavs["euler"]))
    assert sr == 22050 and audio.dtype == np.int16 and len(audio) % 256 == 0 and len(audio)
    status, ctype, body = _request(addr, "POST", "/api/mos", wavs["euler"])
    assert status == 200 and ctype == "application/json"
    x = resample_poly(audio.astype(np.float32) / 32768.0, 320, 441).astype(np.float32)
    want = app.scorer.score_batch([pscorer.repeat_pad(x, pscorer._bucket(len(x)))])[0]
    assert abs(json.loads(body)["mos"] - float(want)) <= 1e-6
    assert _request(addr, "GET", "/nope")[0] == 404
    assert _request(addr, "POST", "/api/nope", b"{}")[0] == 404
    status, _, body = _request(addr, "POST", "/api/mos", b"not a wav")
    assert status == 500 and "error" in json.loads(body)
