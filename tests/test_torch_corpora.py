"""Parity of the port's EMA corpus slice (`arttts_tpu_torch/corpora/`,
`eval/quanti_corpus.py`, `cli/generate_phnm3.py`) with the JAX package's,
on the CPU, on seeded files written in each corpus's own format: MNGU0
(`.lab` labels, `.utt` prompts, EST binary EMA), MOCHA-TIMIT (`.phnm`
labels, EST `.ema` at 500 Hz), MSPKA (octal-escaped `.lab` labels, ASCII
21 x T EMA at 400 Hz) and PB2007 (`.phone` labels in 100 Hz frames, float32
`.bin` EMA). Everything here runs the same NumPy and SciPy code on the same
files, so every comparison is exact unless it says otherwise.
"""

import dataclasses
import filecmp
import logging
from pathlib import Path

import numpy as np
import pytest
import torch

from arttts_tpu.cli import generate_phnm3 as jcli
from arttts_tpu.corpora import configs as jconfigs
from arttts_tpu.corpora import ema_metadata as jmeta
from arttts_tpu.corpora import readers as jreaders
from arttts_tpu.corpora import registry as jregistry
from arttts_tpu.corpora import tables as jtables
from arttts_tpu.data import datasets as jdatasets
from arttts_tpu.eval import quanti_corpus as jquanti
from arttts_tpu.text import ipa_features as jipa
from arttts_tpu_torch.cli import generate_phnm3 as pcli
from arttts_tpu_torch.core.config import SPARC_REORDER_FEATS
from arttts_tpu_torch.corpora import configs as pconfigs
from arttts_tpu_torch.corpora import ema_metadata as pmeta
from arttts_tpu_torch.corpora import readers as preaders
from arttts_tpu_torch.corpora import registry as pregistry
from arttts_tpu_torch.corpora import tables as ptables
from arttts_tpu_torch.data import datasets as pdatasets
from arttts_tpu_torch.eval import quanti_corpus as pquanti
from arttts_tpu_torch.text import ipa_features as pipa

# each corpus's own phone symbols (MOCHA's labels are IPA already)
PHONES = {
    "mngu0": ["p", "aI", "t", "@U", "D", "E", "n", "tS", "I@", "lw", "m!", "o^"],
    "mocha": ["ð", "ə", "k", "æ", "t", "ɝ", "ɚ", "s", "ɪ", "n", "aɪ", "ʃ"],
    "mspka": ["tS", "a", "nf", "E1", "r", "dZ", "o", "ss", "LL", "ttS", "i", "gg"],
    "pb2007": ["a", "s^", "e~", "b", "o^", "z^", "x", "r", "q", "a~", "j", "w"],
}
SILENCE = {"mngu0": "#", "mocha": "sil", "mspka": "sil", "pb2007": "__"}
EMA_RATE = {"mocha": 500, "mspka": 400, "pb2007": 100}
N_SENT = 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs (the suite's six workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smooth_tracks(r, T, rate, n=12):
    """(T, n) smooth trajectories sampled at `rate` Hz (0.5-3 Hz sines)."""
    t = np.arange(T)[:, None] / rate
    freqs, phases = r.uniform(0.5, 3.0, n)[None], r.uniform(0, 2 * np.pi, n)[None]
    return (np.sin(2 * np.pi * freqs * t + phases) + r.uniform(-1, 1, n)[None]).astype(np.float32)


def write_labels(corpus, path, phones, bounds, r):
    """One label file in `corpus`'s format: `bounds` in seconds."""
    if corpus == "mngu0":
        rows = [f"{e:.3f} 26 {p}" for p, e in zip(phones, bounds[1:])]
        path.write_text("separator ;\nnfields 1\n#\n" + "\n".join(rows) + "\n")
    elif corpus == "mocha":
        rows = [f"{s:.4f} {e:.4f} {p}" for p, s, e in zip(phones, bounds[:-1], bounds[1:])]
        path.write_text("\n".join(rows) + "\n\n")
    elif corpus == "mspka":
        words = ["perch\\303\\251", "citt\\303\\240", "cos\\303\\254", "casa"]
        rows = []
        for k, (p, s, e) in enumerate(zip(phones, bounds[:-1], bounds[1:])):
            word = f" {words[int(r.integers(len(words)))]}" if k % 3 == 1 and p != "sil" else ""
            rows.append(f"{s:.5f} {e:.5f} {p}{word}")
        path.write_bytes(("\n".join(rows) + "\n").encode("latin1"))
    else:
        frames = np.rint(np.asarray(bounds) * 100).astype(int)
        rows = [f"{s} {e} {p}" for p, s, e in zip(phones, frames[:-1], frames[1:])]
        path.write_text("\n".join(rows) + "\n")


def write_ema(corpus, path, sparc, r):
    """`sparc` (T, 12) in SPARC order, laid out in `corpus`'s raw file so
    that its reader's channel selection gives it back."""
    T = sparc.shape[0]
    if corpus == "pb2007":
        raw = np.zeros((T, 12), np.float32)
        raw[:, ptables.PB2007_IDX_TO_KEEP] = sparc
        raw.tofile(path)
    elif corpus == "mocha":
        ema = r.standard_normal((T, 20)).astype(np.float32)
        ema[:, ptables.MOCHA_IDX_TO_KEEP] = sparc
        frames = np.concatenate([(np.arange(T) / 500.0)[:, None], np.ones((T, 1)), ema],
                                axis=1).astype(np.float32)
        with open(path, "wb") as f:
            f.write(f"EST_File Track\nDataType binary\nByteOrder 01\nNumFrames {T}\n"
                    "NumChannels 20\nEST_Header_End\n".encode("ascii"))
            frames.tofile(f)
    else:
        raw = r.standard_normal((21, T)).astype(np.float32)
        raw[ptables.MSPKA_EMA_IDX_TO_KEEP] = sparc.T
        path.write_text("\n".join(" ".join(f"{v:.6f}" for v in row) for row in raw) + "\n")


def write_corpus(root, corpus, seed, n=N_SENT, nan_sentence=None):
    """`n` sentences of 1.5-2.5 s of `corpus` under `root/{corpus}`:
    labels in `labels/`, EMA in `ema/`, prompts in `text/` (MNGU0, MOCHA);
    the `nan_sentence`'s EMA has 10% NaN frames. Returns {stem: (T, 12)
    SPARC-ordered tracks at the corpus's EMA rate}."""
    r = np.random.default_rng(seed)
    d = root / corpus
    for sub in ("labels", "ema", "text"):
        (d / sub).mkdir(parents=True, exist_ok=True)
    tracks = {}
    for i in range(n):
        stem = f"{corpus}_{i:03d}"
        dur = float(r.uniform(1.5, 2.5))
        k = int(r.integers(8, 14))
        bounds = np.concatenate([[0.0], np.sort(r.uniform(0.05, dur - 0.05, k - 1)), [dur]])
        phones = [SILENCE[corpus], *r.choice(PHONES[corpus], k - 2), SILENCE[corpus]]
        ext = pregistry.get_corpus(corpus).label_ext
        write_labels(corpus, d / "labels" / f"{stem}{ext}", phones, bounds, r)
        if corpus == "mngu0":
            (d / "text" / f"{stem}.utt").write_text(
                f'EST_File utterance\nFeatures max_id 42 ; iform "\\"Sentence {i} here.\\"" ; '
                f"type s ;\n")
            continue
        if corpus == "mocha":
            (d / "text" / f"{stem}.trans").write_text(f"Sentence number {i}.\nsecond line\n")
        rate = EMA_RATE[corpus]
        sparc = smooth_tracks(r, int(dur * rate), rate)
        if i == nan_sentence:
            sparc[r.choice(len(sparc), len(sparc) // 10, replace=False), 3] = np.nan
        write_ema(corpus, d / "ema" / f"{stem}.{'bin' if corpus == 'pb2007' else 'ema'}",
                  sparc, r)
        tracks[stem] = sparc
    return tracks


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpora")
    tracks = {c: write_corpus(root, c, seed=s, nan_sentence=2 if c == "pb2007" else None)
              for s, c in enumerate(("mngu0", "mocha", "mspka", "pb2007"))}
    return root, tracks


def same_phnm3(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    for field in a.dtype.names:
        np.testing.assert_array_equal(a[field], b[field])


def test_readers_match_jax(corpora, tmp_path):
    """Every corpus's phnm3 reader (labels -> IPA rows), EMA reader and
    sentence reader against the JAX one: field by field and exact."""
    root, _ = corpora
    for corpus in ("mngu0", "mocha", "mspka", "pb2007"):
        labels = sorted((root / corpus / "labels").iterdir())
        assert len(labels) == N_SENT
        for lab in labels:
            p = getattr(preaders, f"get_{corpus}_phnm3")(lab)
            same_phnm3(p, getattr(jreaders, f"get_{corpus}_phnm3")(lab))
            assert len(p) >= 8
        for ema in sorted((root / corpus / "ema").iterdir()):
            a = getattr(preaders, f"get_{corpus}_ema")(ema)
            b = getattr(jreaders, f"get_{corpus}_ema")(ema)
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype and a.shape[1] == 12
    # the prompts, MSPKA's words from its octal-escaped labels (UTF-8 after decoding)
    for utt in sorted((root / "mngu0" / "text").iterdir()):
        assert preaders.get_mngu0_sentence(utt) == jreaders.get_mngu0_sentence(utt) is not None
    for trans in sorted((root / "mocha" / "text").iterdir()):
        assert preaders.get_mocha_sentence(trans) == jreaders.get_mocha_sentence(trans)
    words = [preaders.get_mspka_sentence(f) for f in sorted((root / "mspka" / "labels").iterdir())]
    assert words == [jreaders.get_mspka_sentence(f)
                     for f in sorted((root / "mspka" / "labels").iterdir())]
    assert any(ch in " ".join(words) for ch in "éàì")
    # MSPKA's "nf" splits evenly into n + f; PB2007's frames are 100 Hz
    lab = tmp_path / "nf.lab"
    lab.write_bytes(b"0.0 0.2 sil\n0.2 0.6 nf\n")
    p = preaders.get_mspka_phnm3(lab)
    assert [str(x) for x in p["phone"]] == [".", "n", "f"] and p["end"][1] == np.float32(0.4)
    same_phnm3(p, jreaders.get_mspka_phnm3(lab))
    # MOCHA's full EST record and MNGU0's header-mapped EST track
    ema = sorted((root / "mocha" / "ema").iterdir())[0]
    a, b = preaders.read_mocha_ema(ema), jreaders.read_mocha_ema(ema)
    assert a["header"] == b["header"] and a.keys() == b.keys()
    for k in ("time", "valid", "ema"):
        np.testing.assert_array_equal(a[k], b[k])
    est = tmp_path / "a.ema"
    names = ["T3_px", "T3_py", "UL_px", "UL_py"]
    frames = np.random.default_rng(3).standard_normal((7, 6)).astype(np.float32)
    with open(est, "wb") as f:
        f.write(b"EST_File Track\nDataType binary\nByteOrder 01\nNumFrames 7\n"
                b"NumChannels 4\nEqualSpace 1\nCommentChar ;\n\n")
        f.write("".join(f"Channel_{i} {n}\n" for i, n in enumerate(names)).encode())
        f.write(b"EST_Header_End\n")
        frames.tofile(f)
    a, b = preaders.read_mngu0_ema(est), jreaders.read_mngu0_ema(est)
    assert a["columns"] == b["columns"] == {"time": 0, "present": 1, **{
        n: i + 2 for i, n in enumerate(names)}}
    np.testing.assert_array_equal(a["data"], b["data"])
    np.testing.assert_array_equal(a["data"], frames)


def test_tables_parse_as_the_jax_tables(corpora):
    """The port's tables are the JAX ones, and every IPA value of the four
    phone tables (and every MOCHA phone written here) parses through the
    port's `word_features` into the JAX rows."""
    for name in ("MNGU0_TO_IPA", "MSPKA_TO_IPA", "PB2007_TO_IPA", "MSPKA_EMA_IDX_TO_KEEP",
                 "PB2007_IDX_TO_KEEP", "MOCHA_IDX_TO_KEEP", "PB2007_SPLITS"):
        assert getattr(ptables, name) == getattr(jtables, name), name
    ipa = {v for t in (ptables.MNGU0_TO_IPA, ptables.MSPKA_TO_IPA, ptables.PB2007_TO_IPA)
           for v in t.values()} | {"ə˞", "ɜ˞", *PHONES["mocha"]}
    ipa.discard(".")  # silence: the 25th dimension
    missing = []
    for v in sorted(ipa):
        a, b = pipa.word_features(v), jipa.word_features(v)
        if a is None:
            missing.append(v)
            continue
        np.testing.assert_array_equal(a, b)
    assert not missing, f"unparseable IPA: {missing}"


def test_layouts_configs_and_registry(tmp_path):
    """`CorpusLayout` templates and dirs, `load_corpus_config` on a YAML
    file, and the registry (mngu0 without an EMA reader; the KeyError)."""
    assert pconfigs.CORPUS_LAYOUTS.keys() == jconfigs.CORPUS_LAYOUTS.keys()
    for name, lay in pconfigs.CORPUS_LAYOUTS.items():
        jlay = jconfigs.CORPUS_LAYOUTS[name]
        assert dataclasses.asdict(lay) == dataclasses.asdict(jlay)
        for spk, sid in (("spk1", "0042"), ("fsew0", "")):
            assert lay.expand(lay.filestem, spk, sid) == jlay.expand(jlay.filestem, spk, sid)
            for d in ("audio_dir", "ema_dir", "phone_dir"):
                assert getattr(lay, d)("/data", spk) == getattr(jlay, d)("/data", spk)
    lay = pconfigs.CORPUS_LAYOUTS["mspka"]
    assert str(lay.ema_dir("/d", "cnz")) == "/d/cnz_1.0.0/ema_1.0.0"
    assert lay.expand(lay.filestem, "cnz", "7") == "cnz_7"
    yml = tmp_path / "custom.yaml"
    yml.write_text("audio_sr: 16000\nema_sr: 250\nsrc_ema_reldir: ema/speaker#/\n"
                   "sentences_relpath: speaker#/list\n")
    for name in (None, "other"):
        a = pconfigs.load_corpus_config(yml, name)
        assert dataclasses.asdict(a) == dataclasses.asdict(jconfigs.load_corpus_config(yml, name))
    assert a.name == "other" and a.ema_sr == 250 and a.filestem == "item_id#"

    assert sorted(pregistry.CORPORA) == sorted(jregistry.CORPORA)
    for name, c in pregistry.CORPORA.items():
        j = jregistry.get_corpus(name)
        assert pregistry.get_corpus(name) is c and c.name == j.name == name
        assert c.label_ext == j.label_ext
        for fn in ("get_phnm3", "get_ema", "get_sentence"):
            assert (getattr(c, fn) is None) == (getattr(j, fn) is None)
            if getattr(c, fn) is not None:
                assert getattr(c, fn).__module__ == "arttts_tpu_torch.corpora.readers"
    assert pregistry.get_corpus("mngu0").get_ema is None
    for mod in (pregistry, jregistry):
        with pytest.raises(KeyError, match="unknown corpus 'timit'"):
            mod.get_corpus("timit")


def test_resample_and_validity():
    r = np.random.default_rng(5)
    x = smooth_tracks(r, 999, 500)
    for src, dst in ((500, 100), (400, 100), (500, 50), (400, 50), (100, 50), (100, 100)):
        a, b = pmeta.resample_ema(x, src, dst), jmeta.resample_ema(x, src, dst)
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.float32 and a.shape == b.shape
    for frac in (0.0, 0.04, 0.05, 0.06, 0.3):
        y, n = x.copy(), int(round(frac * len(x)))
        y[:n, 7] = np.nan
        assert pmeta.ema_validity(y) == jmeta.ema_validity(y) == (n / len(y) <= 0.05)


def _metadata(mod, root, corpus):
    d = root / corpus
    meta = mod.SpeakerMetadata(corpus, "spk", str(d), ema_rate=EMA_RATE[corpus])
    return meta.scan(str(d / "labels"), str(d / "ema"))


def test_speaker_metadata_pipeline(corpora, tmp_path):
    """scan -> validate_ema -> extract_durations -> set_splits(seed=37) ->
    agg_Xy_split on each corpus with EMA: the same records, validity,
    durations, splits and pairs; `to_json` the same file byte for byte; a
    port `save`/`load` round-trips. PB2007's NaN sentence is invalid."""
    root, _ = corpora
    for corpus in ("mocha", "mspka", "pb2007"):
        p, j = _metadata(pmeta, root, corpus), _metadata(jmeta, root, corpus)
        p.validate_ema()
        j.validate_ema()
        p.extract_durations()
        j.extract_durations()
        valid = [s.valid for s in p.get_sentences()]
        assert valid == [s.valid for s in j.get_sentences()]
        assert valid == [not (corpus == "pb2007" and i == 2) for i in range(N_SENT)]
        for fracs in ({}, {"val_frac": 0.25, "test_frac": 0.25}):
            p.set_splits(seed=37, **fracs)
            j.set_splits(seed=37, **fracs)
            assert ([dataclasses.asdict(s) for s in p.get_sentences()]
                    == [dataclasses.asdict(s) for s in j.get_sentences()])
        assert {s.split for s in p.get_sentences() if s.valid} == {"train", "val", "test"}
        for split in ("train", "val", "test"):
            (px, py), (jx, jy) = p.agg_Xy_split(split), j.agg_Xy_split(split)
            assert len(px) == len(jx) == len(py) == len(jy) > 0
            for a, b in zip(px, jx):
                same_phnm3(a, b)
            for a, b in zip(py, jy):
                np.testing.assert_array_equal(a, b)
                assert a.shape[1] == 12 and np.isfinite(a).all()
        p.to_json(tmp_path / f"p_{corpus}.json")
        j.to_json(tmp_path / f"j_{corpus}.json")
        assert filecmp.cmp(tmp_path / f"p_{corpus}.json", tmp_path / f"j_{corpus}.json",
                           shallow=False)
        p.save(tmp_path / f"{corpus}.pkl")
        back = pmeta.SpeakerMetadata.load(tmp_path / f"{corpus}.pkl")
        assert type(back) is pmeta.SpeakerMetadata and back.ema_rate == EMA_RATE[corpus]
        assert ([dataclasses.asdict(s) for s in back.get_sentences()]
                == [dataclasses.asdict(s) for s in p.get_sentences()])
        assert back.list_valid_ids() == p.list_valid_ids() == j.list_valid_ids()


def test_compute_sentence_pcc(corpora):
    """Corpus EMA at 50 Hz against a SPARC-like re-encoding, port and JAX;
    the analytic tracks sampled at 50 Hz correlate with it."""
    root, tracks = corpora
    r = np.random.default_rng(9)
    for corpus in ("mocha", "mspka", "pb2007"):
        p, j = _metadata(pmeta, root, corpus), _metadata(jmeta, root, corpus)
        for s in p.get_sentences()[:2]:
            raw = tracks[corpus][s.stem]
            sparc = raw[:: EMA_RATE[corpus] // 50]
            sparc = sparc + 0.05 * r.standard_normal(sparc.shape)
            sparc = np.concatenate([sparc, r.standard_normal((len(sparc), 2))], 1)
            a, b = p.compute_sentence_pcc(s.id, sparc), j.compute_sentence_pcc(s.id, sparc)
            assert a == b and p.sentences[s.id].pcc_vs_sparc == a
            assert a > 0.95


def write_predictions(root, tracks, corpus, r, noise=0.01):
    """(29, T) artifacts whose decoder rows are `corpus`'s tracks at 50 Hz
    plus noise, one a sentence; the rest random."""
    root.mkdir(parents=True, exist_ok=True)
    for stem, raw in tracks.items():
        gt50 = raw[:: EMA_RATE[corpus] // 50]
        art = r.standard_normal((29, len(gt50))).astype(np.float32)
        art[14:26] = np.nan_to_num(gt50).T + noise * r.standard_normal(gt50.T.shape)
        np.save(root / f"{stem}.npy", art)
    np.save(root / "not_a_sentence.npy", np.zeros((29, 10), np.float32))


def test_quanti_art_corpus(corpora, tmp_path):
    """`quanti_art_corpus` on the same prediction files: the same results
    (within 1e-6) and the same CSV, one row a valid sentence, none for the
    NaN sentence."""
    root, tracks = corpora
    r = np.random.default_rng(4)
    for corpus in ("mocha", "mspka", "pb2007"):
        preds = tmp_path / f"pred_{corpus}"
        write_predictions(preds, tracks[corpus], corpus, r)
        p, j = _metadata(pmeta, root, corpus), _metadata(jmeta, root, corpus)
        p.validate_ema()
        j.validate_ema()
        a = pquanti.quanti_art_corpus(str(preds), p, out_csv=str(tmp_path / "p.csv"))
        b = jquanti.quanti_art_corpus(str(preds), j, out_csv=str(tmp_path / "j.csv"))
        assert a.keys() == b.keys()
        for sid in a:
            for k in ("dtw", "ema_pcc"):
                assert abs(a[sid][k] - b[sid][k]) <= 1e-6 and np.isfinite(a[sid][k])
        want = [s.stem for s in p.get_sentences() if s.valid]
        assert sorted(a) == want and len(want) == N_SENT - (corpus == "pb2007")
        assert all(v["ema_pcc"] > 0.95 for v in a.values()), a
    assert (tmp_path / "p.csv").read_text() == (tmp_path / "j.csv").read_text()
    lines = (tmp_path / "p.csv").read_text().splitlines()
    assert lines[0] == "sample_id,dtw,ema_pcc" and lines.count(lines[0]) == 1
    assert len(lines) == 1 + 3 * N_SENT - 1


def test_generate_phnm3_cli(corpora, tmp_path, caplog):
    """`cli.generate_phnm3.main` against the JAX `main` on every corpus: the
    same files and arrays; a label file that fails is logged and skipped."""
    root, _ = corpora
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "zz_broken.phone").write_text("0 10 not_a_phone\n")
    (bad / "aa_fine.phone").write_text("0 10 __\n10 30 a\n")
    runs = [(c, root / c / "labels") for c in ("mngu0", "mocha", "mspka", "pb2007")]
    for corpus, labels in runs + [("pb2007", bad)]:
        args = ["--corpus", corpus, "--phnm-dir", str(labels)]
        with caplog.at_level(logging.ERROR):
            written = pcli.main(args + ["--save-dir", str(tmp_path / "p" / labels.name / corpus)])
        jcli.main(args + ["--save-dir", str(tmp_path / "j" / labels.name / corpus)])
        pdir, jdir = tmp_path / "p" / labels.name / corpus, tmp_path / "j" / labels.name / corpus
        names = sorted(f.name for f in pdir.iterdir())
        assert names == sorted(f.name for f in jdir.iterdir())
        assert written == [str(pdir / n) for n in names]
        for n in names:
            same_phnm3(np.load(pdir / n), np.load(jdir / n))
        if labels == bad:
            assert names == ["aa_fine_phnm3.npy"] and "zz_broken" in caplog.text
        else:
            assert len(names) == N_SENT


@pytest.mark.parametrize("corpus", ["mngu0", "mocha", "mspka", "pb2007"])
def test_corpus_slice_end_to_end(corpora, tmp_path, corpus):
    """The slice as a whole: corpus labels -> the port's `generate_phnm3`
    -> the port's `PhnmArticDataset` items (v1's data), equal to the JAX
    dataset's on the same files -> predictions from those items -> quanti
    against the corpus EMA, equal (MNGU0 has no EMA: items only)."""
    root, tracks = corpora
    r = np.random.default_rng(6)
    data = tmp_path / corpus
    (data / "encoded_audio_en" / "emasrc").mkdir(parents=True)
    written = pcli.main(["--corpus", corpus, "--phnm-dir", str(root / corpus / "labels"),
                         "--save-dir", str(data / "phnm3")])
    rows = []
    for fp in written:
        stem = Path(fp).stem[: -len("_phnm3")]
        if corpus in tracks and stem in tracks[corpus]:
            gt50 = np.nan_to_num(tracks[corpus][stem][:: EMA_RATE[corpus] // 50])
        else:
            gt50 = smooth_tracks(r, int(np.load(fp)["end"][-1] * 50), 50)
        art = np.concatenate([gt50, r.uniform(0.1, 1.0, (len(gt50), 2))],
                             axis=1).astype(np.float32)
        np.save(data / "encoded_audio_en" / "emasrc" / f"{stem}.npy", art)
        rows.append(f"DUMMY/wavs/{stem}.wav|DUMMY/phnm3/{stem}_phnm3.npy")
    (data / "list.txt").write_text("\n".join(rows) + "\n")
    kw = dict(filelist_path=str(data / "list.txt"), data_root_dir=str(data), shuffle=False)
    pds, jds = pdatasets.PhnmArticDataset(**kw), jdatasets.PhnmArticDataset(**kw)
    assert len(pds) == len(jds) == N_SENT
    np.testing.assert_array_equal(pds.lengths(), jds.lengths())
    preds = data / "preds"
    preds.mkdir()
    for i in range(len(pds)):
        a, b = pds[i], jds[i]
        assert a.keys() == b.keys() == {"x", "y"}
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype
        assert a["x"].shape[1] == 25 and a["y"].shape[1] == 16
        y = a["y"][:, list(SPARC_REORDER_FEATS)]  # the artifact's decoder-row order
        art = np.zeros((29, len(y)), np.float32)
        art[14:28] = y.T + 0.01 * r.standard_normal(y.T.shape)
        np.save(preds / f"{Path(pds.entries[i][0]).stem}.npy", art)
    if corpus == "mngu0":
        return
    p, j = _metadata(pmeta, root, corpus), _metadata(jmeta, root, corpus)
    p.validate_ema()
    j.validate_ema()
    a = pquanti.quanti_art_corpus(str(preds), p, out_csv=str(data / "p.csv"))
    b = jquanti.quanti_art_corpus(str(preds), j, out_csv=str(data / "j.csv"))
    assert a == b and len(a) == N_SENT - (corpus == "pb2007")
    assert (data / "p.csv").read_text() == (data / "j.csv").read_text()
    assert all(v["ema_pcc"] > 0.95 for v in a.values())
