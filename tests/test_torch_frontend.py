"""Parity of the port's text frontend, mel extractor and single-speaker
datasets with the JAX package's, on the CPU.

- text: cleaners, number normalization, CMUdict, `text_to_sequence` (both
  `gradtts_text_conv` paths), `text_to_ipa`, `ipa_to_ternary` (diphthongs
  merged and split) and the phnm3 helpers must give equal outputs on
  `tests/test_data_pipeline.py:TEXTS` and a few harder strings; the port's
  dictionary copy must hold the same bytes as the JAX package's;
- mel: the Slaney filterbank must be equal, the log-mel within TOL_MEL;
- datasets: every single-speaker dataset class, and `build_dataset` for
  each kind, must give the JAX class's items on the `corpus` fixture of
  `tests/test_data_pipeline.py` (symbol ids, traits, durations and
  articulatory targets equal; mel targets within TOL_MEL_CORPUS).
"""

import argparse
import dataclasses
from pathlib import Path

import numpy as np
import pytest

from arttts_tpu.audio.mel import MelConfig as JMelConfig
from arttts_tpu.audio.mel import MelSpectrogram as JMel
from arttts_tpu.audio.mel import mel_filterbank as j_filterbank
from arttts_tpu.cli.train import build_dataset as j_build_dataset
from arttts_tpu.core.config import get_preset as j_get_preset
from arttts_tpu.data import datasets as JD
from arttts_tpu.text import cleaners as jcl
from arttts_tpu.text import converters as jconv
from arttts_tpu.text import numbers as jnum
from arttts_tpu.text import phnms as jphn
from arttts_tpu.text import sequence as jseq
from arttts_tpu.text.cmudict import CMUDict as JCMUDict
from arttts_tpu_torch.audio.mel import MelConfig, MelSpectrogram, mel_filterbank
from arttts_tpu_torch.core.config import get_preset
from arttts_tpu_torch.core.paths import CMUDICT_PATH
from arttts_tpu_torch.data import datasets as PD
from arttts_tpu_torch.text import cleaners as pcl
from arttts_tpu_torch.text import converters as pconv
from arttts_tpu_torch.text import numbers as pnum
from arttts_tpu_torch.text import phnms as pphn
from arttts_tpu_torch.text import sequence as pseq
from arttts_tpu_torch.text import symbols as psym
from arttts_tpu_torch.text.cmudict import CMUDict as PCMUDict
from tests.test_data_pipeline import CMU_PATH, TEXTS, corpus  # noqa: F401

# log-mel against the JAX matmul-DFT on noise-like audio: measured max
# 1.4e-6 (float32 torch.stft against float32 matmuls)
TOL_MEL = 1e-3
# the corpus's pure tones leave most high bins at the log floor (log 1e-5),
# where a float32 DFT's rounding is a large share of the magnitude: there
# the JAX package's own log-mel is 2.1e-3 from a float64 DFT, and the port's
# 2.5e-3 from the JAX package's (measured); above log-mel -11 they agree
# within TOL_MEL (measured 1.1e-3 ... 4e-4 at -11 ... -10, 1.5e-4 at -9)
TOL_MEL_CORPUS = 3e-3
FLOOR_REGION = -10.0

HARD = [
    "Dr. Smith paid $3.50 on the 21st of May, 1864 -- and £2,000 more!",
    "Mr. & Mrs. Lee's co-worker (aged 101) read 2007's well-known 'well-being' essay.",
    "It cost $1.01; 3.14 is pi; the 2nd, 3rd and 12th items: 1,234,567.",
    "Crème brûlée, naïve façade — “quoted” text… {HH AH0 L OW1} world.",
]


@pytest.fixture(scope="module")
def dicts():
    return JCMUDict(CMU_PATH), PCMUDict(str(CMUDICT_PATH))


def test_dictionary_copy_is_byte_equal(dicts):
    assert CMUDICT_PATH.read_bytes() == Path(CMU_PATH).read_bytes()
    jd, pd = dicts
    assert len(pd) == len(jd) > 100_000
    for w in ("hello", "world", "printing", "synthesis", "tensor", "read", "zzzz"):
        assert pd.lookup(w) == jd.lookup(w)


@pytest.mark.parametrize("name", sorted(jcl.CLEANERS))
def test_cleaners_and_numbers_equal(name):
    for text in TEXTS + HARD:
        assert pcl.CLEANERS[name](text) == jcl.CLEANERS[name](text)
    assert sorted(pcl.CLEANERS) == sorted(jcl.CLEANERS)
    for n in (0, 7, 13, 20, 42, 100, 101, 999, 1000, 1001, 1864, 1900, 2000, 2005, 2999,
              3000, 12345, 1_000_000, 10**9 + 7, -17):
        assert pnum.number_to_words(n) == jnum.number_to_words(n)
        assert pnum.number_to_ordinal_words(abs(n)) == jnum.number_to_ordinal_words(abs(n))
    for text in HARD:
        assert pnum.normalize_numbers(text) == jnum.normalize_numbers(text)


def test_symbol_sequences_equal(dicts):
    jd, pd = dicts
    from arttts_tpu.text.symbols import symbols as jsymbols

    assert psym.symbols == jsymbols
    for text in TEXTS + HARD:
        for d in (None, (jd, pd)):
            want = jseq.text_to_sequence(text, dictionary=d and d[0])
            got = pseq.text_to_sequence(text, dictionary=d and d[1])
            assert got == want
            assert pseq.sequence_to_text(got) == jseq.sequence_to_text(want)
            assert pseq.intersperse(got, 148) == jseq.intersperse(want, 148)
        # the "phnmtext" path (gradtts_text_conv False): ARPAbet words first
        assert (PD._text_to_symbol_ids(text, pd, False)
                == JD._text_to_symbol_ids(text, jd, False))
        assert PD._text_to_symbol_ids(text, pd, True) == JD._text_to_symbol_ids(text, jd, True)
    for w in ("hello", "unknownword"):
        assert pseq.get_arpabet(w, pd) == jseq.get_arpabet(w, jd)


def test_ipa_and_ternary_equal(dicts):
    jd, pd = dicts
    assert pconv.ARPABET2IPA == jconv.ARPABET2IPA
    assert pconv.DIPHTHONGS_IPA == jconv.DIPHTHONGS_IPA
    for text in TEXTS + HARD:
        assert pconv.text_to_arpabet(text, pd) == jconv.text_to_arpabet(text, jd)
        for rm in (False, True):
            ipa = pconv.text_to_ipa(text, pd, remove_punctuation=rm)
            assert ipa == jconv.text_to_ipa(text, jd, remove_punctuation=rm)
        if ipa is None:
            continue
        for merge in (True, False):
            a = pconv.ipa_to_ternary(pseq.intersperse(ipa, " "), merge_diphtongues=merge)
            b = jconv.ipa_to_ternary(jseq.intersperse(ipa, " "), merge_diphtongues=merge)
            assert a.dtype == b.dtype == np.float32 and a.shape[1] == 25
            np.testing.assert_array_equal(a, b)
    for arp in ("{P R IH1 N T}", "{AW1 ER0}", ",", "word"):
        assert pconv.get_ipa_from_arp(arp) == jconv.get_ipa_from_arp(arp)


def test_phnm3_helpers_equal():
    phones = ["h", "ə", "l", "oʊ", "w", "ɜ˞", "l", "d", "aɪ"]
    bounds = np.cumsum([0.0, 0.08, 0.05, 0.07, 0.2, 0.06, 0.12, 0.05, 0.04, 0.18])
    a = pphn.build_phnm3(phones, bounds)
    b = jphn.build_phnm3(phones, bounds)
    np.testing.assert_array_equal(a, b)
    for merge in (True, False):
        assert pphn.get_phnms_from_phnm3(a, merge) == jphn.get_phnms_from_phnm3(b, merge)
        np.testing.assert_array_equal(pphn.get_lengths_from_phnm3(a, merge),
                                      jphn.get_lengths_from_phnm3(b, merge))
    phnm_map = np.repeat(np.arange(11), 3)  # 11 tokens (two diphthongs split), 3 frames each
    np.testing.assert_array_equal(pphn.get_pred_phnm3(a, phnm_map),
                                  jphn.get_pred_phnm3(b, phnm_map))


def test_mel_matches_jax(rng):
    cfg = MelConfig()
    jfb = j_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax)
    np.testing.assert_array_equal(
        mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax), jfb)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JMelConfig())
    t = np.arange(22050) / 22050.0
    y = np.stack([
        rng.standard_normal(22050) * 0.3,
        0.3 * np.sin(2 * np.pi * 220 * t) + 0.01 * rng.standard_normal(22050),
    ]).astype(np.float32)
    mel = MelSpectrogram(cfg, device="cpu")
    got = mel(y).numpy()
    want = np.asarray(JMel(JMelConfig())(y))
    assert got.shape == want.shape == (2, mel.num_frames(22050), 80)
    np.testing.assert_allclose(got, want, atol=TOL_MEL, rtol=0)
    # one utterance alone (batched FFTs round differently: measured 2.4e-7)
    np.testing.assert_allclose(mel(y[0]).numpy(), got[0], atol=1e-6, rtol=0)


def _close_mel(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOL_MEL_CORPUS, rtol=0)
    above = want > FLOOR_REGION
    np.testing.assert_allclose(got[above], want[above], atol=TOL_MEL, rtol=0)


def _same_items(p, j, n=None):
    assert len(p) == len(j)
    assert p.entries == j.entries
    for i in range(n or len(j)):
        try:
            b = j[i]
        except ValueError as e:  # a word CMUdict lacks: the port refuses it too
            with pytest.raises(ValueError, match="unconvertible"):
                p[i]
            assert "unconvertible" in str(e)
            continue
        a = p[i]
        assert a.keys() == b.keys()
        for k in b:
            if k == "y" and b[k].shape[-1] == 80:
                _close_mel(a[k], b[k])
            else:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(p.lengths(), j.lengths())


@pytest.fixture(scope="module")
def phnm_corpus(corpus):  # noqa: F811
    """The corpus with phnm3 alignments: rows [wav, phnm3], art npys under
    the phnm3 directory's sibling `encoded_audio_en/emasrc`."""
    root, filelist = corpus
    phnm_dir, art_dir = root / "phnm" / "phnm3", root / "phnm" / "encoded_audio_en" / "emasrc"
    phnm_dir.mkdir(parents=True, exist_ok=True)
    art_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(1)
    inventory = ["h", "ə", "l", "oʊ", "w", "ɜ˞", "d", "aɪ", "t", "s", "n", "i", "eɪ", "k"]
    lines = []
    for i in range(len(TEXTS)):
        art = np.load(root / "encoded" / "emasrc" / f"utt{i:03d}.npy")
        n = int(rng.integers(4, 9))
        cuts = np.sort(rng.uniform(0, art.shape[0] / 50, n - 1))
        bounds = np.concatenate([[0.0], cuts, [art.shape[0] / 50]])
        phnm3 = jphn.build_phnm3(list(rng.choice(inventory, n)), bounds)
        np.save(phnm_dir / f"utt{i:03d}_phnm3.npy", phnm3)
        np.save(art_dir / f"utt{i:03d}.npy", art)
        lines.append(f"DUMMY/wavs/utt{i:03d}.wav|DUMMY/phnm/phnm3/utt{i:03d}_phnm3.npy")
    fl = root / "phnm_filelist.txt"
    fl.write_text("\n".join(lines))
    return root, str(fl)


def test_text_datasets_match_jax(corpus):  # noqa: F811
    root, filelist = corpus
    art = str(root / "encoded")
    _same_items(PD.TextArticDataset(filelist, str(CMUDICT_PATH), artic_dir=art),
                JD.TextArticDataset(filelist, CMU_PATH, artic_dir=art))
    for conv in (True, False):
        _same_items(PD.TextArtDataset(filelist, str(CMUDICT_PATH), artic_dir=art,
                                      gradtts_text_conv=conv),
                    JD.TextArtDataset(filelist, CMU_PATH, artic_dir=art,
                                      gradtts_text_conv=conv))
    p = PD.TextMelDataset(filelist, str(CMUDICT_PATH), data_root_dir=str(root),
                          mel_cache_dir=str(root / "pmel"), device="cpu")
    j = JD.TextMelDataset(filelist, CMU_PATH, data_root_dir=str(root))
    _same_items(p, j)
    assert len(list((root / "pmel").glob("*.npy"))) == len(TEXTS)
    np.testing.assert_array_equal(p[0]["y"], p.get_mel(p.entries[0][0]))  # a cache hit
    spk = root / "spk_filelist.txt"
    spk.write_text("\n".join(f"{line}|{k % 3}" for k, line in
                             enumerate(Path(filelist).read_text().splitlines())))
    _same_items(PD.TextMelSpeakerDataset(str(spk), str(CMUDICT_PATH), str(root),
                                         device="cpu"),
                JD.TextMelSpeakerDataset(str(spk), CMU_PATH, str(root)), n=2)


def test_phnm_datasets_match_jax(phnm_corpus):
    root, fl = phnm_corpus
    for merge in (False, True):
        p = PD.PhnmArticDataset(fl, data_root_dir=str(root), merge_diphtongues=merge)
        j = JD.PhnmArticDataset(fl, data_root_dir=str(root), merge_diphtongues=merge)
        _same_items(p, j)
        for e in j.entries:
            np.testing.assert_array_equal(p.get_durations(e[1]), j.get_durations(e[1]))
    _same_items(PD.PhnmMelDataset(fl, data_root_dir=str(root), device="cpu"),
                JD.PhnmMelDataset(fl, data_root_dir=str(root)))


@pytest.mark.parametrize("preset", ["v0", "v1", "v2", "v2_phnmtext", "v3", "v4"])
def test_build_dataset_matches_jax(preset, corpus, phnm_corpus):  # noqa: F811
    root, filelist = corpus
    kind = get_preset(preset).data.dataset
    assert kind == j_get_preset(preset).data.dataset
    fl = phnm_corpus[1] if kind.startswith("phnm") else filelist
    args = argparse.Namespace(data_root=str(root), cmudict=None, artic_dir=str(root / "encoded"),
                              mel_cache=None)
    p = PD.build_dataset(get_preset(preset), args, fl, device="cpu")
    j = j_build_dataset(j_get_preset(preset), argparse.Namespace(**{**vars(args),
                                                                    "cmudict": CMU_PATH}), fl)
    assert type(p).__name__ == type(j).__name__
    _same_items(p, j, n=2)


@pytest.mark.parametrize("preset", ["v6", "msml1h"])
def test_build_dataset_multispeaker_branch_matches_jax(preset, tmp_path, rng):
    """`build_dataset`'s `ms_phnm_artic` branch: v6 picks its language's
    manifest and alignment inside the given directories, msml1h reads one
    file a language (with its exclusions); items equal to the JAX one's."""
    from tests.test_torch_artic_data import _layout
    from tests.test_torch_artic_data import _same_items as _same_ms_items

    _layout(tmp_path, rng)
    args = argparse.Namespace(data_root=str(tmp_path), cmudict=None, artic_dir=None,
                              mel_cache=None, manifest=str(tmp_path / "manifests"),
                              alignment=str(tmp_path / "alignments"), separate_files=False)
    p = PD.build_dataset(get_preset(preset), args, None, device="cpu")
    j = j_build_dataset(j_get_preset(preset), args, None)
    assert type(p).__name__ == type(j).__name__ == "MsPhnmArticDataset"
    # v6 reads it.tsv alone; msml1h every language but its exclusions ("ab")
    assert len(p) == 3 and p.langs == (None if preset == "v6" else ["it"])
    assert all(m[0].startswith("cv_it_") for m in p.manifest)
    _same_ms_items(p, j)
