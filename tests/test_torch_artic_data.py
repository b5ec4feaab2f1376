"""Parity of the port's data path for the multi-speaker articulatory model
(v6 / v6_zhCN / msml1h) with the JAX package's, on the CPU: the IPA trait
table, the VoxCommunis decoder and tokenizer, the 26-column phone-feature
rows, manifest and alignment IO, the SPARC feature conventions, wav IO and
the `MsPhnmDataset` / `MsPhnmArticDataset` items on a synthetic
VoxCommunis layout. Everything here is integer or copied data, so every
comparison is exact.
"""

import dataclasses

import numpy as np
import pytest

from arttts_tpu.audio import io as jio
from arttts_tpu.core import config as jconfig
from arttts_tpu.data import features as jfeat
from arttts_tpu.data import ms_datasets as jms
from arttts_tpu.text import ipa_features as jipa
from arttts_tpu.voxcommunis import data as jdata
from arttts_tpu.voxcommunis import decoder as jdec
from arttts_tpu.voxcommunis import io as jvio
from arttts_tpu.voxcommunis import utils as jutils
from arttts_tpu_torch.audio import io as pio
from arttts_tpu_torch.core import config as pconfig
from arttts_tpu_torch.data import features as pfeat
from arttts_tpu_torch.data import ms_datasets as pms
from arttts_tpu_torch.text import ipa_features as pipa
from arttts_tpu_torch.voxcommunis import data as pdata
from arttts_tpu_torch.voxcommunis import decoder as pdec
from arttts_tpu_torch.voxcommunis import io as pvio
from arttts_tpu_torch.voxcommunis import utils as putils
from tests.voxcommunis_layout import write_layout as _layout

# single segments, affricates with tie bars, diphthongs (two components),
# diacritics (length, aspiration, nasalisation), NFC input, tone letters,
# the level tone, stress marks, silence and an unknown symbol
PHONES = ["a", "t", "t͡ʃ", "aɪ", "ou", "kʰ", "aː", "ã", "ĩ", "ɛ", "ŋ", "ʃ", "˥", "˩",
          "˧", "ˈa", "SIL", "?"]


def _same(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.asarray(a).dtype == np.asarray(b).dtype


def test_trait_table_and_sparc_constants_are_copies():
    assert pipa.TRAITS == jipa.TRAITS
    assert pipa.SEGMENTS == jipa.SEGMENTS
    assert pipa._MODIFIERS == jipa._MODIFIERS and pipa._PREFIX_MODIFIERS == jipa._PREFIX_MODIFIERS
    for seg in list(jipa.SEGMENTS) + PHONES:
        _same(pipa.segment_features(seg), jipa.segment_features(seg))
        _same(pipa.word_features(seg), jipa.word_features(seg))
        assert pipa.validate_segment(seg) == jipa.validate_segment(seg)
    for name in ("SPARC_REORDER_FEATS", "SPARC_PITCH_IDX", "SPARC_LOUDNESS_IDX"):
        assert getattr(pconfig, name) == getattr(jconfig, name), name


def test_load_table_and_reset(tmp_path):
    """A panphon-format table swaps in and out the same way in both copies."""
    path = tmp_path / "table.csv"
    rows = ["ipa," + ",".join(jipa.TRAITS)]
    rows += ["a," + ",".join("+" if i % 3 == 0 else "-" for i in range(24)),
             "t," + ",".join("0" if i % 2 else "+" for i in range(24))]
    path.write_text("\n".join(rows) + "\n", encoding="utf-8")
    try:
        for merge in (False, True):
            assert pipa.load_table(str(path), replace=not merge) == jipa.load_table(
                str(path), replace=not merge) == 2
            assert pipa.SEGMENTS == jipa.SEGMENTS
            for seg in PHONES:
                _same(pipa.word_features(seg), jipa.word_features(seg))
    finally:
        pipa.reset_table()
        jipa.reset_table()
    assert pipa.SEGMENTS == jipa.SEGMENTS


@pytest.mark.parametrize("sum_diphthong", [True, False])
@pytest.mark.parametrize("lang", [None, ["SIL", "a", "t", "t͡ʃ", "ɛ", "ŋ", "ʃ", "kʰ"]],
                         ids=["multilingual", "one language"])
def test_feature_decoder_tokenizer_and_rows(sum_diphthong, lang):
    """`FeatureDecoder`'s inventory and inverse lookup, `FeatureTokenizer.encode`
    and `phonological_feature_rows` over phones with several components,
    silence and tones: exact."""
    if lang is not None and not sum_diphthong:
        lang = lang + ["aɪ"]  # split into its two characters
    jd, pd = jdec.FeatureDecoder(sum_diphthong, lang), pdec.FeatureDecoder(sum_diphthong, lang)
    assert pd.segments == jd.segments and pd.header == jd.header
    assert pd.zero_index == jd.zero_index
    _same(pd.features, jd.features)
    jt, pt = jdata.FeatureTokenizer(jd), pdata.FeatureTokenizer(pd)
    phones = PHONES if lang is None else [p for p in lang if p != "aɪ" or not sum_diphthong]
    counts = [1 + (3 * i) % 5 for i in range(len(phones))]
    for p in phones:
        (jn, jv), (pn, pv) = jt.ipa_to_features(p), pt.ipa_to_features(p)
        assert pn == jn, p
        _same(pv, jv)
    (jf, jp), (pf, pp) = jt.encode(phones, counts), pt.encode(phones, counts)
    _same(pf, jf)
    assert pp == jp
    assert pt.decode(pf) == jt.decode(jf)
    r = np.random.default_rng(3)
    queries = r.integers(-1, 2, size=(12, pdec.PHON_FEAT_DIM))
    assert pd.find_segment(tuple(int(v) for v in queries[0])) == jd.find_segment(
        tuple(int(v) for v in queries[0]))
    assert pt.decode(queries) == jt.decode(queries)
    assert pd.fake_segments == jd.fake_segments
    # a 100 Hz alignment string: runs of phones, silences, downsampled to 50 Hz
    frames = sum(([p] * (2 * c) for p, c in zip(phones, counts)), [])
    inv = dict(corrections={"ŋ": "ʃ"})
    jstr = jdata.PanPhonInventory(**inv).convert_to_ipa(" ".join(frames))
    pstr = pdata.PanPhonInventory(**inv).convert_to_ipa(" ".join(frames))
    assert pstr == jstr
    rows = pdata.phonological_feature_rows(pstr, pt)
    assert rows.shape[1] == 26
    _same(rows, jdata.phonological_feature_rows(jstr, jt))


def test_sequence_helpers():
    seq = ["a", "a", "b", "SIL", "SIL", "SIL", "a"]
    assert putils.unique_consecutive(seq, True) == jutils.unique_consecutive(seq, True)
    assert putils.unique_consecutive(seq) == jutils.unique_consecutive(seq)
    assert putils.flatten_lists([[1, 2], [], [3]]) == jutils.flatten_lists([[1, 2], [], [3]])


def _same_items(p_ds, j_ds):
    assert len(p_ds) == len(j_ds)
    assert p_ds.manifest == j_ds.manifest and p_ds.ipa_phones == j_ds.ipa_phones
    assert p_ds.langs == j_ds.langs and p_ds.lang_sizes == j_ds.lang_sizes
    _same(p_ds.lengths(), j_ds.lengths())
    for i in range(len(j_ds)):
        a, b = p_ds[i], j_ds[i]
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    assert a["x"].shape[1] == 26 and a["spk"].shape == (1024,)
    _same(a["durations"], a["x"][:, -1])


def test_voxcommunis_io_and_ms_datasets(tmp_path, rng):
    """Manifest and alignment IO, then `MsPhnmDataset` and
    `MsPhnmArticDataset` items (merged and per-language files, languages
    excluded, loudness log-normalised) on one layout: exact."""
    _layout(tmp_path, rng)
    for name in ("manifests/ab.tsv", "all.tsv"):
        assert pvio.read_manifest(tmp_path / name) == jvio.read_manifest(tmp_path / name)
    pvio.write_manifest(tmp_path / "wavs", tmp_path / "port.tsv")
    assert (tmp_path / "port.tsv").read_text() == (tmp_path / "all.tsv").read_text()
    assert pvio.read_alignment(tmp_path / "all.align") == jvio.read_alignment(
        tmp_path / "all.align")

    def pair(cls, *args, **kw):
        jt = jdata.FeatureTokenizer(jdec.FeatureDecoder(sum_diphthong=True))
        pt = pdata.FeatureTokenizer(pdec.FeatureDecoder(sum_diphthong=True))
        return (getattr(pms, cls)(*args, pt, **kw), getattr(jms, cls)(*args, jt, **kw))

    merged = (tmp_path, tmp_path / "all.tsv", tmp_path / "all.align")
    split = (tmp_path, tmp_path / "manifests", tmp_path / "alignments")
    _same_items(*pair("MsPhnmDataset", *merged))
    _same_items(*pair("MsPhnmArticDataset", *merged))
    _same_items(*pair("MsPhnmArticDataset", *merged, log_normalize_loudness=True))
    p_ds, j_ds = pair("MsPhnmArticDataset", *split, separate_files=True, exclude_langs=["it"])
    assert p_ds.langs == ["ab"]
    _same_items(p_ds, j_ds)
    p_ds, j_ds = pair("MsPhnmDataset", *split, separate_files=True, corrections={"a": "ɛ"})
    _same_items(p_ds, j_ds)
    for a, b in zip(p_ds.sample_test_batch(2, seed=5), j_ds.sample_test_batch(2, seed=5)):
        _same(a["x"], b["x"])


def test_sparc_feature_conventions_and_wav_io(tmp_path, rng):
    art = rng.standard_normal((33, 16)).astype(np.float32)
    art[:, 13] = np.abs(art[:, 13]) + 0.05
    _same(pfeat.reorder_art_feats(art[:, :14]), jfeat.reorder_art_feats(art[:, :14]))
    _same(pfeat.normalize_pitch_channel(art.copy()), jfeat.normalize_pitch_channel(art.copy()))
    flat = art.copy()
    flat[:, 15] = 2.0  # zero spread: the mean is taken off only
    _same(pfeat.normalize_pitch_channel(flat.copy()), jfeat.normalize_pitch_channel(flat.copy()))
    _same(pfeat.log_normalize_loudness_channel(art.copy()),
          jfeat.log_normalize_loudness_channel(art.copy()))
    np.save(tmp_path / "t.npy", art)
    for log in (False, True):
        _same(pfeat.load_art_features(tmp_path / "t.npy", log_normalize_loudness=log),
              jfeat.load_art_features(tmp_path / "t.npy", log_normalize_loudness=log))
    audio = np.clip(rng.standard_normal(4000) * 0.4, -1.2, 1.2)
    pio.save_wav(tmp_path / "p.wav", audio, 16000)
    jio.save_wav(tmp_path / "j.wav", audio, 16000)
    assert (tmp_path / "p.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    for sr in (None, 22050):
        (pa, ps), (ja, js) = pio.load_wav(tmp_path / "p.wav", sr), jio.load_wav(tmp_path / "j.wav", sr)
        assert ps == js
        _same(pa, ja)


def test_v6_family_presets_are_copies():
    """The port's v6 / v6_zhCN / msml1h presets equal the JAX package's
    field by field (the data fields the datasets read included)."""
    for name in ("v6", "v6_zhCN", "msml1h"):
        p, j = pconfig.get_preset(name), jconfig.get_preset(name)
        assert dataclasses.asdict(p) == dataclasses.asdict(j), name
        assert p.model.encoder.kind == "ipa_trait" and p.model.encoder.n_input_feats == 26
        assert not p.model.encoder.use_duration_predictor and p.model.n_spks == 2
