"""Parity of the port's utilities with the JAX package's, on the CPU:
`voxcommunis/data.py:PhoneticFeatureDataset` and `LANGUAGES`,
`core/config.py:MSML1H_LANG_CODES`, `utils/profiling.py` (`trace`,
`span`), `utils/trace_analysis.py` over `torch.profiler` Chrome traces,
`utils/plotting.py`, and the trainer's sample images.
"""

import dataclasses
import gzip
import json
import os
import sys

import numpy as np
import pytest
import torch

from arttts_tpu.core import config as jconfig
from arttts_tpu.utils import plotting as jplot
from arttts_tpu.utils import trace_analysis as jtrace
from arttts_tpu.voxcommunis import data as jdata
from arttts_tpu.voxcommunis import decoder as jdec
from arttts_tpu_torch import voxcommunis as pvox
from arttts_tpu_torch.core import config as pconfig
from arttts_tpu_torch.utils import plotting as pplot
from arttts_tpu_torch.utils import profiling as pprof
from arttts_tpu_torch.utils import trace_analysis as ptrace
from arttts_tpu_torch.voxcommunis import data as pdata
from tests.voxcommunis_layout import write_layout


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs (the suite's six workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tokenizers():
    return (pdata.FeatureTokenizer(pvox.FeatureDecoder(sum_diphthong=True)),
            jdata.FeatureTokenizer(jdec.FeatureDecoder(sum_diphthong=True)))


@pytest.mark.parametrize("separate_files", [False, True])
def test_phonetic_feature_dataset(tmp_path, rng, separate_files):
    """`PhoneticFeatureDataset` on the synthetic VoxCommunis layout, merged
    files and one pair a language (with a correction map): the same
    manifest, IPA strings and (rows, file id) items as the JAX dataset."""
    write_layout(tmp_path, rng)
    if separate_files:
        args = (tmp_path / "manifests", tmp_path / "alignments")
        kw = dict(separate_files=True, corrections={"a": "ɛ"})
    else:
        args, kw = (tmp_path / "all.tsv", tmp_path / "all.align"), {}
    pt, jt = _tokenizers()
    p, j = pdata.PhoneticFeatureDataset(*args, pt, **kw), jdata.PhoneticFeatureDataset(*args, jt, **kw)
    assert len(p) == len(j) == 6
    assert p.manifest == j.manifest and p.ipa_phones == j.ipa_phones
    if separate_files:
        assert p.langs == j.langs == ["ab", "it"] and p.lang_sizes == j.lang_sizes == [3, 3]
    for i in range(len(j)):
        (a, fa), (b, fb) = p[i], j[i]
        assert fa == fb
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype and a.shape[1] == 26
    assert pvox.PhoneticFeatureDataset is pdata.PhoneticFeatureDataset


def test_languages_and_msml1h_codes():
    assert pvox.LANGUAGES == jdata.LANGUAGES and pvox.LANGUAGES is pdata.LANGUAGES
    assert pconfig.MSML1H_LANG_CODES == jconfig.MSML1H_LANG_CODES
    assert set(pconfig.MSML1H_LANG_CODES) <= set(pvox.LANGUAGES)
    assert set(pconfig.MSML1H_EXCLUDE_LANGS) <= set(pconfig.MSML1H_LANG_CODES)


def _write_trace(root, events, name="host_1.1000.pt.trace.json.gz"):
    root.mkdir(parents=True, exist_ok=True)
    with gzip.open(root / name, "wt") as f:
        json.dump({"schemaVersion": 1, "traceEvents": events}, f)


def _jax_fixture(root):
    """The JAX package's fixture (`tests/test_trace_analysis.py`): a 100 us
    parent holding two ops, a disjoint 50 us op and a host event."""
    _write_trace(root / "plugins", [
        {"ph": "M", "pid": 7, "name": "process_name", "args": {"name": "/device:TPU:0"}},
        {"ph": "M", "pid": 7, "tid": 3, "name": "thread_name", "args": {"name": "XLA Ops"}},
        {"ph": "M", "pid": 1, "name": "process_name", "args": {"name": "python3"}},
        {"ph": "M", "pid": 1, "tid": 9, "name": "thread_name", "args": {"name": "XLA Ops"}},
        {"ph": "X", "pid": 1, "tid": 9, "name": "host_noise", "ts": 0, "dur": 10_000},
        {"ph": "X", "pid": 7, "tid": 3, "name": "while", "ts": 0, "dur": 100},
        {"ph": "X", "pid": 7, "tid": 3, "name": "conv_a", "ts": 0, "dur": 60},
        {"ph": "X", "pid": 7, "tid": 3, "name": "copy_b", "ts": 60, "dur": 40},
        {"ph": "X", "pid": 7, "tid": 3, "name": "conv_a", "ts": 150, "dur": 50},
    ])


def _torch_fixture(root, base=1_700_000_000_000.0):
    """The JAX fixture's leaf intervals as a `torch.profiler` trace, where
    device events on a stream do not nest: a kernel and a memcpy back to
    back on stream 7 of card 0 and a later kernel, with host `cpu_op` and
    `cuda_runtime` events over all of it and a `gpu_user_annotation` span,
    none of which may count."""
    _write_trace(root, [
        {"ph": "M", "pid": 0, "name": "process_name", "args": {"name": "python"}},
        {"ph": "M", "pid": 0, "tid": 7, "name": "thread_name", "args": {"name": "stream 7"}},
        {"ph": "X", "cat": "cpu_op", "pid": 4242, "tid": 4242, "name": "aten::conv2d",
         "ts": base - 5, "dur": 10_000},
        {"ph": "X", "cat": "cuda_runtime", "pid": 4242, "tid": 4242, "name": "cudaLaunchKernel",
         "ts": base + 120, "dur": 8},
        {"ph": "X", "cat": "gpu_user_annotation", "pid": 0, "tid": 7, "name": "region",
         "ts": base, "dur": 400},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "name": "conv_a", "ts": base, "dur": 60},
        {"ph": "X", "cat": "gpu_memcpy", "pid": 0, "tid": 7, "name": "copy_b", "ts": base + 60,
         "dur": 40},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "name": "conv_a", "ts": base + 150,
         "dur": 50},
        {"ph": "f", "cat": "ac2g", "pid": 0, "tid": 7, "name": "ac2g", "ts": base + 150},
    ])


def test_trace_analysis_matches_jax_numbers(tmp_path):
    """The torch trace with the JAX fixture's leaf intervals gives the JAX
    functions' busy union, leaf table and grouped report."""
    _jax_fixture(tmp_path / "jax")
    _torch_fixture(tmp_path / "torch")
    groups = {"conv": ("conv",), "copy": ("copy", "bitcast")}
    assert np.isclose(ptrace.device_busy_seconds(str(tmp_path / "torch")),
                      jtrace.device_busy_seconds(str(tmp_path / "jax")))
    assert np.isclose(ptrace.device_busy_seconds(str(tmp_path / "torch")), 150e-6)
    p = {n: (round(ms, 9), c) for n, ms, c in ptrace.leaf_op_table(str(tmp_path / "torch"))}
    j = {n: (round(ms, 9), c) for n, ms, c in jtrace.leaf_op_table(str(tmp_path / "jax"))}
    assert p == j == {"conv_a": (0.11, 2), "copy_b": (0.04, 1)}
    assert (ptrace.grouped_report(str(tmp_path / "torch"), groups)
            == jtrace.grouped_report(str(tmp_path / "jax"), groups)
            == {"conv": 0.11, "copy": 0.04, "other": 0.0})
    assert ptrace.grouped_report(str(tmp_path / "torch")) == {"other": 0.15}
    names = [e["name"] for e in ptrace.load_device_events(str(tmp_path / "torch"))]
    assert names == ["conv_a", "copy_b", "conv_a"]


def test_trace_analysis_streams_and_latest_file(tmp_path):
    """Two streams that overlap count once in the busy union and each
    event once in the table, memsets included; the newest trace file is
    read by the time in its name, not by path order."""
    base = 1440484175369.305
    events = [
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "name": "k_a", "ts": base, "dur": 100},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 13, "name": "k_b", "ts": base + 50,
         "dur": 100},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "name": "k_c", "ts": base + 400,
         "dur": 65.694},
        {"ph": "X", "cat": "gpu_memset", "pid": 0, "tid": 7, "name": "Memset (Device)",
         "ts": base + 465.694, "dur": 4.0},
    ]
    # pid 10000's file is the newer one, though pid 9999's path sorts last
    _write_trace(tmp_path / "t", events, "h_10000.1700000000000000200.pt.trace.json.gz")
    _write_trace(tmp_path / "t", events[:1], "h_9999.1700000000000000100.pt.trace.json.gz")
    _write_trace(tmp_path / "t" / "sub", events[:1], "h_1.1700000000000000000.pt.trace.json.gz")
    assert ptrace._latest_trace_file(str(tmp_path / "t")).endswith("h_10000.1700000000000000200"
                                                                  ".pt.trace.json.gz")
    busy = ptrace.device_busy_seconds(str(tmp_path / "t"))
    assert np.isclose(busy, (150 + 65.694 + 4.0) * 1e-6)
    table = {n: c for n, _, c in ptrace.leaf_op_table(str(tmp_path / "t"))}
    assert table == {"k_a": 1, "k_b": 1, "k_c": 1, "Memset (Device)": 1}
    rep = ptrace.grouped_report(str(tmp_path / "t"), {"ab": ("k_a", "k_b")})
    assert rep == {"ab": 0.2, "other": 0.07}
    # a name without the handler's time: the file's mtime decides
    _write_trace(tmp_path / "m", events[:1], "b.trace.json.gz")
    _write_trace(tmp_path / "m", events[:1], "a.trace.json.gz")
    os.utime(tmp_path / "m" / "b.trace.json.gz", ns=(2_000_000_000, 2_000_000_000))
    os.utime(tmp_path / "m" / "a.trace.json.gz", ns=(3_000_000_000, 3_000_000_000))
    assert ptrace._latest_trace_file(str(tmp_path / "m")).endswith("a.trace.json.gz")
    with pytest.raises(FileNotFoundError):
        ptrace.load_device_events(str(tmp_path / "none"))


def test_cpu_trace_writes_a_chrome_trace(tmp_path):
    """`trace()` on the CPU writes one gzipped Chrome trace under its
    directory that parses, holds the annotated region and the host ops,
    and has no device events; the profiler it yields keeps its tables."""
    x = torch.randn(32, 32)
    with pprof.trace(str(tmp_path / "prof")) as prof:
        with pprof.span("port_region"):
            (x @ x).sum()
    files = list((tmp_path / "prof").glob("*.pt.trace.json.gz"))
    assert len(files) == 1
    assert ptrace._latest_trace_file(str(tmp_path / "prof")) == str(files[0])
    with gzip.open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events if e.get("ph") == "X"}
    assert "port_region" in names and "aten::mm" in names
    assert ptrace.load_device_events(str(tmp_path / "prof")) == []
    assert ptrace.device_busy_seconds(str(tmp_path / "prof")) == 0.0
    assert any(a.key == "aten::mm" for a in prof.key_averages())


def test_plots_equal_the_jax_plots(rng):
    """`plot_tensor`, `plot_alignment` and `plot_art_trajectories` give the
    JAX helpers' images pixel for pixel."""
    feats = rng.standard_normal((16, 40)).astype(np.float32)
    attn = (rng.uniform(size=(9, 40)) > 0.7).astype(np.float32)
    for a, b in ((pplot.plot_tensor(feats, title="dec"), jplot.plot_tensor(feats, title="dec")),
                 (pplot.plot_tensor(feats.T), jplot.plot_tensor(feats.T)),
                 (pplot.plot_alignment(attn), jplot.plot_alignment(attn))):
        assert a.dtype == np.uint8 and a.ndim == 3 and a.shape[2] == 3
        np.testing.assert_array_equal(a, b)
    tracks = [rng.standard_normal((50, 14)), rng.standard_normal((14, 50))]
    for kw in ({"labels": ["pred", "gt"], "n_channels": 4, "sr": 100}, {"n_channels": 1}):
        np.testing.assert_array_equal(pplot.plot_art_trajectories(tracks, **kw),
                                      jplot.plot_art_trajectories(tracks, **kw))


class _Writer:
    def __init__(self):
        self.images, self.scalars = {}, {}

    def add_scalar(self, tag, value, step):
        self.scalars[tag] = value

    def add_image(self, tag, img, step, dataformats="CHW"):
        self.images[tag] = (img, dataformats)


class _Items:
    """A validation set of three items for the trainer's samples."""

    def __init__(self, r):
        self.items = [{"x": r.standard_normal((5, 25)).astype(np.float32),
                       "y": r.standard_normal((12, 16)).astype(np.float32)} for _ in range(3)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    def lengths(self):
        return np.array([12, 12, 12])

    def sample_test_batch(self, size, seed=37):
        return self.items[:size]


@pytest.mark.parametrize("matplotlib_present", [True, False])
def test_trainer_sample_images(monkeypatch, tmp_path, rng, matplotlib_present):
    """`Trainer.synthesize_samples` logs the JAX trainer's HWC plots of the
    generated features and the alignment where matplotlib imports, and the
    features scaled to [0, 1] where it does not."""
    from arttts_tpu_torch.infer import sampler
    from arttts_tpu_torch.train.trainer import Trainer

    cfg = pconfig.get_preset("v1")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, encoder=dataclasses.replace(
        cfg.model.encoder, n_channels=16, filter_channels=16, filter_channels_dp=16, n_layers=1)),
        train=dataclasses.replace(cfg.train, test_size=2))
    L = 10
    dec = torch.from_numpy(rng.standard_normal((1, 16, 16)).astype(np.float32))
    attn = torch.zeros(1, 5, 16)
    attn[0, np.arange(16) // 4 % 5, np.arange(16)] = 1.0

    def fake(model, generator, x, x_lengths, **kw):
        return dec, dec, attn, torch.tensor([L])

    monkeypatch.setattr(sampler, "synthesize", fake)
    if not matplotlib_present:
        monkeypatch.setitem(sys.modules, "matplotlib", None)  # `import matplotlib` raises
    items, writer = _Items(rng), _Writer()
    trainer = Trainer(cfg, items, valid_dataset=items, tb_writer=writer, device="cpu",
                      log_dir=str(tmp_path / "logs"))
    trainer.synthesize_samples(3, n_timesteps=2)
    assert sorted(writer.images) == [f"image_{i}/{n}" for i in range(2)
                                     for n in ("alignment", "generated_dec")]
    assert sorted(writer.scalars) == ["validation/dtw_0", "validation/dtw_1"]
    img, fmt = writer.images["image_0/generated_dec"]
    al, al_fmt = writer.images["image_0/alignment"]
    feats, path = dec[0, :L].numpy().T, attn[0, :, :L].numpy()
    if matplotlib_present:
        assert fmt == al_fmt == "HWC"
        np.testing.assert_array_equal(img, jplot.plot_tensor(feats))
        np.testing.assert_array_equal(al, jplot.plot_alignment(path))
    else:
        assert fmt == al_fmt == "CHW"
        want = (feats - feats.min()) / (feats.max() - feats.min() + 1e-8)
        np.testing.assert_allclose(img, want[None], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(al, path[None])
