"""The port's spans (`utils/profiling.py:span`) on the CPU, at test widths:
nothing recorded and no annotation entered while no profiler records; under
a profiler, the span tree that the Chrome trace shows for a request, for
the batched pipeline's two stages and for a training step, the
evaluations of each solver, the decode's frame counts in the store, and
outputs bit for bit those of an unprofiled run.
"""

import collections
import contextlib
import dataclasses
import gzip
import json

import numpy as np
import pytest
import torch

from arttts_tpu_torch.core import config as pconfig
from arttts_tpu_torch.data.batching import pad_batch
from arttts_tpu_torch.infer import pipeline, sampler
from arttts_tpu_torch.models.hifigan import build_sparc_vocoder, build_vocoder
from arttts_tpu_torch.models.tts import build_model
from arttts_tpu_torch.train.losses import loss_for_model
from arttts_tpu_torch.train.step import make_optimizer, train_step
from arttts_tpu_torch.utils import profiling

STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs (the suite's workers share
    the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _empty_store():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def _small(preset: str) -> pconfig.ModelConfig:
    """The preset's model with a one-layer 16-channel encoder and a 1D
    decoder of dim 16 (the score function's module route)."""
    m = pconfig.get_preset(preset).model
    return dataclasses.replace(
        m, encoder=dataclasses.replace(m.encoder, n_channels=16, filter_channels=32,
                                       filter_channels_dp=16, n_layers=1),
        decoder=dataclasses.replace(m.decoder, kind="unet1d", dim=16))


_BUILT = {}


def _serving():
    if "v2" not in _BUILT:
        cfg = _small("v2")
        _BUILT["v2"] = (build_model(cfg, device="cpu"),
                        build_vocoder(device="cpu", n_mels=cfg.n_feats,
                                      upsample_initial_channel=32))
    return _BUILT["v2"]


def _text(n=12, seed=0):
    g = np.random.default_rng(seed)
    return (torch.as_tensor(g.integers(1, 100, (1, n))),
            torch.tensor([n], dtype=torch.int32))


def _serve(solver="euler"):
    model, voc = _serving()
    x, xl = _text()
    return sampler.serve_text_to_wav(model, voc, torch.Generator().manual_seed(3), x, xl,
                                     n_timesteps=STEPS, solver=solver, device="cpu")


def _tree(path):
    """The `arttts.*` annotations of an exported Chrome trace as nodes
    (`name`, `ts`, `end`, `kids`), each under the annotation open around it
    on its thread; returns the roots in the order they opened."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and e["name"].startswith("arttts.")]
    roots, stacks = [], collections.defaultdict(list)
    for e in sorted(events, key=lambda e: (e["ts"], -e["dur"])):
        node = {"name": e["name"], "ts": e["ts"], "end": e["ts"] + e["dur"], "kids": []}
        stack = stacks[e["tid"]]
        while stack and stack[-1]["end"] <= node["ts"]:
            stack.pop()
        assert not stack or node["end"] <= stack[-1]["end"], "annotations overlap"
        (stack[-1]["kids"] if stack else roots).append(node)
        stack.append(node)
    return roots


def _traced(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return _tree(path)


def _names(nodes):
    return [n["name"] for n in nodes]


def test_no_profiler_records_nothing(monkeypatch):
    """Without a profiler a span is one shared object that does nothing: no
    annotation is opened (`record_function` is never called) and nothing
    is stored."""

    def refuse(*a, **k):
        raise AssertionError("an annotation opened with no profiler recording")

    monkeypatch.setattr(profiling, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert profiling.span("arttts.a") is profiling.span("arttts.b", n=1)
    _serve()
    sampler.synthesize(_serving()[0], torch.Generator().manual_seed(0), *_text(), STEPS, 64,
                       solver="heun", device="cpu")
    assert profiling.spans() == []


def test_request_span_tree_and_counts(tmp_path):
    """`serve_text_to_wav` under a profiler: in the trace, `arttts.request`
    holds encode, decode (one `arttts.eval` an Euler step) and vocode; the
    store keeps the decode alone, with the bucket's frames computed and
    the kept ones; the waveform is bit for bit the unprofiled one."""
    wav0, y0, b0 = _serve()
    with torch.profiler.profile() as prof:
        wav1, y1, b1 = _serve()
    assert torch.equal(wav0, wav1) and torch.equal(y0, y1) and b0 == b1
    (root,) = _traced(prof, tmp_path)
    assert root["name"] == "arttts.request"
    assert _names(root["kids"]) == ["arttts.encode", "arttts.decode", "arttts.vocode"]
    encode, decode, vocode = root["kids"]
    assert _names(decode["kids"]) == ["arttts.eval"] * STEPS
    assert encode["kids"] == [] and vocode["kids"] == []
    assert profiling.spans() == [{"name": "arttts.decode",
                                  "counts": {"frames_computed": b1,
                                             "frames_kept": int(y1.sum())}}]


def test_two_requests_are_two_annotations(tmp_path):
    """Two requests in one profiled region: two `arttts.request` roots, one
    after the other, each holding its own decode; the store keeps both
    decodes in that order."""
    with torch.profiler.profile() as prof:
        _, y_a, b_a = _serve()
        _, y_b, b_b = sampler.serve_text_to_wav(
            *_serving(), torch.Generator().manual_seed(4), *_text(30, seed=1),
            n_timesteps=STEPS, device="cpu")
    first, second = _traced(prof, tmp_path)
    assert _names([first, second]) == ["arttts.request"] * 2
    assert first["end"] <= second["ts"]
    for root in (first, second):
        assert _names(root["kids"]) == ["arttts.encode", "arttts.decode", "arttts.vocode"]
    assert [r["counts"] for r in profiling.spans()] == [
        {"frames_computed": b_a, "frames_kept": int(y_a.sum())},
        {"frames_computed": b_b, "frames_kept": int(y_b.sum())}]


@pytest.mark.parametrize("solver,evaluations", [("euler", STEPS), ("heun", 2 * STEPS),
                                                ("dpm", STEPS)])
def test_solver_evaluations(solver, evaluations, tmp_path):
    """Every score evaluation is one `arttts.eval` span inside the decode,
    whichever solver calls it."""
    with torch.profiler.profile() as prof:
        _serve(solver)
    (root,) = _traced(prof, tmp_path)
    (decode,) = [n for n in root["kids"] if n["name"] == "arttts.decode"]
    assert _names(decode["kids"]) == ["arttts.eval"] * evaluations


def test_synthesize_spans_the_encoder_and_counts_a_batch(tmp_path):
    """`synthesize` on a batch of two: its encoder pass and its decode,
    B x the bucket computed, the summed lengths kept."""
    model, _ = _serving()
    g = np.random.default_rng(1)
    x = torch.as_tensor(g.integers(1, 100, (2, 12)))
    xl = torch.tensor([12, 7], dtype=torch.int32)
    with torch.profiler.profile() as prof:
        *_, y_len = sampler.synthesize(model, torch.Generator().manual_seed(0), x, xl, STEPS,
                                       64, device="cpu")
    assert _names(_traced(prof, tmp_path)) == ["arttts.encode", "arttts.decode"]
    (decode,) = profiling.spans()
    assert decode["counts"] == {"frames_computed": 2 * 64, "frames_kept": int(y_len.sum())}


class _Items:
    def __init__(self, items):
        self.items = items
        self.manifest = [(f"u{k}", None) for k in range(len(items))]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _artic_items(n=3):
    g = np.random.default_rng(2)
    items = []
    for k in range(n):
        T = 4 + 2 * k
        dur = g.integers(2, 5, T).astype(np.float32)
        x = np.concatenate([g.integers(-1, 2, (T, 25)).astype(np.float32), dur[:, None]], 1)
        items.append({"x": x, "spk": g.standard_normal(1024).astype(np.float32),
                      "durations": dur})
    return _Items(items)


def _read_dir(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


def test_pipeline_stage_spans(tmp_path):
    """`run_acoustic_inference_batched` (3 items, B=2): one
    `arttts.pipeline.batch` a batch, holding encode, decode and save;
    `run_sparc_vocoder`: one `arttts.pipeline.track` an artifact holding
    load, vocode and write. The files are byte for byte those of an
    unprofiled run."""
    exp = pconfig.get_preset("v6")
    exp = dataclasses.replace(exp, model=_small("v6"))
    model = build_model(exp.model, device="cpu")
    voc = build_sparc_vocoder(device="cpu", spk_ft_size=8, channels=32, spk_emb_size=8)
    spk_ft = np.random.default_rng(3).standard_normal(8).astype(np.float32)

    def run(root):
        paths = pipeline.run_acoustic_inference_batched(
            exp, model, _artic_items(), str(root / "art"), batch_size=2, n_timesteps=STEPS,
            device="cpu")
        pipeline.run_sparc_vocoder(voc, paths, spk_ft, str(root / "wav"), (120.0, 20.0),
                                   device="cpu")
        return paths

    run(tmp_path / "off")
    with profiling.trace(str(tmp_path / "prof")):
        paths = run(tmp_path / "on")
    for sub in ("art", "wav"):
        assert _read_dir(tmp_path / "off" / sub) == _read_dir(tmp_path / "on" / sub)
    (path,) = (tmp_path / "prof").glob("*.pt.trace.json.gz")
    acoustic, vocode = _tree(path)
    assert (acoustic["name"], vocode["name"]) == ("arttts.pipeline.acoustic",
                                                  "arttts.pipeline.vocode")
    assert _names(acoustic["kids"]) == ["arttts.pipeline.batch"] * 2
    for b in acoustic["kids"]:
        assert _names(b["kids"]) == ["arttts.encode", "arttts.decode", "arttts.pipeline.save"]
    assert [d["counts"]["frames_computed"] for d in profiling.spans()] == [2 * 128, 128]
    assert _names(vocode["kids"]) == ["arttts.pipeline.track"] * len(paths)
    for t in vocode["kids"]:
        assert _names(t["kids"]) == ["arttts.pipeline.load", "arttts.vocode",
                                     "arttts.pipeline.write"]


def test_trace_empties_the_store(tmp_path):
    """The store keeps the spans that carry counts, tensor counts summed to
    ints when read; `trace` empties it on entry."""
    with torch.profiler.profile():
        with profiling.span("arttts.decode", frames_computed=4, frames_kept=3):
            pass
    assert profiling.spans() == [{"name": "arttts.decode",
                                  "counts": {"frames_computed": 4, "frames_kept": 3}}]
    with profiling.trace(str(tmp_path / "prof")):
        with profiling.span("arttts.request"):
            with profiling.span("arttts.decode", frames_computed=8) as s:
                s.count(frames_kept=torch.tensor([3, 2], dtype=torch.int32))
    (rec,) = profiling.spans()
    assert rec == {"name": "arttts.decode", "counts": {"frames_computed": 8, "frames_kept": 5}}
    assert all(isinstance(v, int) for v in rec["counts"].values())


def _train_batch(n_feats):
    g = np.random.default_rng(4)
    items = [{"x": g.integers(1, 100, n).astype(np.int64),
              "y": g.standard_normal((3 * n, n_feats)).astype(np.float32)}
             for n in (10, 14)]
    return {k: torch.as_tensor(v) for k, v in
            pad_batch(items, text_buckets=(16,), frame_buckets=(64,)).items()}


def test_train_step_phases(tmp_path):
    """`train_step` under a profiler: `arttts.train.step` holds loss,
    backward, clip and optimizer in that order; the parameters after it
    are bit for bit those of an unprofiled step."""
    cfg = _small("v2")
    loss_fn = loss_for_model(cfg.name)
    batch = _train_batch(cfg.n_feats)

    def step(profiled):
        model = build_model(cfg, device="cpu")
        opt = make_optimizer(model, 1e-4)
        gen = torch.Generator().manual_seed(5)
        prof = torch.profiler.profile() if profiled else contextlib.nullcontext()
        with prof:
            metrics = train_step(model, opt, batch, gen, 32, loss_fn=loss_fn)
        return model.state_dict(), metrics, prof

    sd0, m0, _ = step(False)
    sd1, m1, prof = step(True)
    for k in sd0:
        assert torch.equal(sd0[k], sd1[k]), k
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    (root,) = _traced(prof, tmp_path)
    assert root["name"] == "arttts.train.step"
    phases = root["kids"]
    assert _names(phases) == ["arttts.train.loss", "arttts.train.backward",
                              "arttts.train.clip", "arttts.train.optimizer"]
    assert all(a["end"] <= b["ts"] for a, b in zip(phases, phases[1:]))
    assert profiling.spans() == []
