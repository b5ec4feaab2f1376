"""The readers of the program's spans (`portbench/spans.py` and the
metrics that use it): on a synthetic trace and store against hand-computed
values, on a program that opens no spans, and on a tiny traced v2.serve run
on the CPU."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench import spans
from portbench.harness import metric_reader
from portbench.tests.tiny import run_tiny
from portbench.trace import device_events


def ev(name, ts, dur, cat="user_annotation", tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": tid}


def serve_events():
    return [
        ev("portbench.slice", 0, 100),
        ev("arttts.request", 10, 80),
        ev("arttts.eval", 20, 20),
        ev("arttts.eval", 50, 20),
        ev("arttts.vocode", 75, 10),
        ev("aten::conv2d", 20, 10, cat="cpu_op"),  # host work: neither span nor device
        ev("k", 25, 10, cat="kernel", tid=7),
        ev("k", 45, 15, cat="kernel", tid=7),
        ev("Memcpy DtoH", 80, 15, cat="gpu_memcpy", tid=7),
        ev("arttts.eval", 150, 10),  # after the slice
    ]


def ctx_of(events, mode, workload="cell", start=0.0, end=100.0):
    dev = [e for e in device_events(events) if start <= e["ts"] < end]
    trace = SimpleNamespace(events=events, dev=dev, start_us=start, end_us=end)
    return SimpleNamespace(mode=mode, trace=trace, run=SimpleNamespace(workload=workload))


def test_interval_arithmetic():
    assert spans.union([(5, 7), (0, 2), (1, 3)]) == [(0, 3), (5, 7)]
    assert spans.overlap([(0, 3), (5, 7)], [(2, 6)]) == 2
    assert spans.subtract([(0, 10)], [(2, 3), (5, 6), (9, 12)]) == [(0, 2), (3, 5), (6, 9)]
    assert spans.idle_inside([(0, 10), (5, 15)], [(2, 4), (12, 20)]) == 15 - 2 - 3


def test_idle_inside_the_evaluations_and_self_time():
    """Busy [25,35], [45,60], [80,95]; evaluations [20,40] and [50,70]:
    idle 5 + 5 + 10 of their 40 us. Self time: the request 80 less its
    children's 50; idle in its own time 30 less [45,50] and [85,90]."""
    events = serve_events()
    ctx = ctx_of(events, "closed_loop_serve")
    assert spans.idle_pct_inside(ctx, "closed_loop_serve", "arttts.eval") == pytest.approx(50.0)
    assert metric_reader("eval_idle_pct.serve")(ctx) == pytest.approx(50.0)
    assert metric_reader("eval_idle_pct.serve")(ctx_of(events, "train_steps")) is None
    inside = spans.annotations(events, 0, 100)
    assert spans.self_seconds(inside) == pytest.approx(
        {"arttts.request": 30e-6, "arttts.eval": 40e-6, "arttts.vocode": 10e-6})
    b = spans.breakdown(events, 0, 100)
    assert b["spans"]["arttts.eval"]["count"] == 2
    assert b["spans"]["arttts.request"]["idle_s"] == pytest.approx(20e-6)
    assert b["spans"]["arttts.vocode"]["idle_s"] == pytest.approx(5e-6)
    assert b["spans"]["arttts.eval"]["idle_s"] == pytest.approx(20e-6)
    assert b["idle_s"] == pytest.approx(60e-6)
    assert b["idle_outside_spans_s"] == pytest.approx(15e-6)  # [0,10] and [95,100]


def test_vocode_idle_share():
    events = [ev("portbench.slice", 0, 100), ev("arttts.pipeline.vocode", 40, 50),
              ev("k", 30, 20, cat="kernel", tid=7), ev("k", 60, 10, cat="kernel", tid=7)]
    ctx = ctx_of(events, "batch_pipeline")
    # busy inside [40,90]: [40,50] and [60,70]
    assert metric_reader("vocode_idle_pct.batch")(ctx) == pytest.approx(60.0)


def test_optimizer_share_of_the_steps():
    events = [ev("portbench.slice", 0, 200),
              ev("arttts.train.step", 0, 100), ev("arttts.train.clip", 70, 5),
              ev("arttts.train.optimizer", 75, 20),
              ev("arttts.train.step", 100, 100), ev("arttts.train.clip", 170, 2),
              ev("arttts.train.optimizer", 172, 18)]
    ctx = ctx_of(events, "train_steps", end=200)
    assert metric_reader("optim_pct.train")(ctx) == pytest.approx(100.0 * 45 / 200)


def test_pad_share_from_the_store(monkeypatch):
    """The slice's decodes: 1 - (90 + 200 + 500) / (128 + 256 + 512) of
    the frames were padding; a reader of another kind of traffic, or of
    an untraced run, reads nothing."""
    from arttts_tpu_torch.utils import profiling

    def rec(computed, kept):
        return {"name": "arttts.decode",
                "counts": {"frames_computed": computed, "frames_kept": kept}}

    store = [rec(128, 90), {"name": "arttts.other", "counts": {"frames_computed": 64}},
             rec(256, 200), rec(512, 500)]
    monkeypatch.setattr(profiling, "spans", lambda: store)
    ctx = ctx_of(serve_events(), "closed_loop_serve")
    want = 100.0 * (1.0 - (90 + 200 + 500) / (128 + 256 + 512))
    assert metric_reader("pad_pct.serve")(ctx) == want
    assert metric_reader("pad_pct.batch")(ctx) is None  # another kind of traffic
    ctx.mode = "batch_pipeline"
    assert metric_reader("pad_pct.batch")(ctx) == want
    ctx.trace = None
    assert metric_reader("pad_pct.batch")(ctx) is None


def test_a_program_without_spans_reads_nothing(monkeypatch):
    """The readers of a program that opens no spans and keeps no store
    return None and raise nothing."""
    from arttts_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    assert spans.stored("arttts.decode") is None
    events = [e for e in serve_events() if not e["name"].startswith("arttts.")]
    for name, mode in (("pad_pct.serve", "closed_loop_serve"),
                       ("eval_idle_pct.serve", "closed_loop_serve"),
                       ("pad_pct.batch", "batch_pipeline"),
                       ("vocode_idle_pct.batch", "batch_pipeline"),
                       ("optim_pct.train", "train_steps")):
        assert metric_reader(name)(ctx_of(events, mode)) is None
        ctx = ctx_of(events, mode)
        ctx.trace = None  # an untraced run
        assert metric_reader(name)(ctx) is None


def test_tiny_traced_serve_reads_the_pad_share(monkeypatch):
    """A traced v2.serve run at test size: `pad_pct.serve` is 100 x (1 -
    the slice's kept frames over its buckets' frames), exactly; the
    evaluations' idle share reads (all idle: no device on the CPU)."""
    from arttts_tpu_torch.utils import profiling
    from portbench.drivers import closed_loop_serve

    seen = {}
    window = closed_loop_serve.Driver.window

    def keep(self, tracer):
        seen["w"] = window(self, tracer)
        return seen["w"]

    monkeypatch.setattr(closed_loop_serve.Driver, "window", keep)
    profiling.clear_spans()  # a run profiles its slice alone; other tests here profile too
    r = run_tiny("v2.serve", seed=2 ** 31 + 41, seconds=4.0, trace=True)
    recs = seen["w"].slice_records
    assert recs
    want = 100.0 * (1.0 - sum(x["frames"] for x in recs) / sum(x["bucket"] for x in recs))
    assert r["metrics"]["pad_pct.serve"]["value"] == want
    assert r["metrics"]["eval_idle_pct.serve"]["value"] == pytest.approx(100.0)
    assert r["correct"]
