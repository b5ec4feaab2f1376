"""The metric arithmetic: the trace's busy union and kernel table, the work
counter, the peaks table."""

from __future__ import annotations

import json

import pytest
import torch

from portbench import trace, work
from portbench.tests.tiny import tiny_config


def ev(name, ts, dur, cat="kernel", tid=7):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": tid}


def synthetic():
    return [
        ev("void conv3x3_kernel<4>(float const*)", 0, 10),
        ev("gn_stats_kernel", 5, 10, tid=8),  # overlaps the first on another stream
        ev("Memcpy DtoH", 30, 5, cat="gpu_memcpy"),
        ev("elementwise_kernel", 40, 20),
        ev("aten::conv2d", 0, 100, cat="cpu_op"),  # host: never device time
        ev("portbench.slice", -5, 80, cat="gpu_user_annotation"),  # a span, not work
    ]


def test_busy_union_of_a_synthetic_trace():
    dev = trace.device_events(synthetic())
    assert trace.busy_intervals(dev) == [(0, 15), (30, 35), (40, 60)]
    assert trace.busy_seconds(dev) == pytest.approx(40e-6)


def test_kernel_table_and_families():
    dev = trace.device_events(synthetic())
    table = trace.kernel_table(dev)
    assert table[0] == ("elementwise_kernel", pytest.approx(20e-6), 1)
    assert trace.family_seconds(dev, ["conv3x3_kernel", "gn_stats_kernel"]) \
        == pytest.approx(20e-6)
    assert trace.family_seconds(dev, ["conv3x3"]) == 0.0  # whole identifiers only


def test_idle_gaps_are_labelled_by_the_host(tmp_path):
    events = synthetic() + [
        ev("portbench.request", 10, 60, cat="user_annotation"),
        ev("aten::copy_", 14, 20, cat="cpu_op"),
    ]
    gaps = trace.idle_gaps(events, 0, 70)
    assert gaps[0] == ("portbench.request: aten::copy_", pytest.approx(15e-6))
    assert sum(s for _, s in gaps) == pytest.approx(30e-6)
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events + [
        ev("portbench.slice", 0, 70, cat="user_annotation")]}))
    ts = trace.TraceSlice(str(path), 70e-6)
    assert ts.window_s == pytest.approx(70e-6)
    assert ts.busy_s == pytest.approx(40e-6)
    assert len(ts.breakdown()["idle_gaps"]) == 3


def test_rates_of_a_traced_run_read_the_units_before_the_slice():
    from types import SimpleNamespace

    from portbench import harness, readers

    recs = [{"n": n, "before_slice": b} for n, b in ((1, True), (2, True), (5, False), (4, False))]
    w = harness.Window(recs, 10.0, 4, 0, [], vocode_s=1.5, seconds_before_slice=6.0)
    ctx = SimpleNamespace(mode="m", window=w, precision="float32", driver=SimpleNamespace(
        work=lambda rs: (sum(r["n"] for r in rs) * 495e12, 0, 0)))
    assert readers.mfu(ctx, "m") == pytest.approx(100.0 * 3 / 6.0)
    assert readers.host_share(ctx, "m", "vocode_s") == pytest.approx(25.0)
    assert readers.mfu(ctx, "other") is None
    w.seconds_before_slice = None  # an untraced run: the whole window
    assert readers.mfu(ctx, "m") == pytest.approx(100.0 * 12 / 10.0)


def k1_formula(T: int) -> int:
    """K1's operations in one evaluation of the flagship U-Net at 80 rows,
    by the work formulas of the port's on-card smoke test."""
    def f(cs, co, H, T, attn=False, block_only=False):
        ci, P = sum(cs), H * T
        fl = 2 * 9 * ci * co * P
        if not block_only:
            fl += 2 * 9 * co * co * P + (2 * ci * co * P if ci != co else 0)
        if attn:
            fl += 2 * 384 * co * P + 2 * 2 * 4 * 32 * 32 * P + 2 * 128 * co * P
        return fl

    h, q = T // 2, T // 4
    return sum([f((2,), 64, 80, T), f((64,), 64, 80, T, True), f((64,), 128, 40, h),
                f((128,), 128, 40, h, True), f((128,), 256, 20, q), f((256,), 256, 20, q, True),
                f((256,), 256, 20, q, True), f((256,), 256, 20, q), f((256, 256), 128, 20, q),
                f((128,), 128, 20, q, True), f((128, 128), 64, 40, h),
                f((64,), 64, 40, h, True), f((64,), 64, 80, T, block_only=True)])


def v2_counter():
    return work.WorkCounter(json.loads((work.HERE / "configs" / "v2.json").read_text()))


def test_k1_work_at_the_bench_shape():
    wc = v2_counter()
    _, k1, k1_bytes = wc.unet(768)
    assert 50 * k1_formula(768) == pytest.approx(4.84e12, rel=0.01)
    assert 50 * k1 == pytest.approx(50 * k1_formula(768), rel=0.01)
    assert 50 * k1 == pytest.approx(4.84e12, rel=0.01)
    assert k1_bytes > 0


def test_interpolated_counts_equal_direct_ones():
    wc = work.WorkCounter(tiny_config("v6"))
    assert wc.unet(100) == wc._unet_direct(100)
    from torch.utils.flop_counter import FlopCounterMode

    n = 37
    x = torch.zeros(1, n, 26, device="meta")
    with FlopCounterMode(display=False) as fc:
        wc.model.encoder(x, torch.full((1,), n, dtype=torch.int32, device="meta"), None,
                         torch.zeros(1, 64, device="meta"))
    assert wc.encoder(n) == fc.get_total_flops()
    with FlopCounterMode(display=False) as fc:
        wc.vocoder(torch.zeros(1, 45, 14, device="meta"), torch.zeros(1, 1024, device="meta"))
    assert wc.vocoder_ops(45) == fc.get_total_flops()


def test_peaks_table_and_least_time():
    p = work.peaks()
    assert p["dense_flops_per_s"]["float32"] == 495e12  # the TF32 tensor-core rate
    assert p["dense_flops_per_s"]["bfloat16"] == 989e12
    assert p["hbm_bytes_per_s"] == 3.35e12
    assert work.least_seconds(495e12, 0, "float32") == pytest.approx(1.0)
    assert work.least_seconds(0, 3.35e12, "float32") == pytest.approx(1.0)


def test_kernel_families_name_the_port_kernels():
    import re

    fams = json.loads((work.HERE / "kernels.json").read_text())
    for fam in ("K1", "K2", "K3", "K4", "K5", "K6"):
        src = (work.HERE.parent / fams[fam]["source"]).read_text()
        for name in fams[fam]["names"]:
            assert re.search(r"\b" + name + r"\s*\(", src), (fam, name)
