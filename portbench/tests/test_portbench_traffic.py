"""The seeded traffic: the same seed gives the same requests, items and
batches, another seed other ones, and the lengths follow the traffic files'
distributions."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import harness, seeds
from portbench.drivers.batch_pipeline import Driver as BatchDriver
from portbench.drivers.closed_loop_serve import Driver as ServeDriver
from portbench.drivers.train_steps import Driver as TrainDriver

BIG = 2 ** 31 + 12345  # seeds reach past 32 signed bits


def driver(cls, workload, seed):
    return cls(harness.Run(harness.load_spec(workload), seed, 1.0, torch.device("cpu"),
                           False, workload))


def test_quantiles_follow_the_distribution():
    lj = harness.load_spec("v2.serve").traffic["duration_s"]
    q = seeds.quantiles(lj, 400)
    assert q.min() >= lj["min"] and q.max() <= lj["max"]
    assert np.all(np.diff(q) > 0)
    assert q.mean() == pytest.approx(6.57, abs=1e-9)  # LJSpeech 1.1's published mean
    assert seeds.quantiles(lj, 128).mean() == pytest.approx(6.57, abs=1e-9)
    u = seeds.quantiles({"dist": "uniform", "min": 2.0, "max": 8.0}, 64)
    assert u.mean() == pytest.approx(5.0) and u.min() > 2.0 and u.max() < 8.0


def test_serve_pool_is_seeded():
    a, b, c = (driver(ServeDriver, "v2.serve", s).pool() for s in (BIG, BIG, BIG + 1))
    assert all(np.array_equal(x["symbols"], y["symbols"]) for x, y in zip(a, b))
    assert any(not np.array_equal(x["symbols"], y["symbols"]) for x, y in zip(a, c))
    # every seed serves the same lengths, in another order
    assert sorted(len(r["symbols"]) for r in a) == sorted(len(r["symbols"]) for r in c)
    frames = np.array([3 * len(r["symbols"]) for r in a])
    secs = frames * 256 / 22050
    assert 1.0 < secs.min() and secs.max() < 10.2
    assert secs.mean() == pytest.approx(6.57, abs=0.01)  # whole symbols of 3 frames
    d = driver(ServeDriver, "v2.serve", BIG)
    assert {d.bucket_of(len(r["symbols"])) for r in a} == {128, 256, 384, 512, 768, 1024}


def batch_items(seed, c=0):
    d = driver(BatchDriver, "v6.batch", seed)
    g = seeds.rng(seed, "speakers")
    d.speakers = g.standard_normal((8, 1024), dtype=np.float32)
    return d.chunk(c)


def test_batch_items_are_seeded():
    a, b, c = batch_items(BIG), batch_items(BIG), batch_items(BIG + 1)
    assert all(np.array_equal(x["x"], y["x"]) for x, y in zip(a, b))
    assert any(x["x"].shape != y["x"].shape or not np.array_equal(x["x"], y["x"])
               for x, y in zip(a, c))
    frames = np.array([it["durations"].sum() for it in a])
    assert sorted(frames) == sorted(it["durations"].sum() for it in c)
    assert 100 <= frames.min() and frames.max() <= 400  # 2-8 s at 50 Hz
    for it in a:
        assert it["x"].shape[1] == 26
        assert set(np.unique(it["x"][:, :25])) <= {-1.0, 0.0, 1.0}
        assert np.all(it["durations"] >= 1)
        assert 3.0 <= it["durations"].mean() <= 5.0
    assert not np.array_equal(a[0]["x"], batch_items(BIG, 1)[0]["x"])


def test_train_batches_are_seeded():
    a, b, c = (driver(TrainDriver, "v2.train", s).batches() for s in (BIG, BIG, BIG + 1))
    for (x, _), (y, _) in zip(a, b):
        assert all(torch.equal(x[k], y[k]) for k in x)
    assert any(not torch.equal(x["y"], y["y"]) for (x, _), (y, _) in zip(a, c)
               if x["y"].shape == y["y"].shape)
    rows = sorted(r for _, rs in a for r in rs)
    assert rows == sorted(r for _, rs in c for r in rs)  # the same work every seed
    assert len(a) == 8
    for batch, rs in a:
        assert batch["x"].shape[0] == 16 and batch["y"].shape[1] >= 172
        assert all(tokens < frames for tokens, frames in rs)  # every symbol gets a frame
        off = batch["pinned_offsets"].numpy()
        assert np.all(off >= 0) and np.all(off <= np.maximum(
            batch["y_lengths"].numpy() - 172, 0))
    secs = np.array([f for _, f in rows]) * 256 / 22050
    assert 1.0 < secs.min() and secs.max() < 10.2
    assert secs.mean() == pytest.approx(6.57, abs=0.01)  # whole frames


def test_serve_rounds_hold_one_request_of_every_decile():
    d = driver(ServeDriver, "v2.serve", BIG)
    pool = d.pool()
    lengths = sorted(len(r["symbols"]) for r in pool)
    edges = [lengths[k * 40] for k in range(10)]
    for start in range(0, 400, 10):
        rnd = sorted(len(r["symbols"]) for r in pool[start:start + 10])
        assert all(rnd[k] >= edges[k] for k in range(10))
        assert all(rnd[k] <= lengths[(k + 1) * 40 - 1] for k in range(10))
