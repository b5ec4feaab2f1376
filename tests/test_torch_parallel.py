"""Data-parallel training in the PyTorch port (`arttts_tpu_torch/parallel/`,
`DataLoader(host_id, num_hosts)`, `train_step(ddp=...)`, `Trainer` and
`cli.train --mesh`) against the JAX package's sharded training, on the CPU
over gloo.

The model and data are the JAX multi-process test's (`tests/dist_worker.py`:
n_feats 16, U-Net dim 16, two encoder layers, global batch 8, buckets 16 /
32), with dropout 0 and pinned draws (t, z, segment offsets), which every
port parity test needs. Two gloo ranks (one torch thread each, spawned
once for the file) each step on their 4 rows of every global batch.

Oracles: the JAX `make_train_step(mesh=make_mesh())` on the 8 virtual CPU
devices, and the port's one-process step on the whole batch. Tolerances:
every loss part within 1e-5 relative of both; the parameters after two
steps within `tests/test_torch_train.py`'s band (2e-6, but for at most
1e-4 of the elements, where Adam turns a gradient at float noise into a
step, 2e-5) against both; the ranks' parameters bit for bit equal.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arttts_tpu.core.config import DecoderConfig, EncoderConfig, ModelConfig
from arttts_tpu.data import batching as jbatching
from arttts_tpu.models.tts import GradTTSModel as JGradTTS
from arttts_tpu.parallel import mesh as jmesh
from arttts_tpu.train.step import create_train_state, make_train_step
from arttts_tpu.utils.torch_convert_acoustic import convert_grad_tts
from arttts_tpu_torch.core import config as pconfig
from arttts_tpu_torch.data import batching as pbatching
from arttts_tpu_torch.models.tts import GradTTSModel as PGradTTS
from arttts_tpu_torch.parallel import mesh as pmesh
from arttts_tpu_torch.parallel.distributed import HostInfo, init_distributed
from arttts_tpu_torch.train import losses as plosses
from arttts_tpu_torch.train.step import make_optimizer, train_step
from arttts_tpu_torch.utils.from_jax import grad_tts_state_dict
from tests import dist_worker
from tests.test_torch_train import _param_change
from tests.test_torch_train_cli import write_phnm_corpus
from tests.torch_dist_pool import (
    RankPool,
    dp_steps,
    free_port,
    port_model,
    replicate_and_mesh,
)

ROOT = Path(__file__).resolve().parents[1]
F, B, OUT = dist_worker.N_FEATS, dist_worker.BATCH_SIZE, dist_worker.OUT_SIZE
BUCKETS = dict(text_buckets=(dist_worker.TEXT_BUCKET,), frame_buckets=(dist_worker.FRAME_BUCKET,))
LR = 1e-4
REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs (`tests/test_torch_cli.py`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pool():
    p = RankPool(2)
    yield p
    p.close()


def _jcfg():
    enc = dict(kind="text", n_vocab=64, n_channels=32, filter_channels=64,
               filter_channels_dp=32, n_heads=2, n_layers=2, dropout=0.0, prenet_dropout=0.0)
    return ModelConfig(name="grad_tts", n_feats=F, encoder=EncoderConfig(**enc),
                       decoder=DecoderConfig(dim=16))


def _pcfg():
    d = dataclasses.asdict(_jcfg())
    return pconfig.ModelConfig(**{**d, "encoder": pconfig.EncoderConfig(**d["encoder"]),
                                  "decoder": pconfig.DecoderConfig(**d["decoder"])})


_CACHE = {}


def _weights():
    """The JAX model, its parameters (numpy) and the port's state dict: the
    port's seeded weights with small distinct Rezero gains (so that the
    attention sites and their gradients act), through the torch -> JAX
    converter."""
    if "w" not in _CACHE:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(7)
            pm = PGradTTS(_pcfg())
        est = pm.decoder.estimator
        with torch.no_grad():
            for k, site in enumerate([lv[2] for lv in est.downs] + [est.mid_attn]
                                     + [u[2] for u in est.ups]):
                site.fn.g.fill_((0.03 + 0.01 * k) * (-1) ** k)
        state = {k: v.detach().numpy().copy() for k, v in pm.state_dict().items()}
        params = jax.tree_util.tree_map(np.asarray, convert_grad_tts(pm.state_dict(),
                                                                     n_enc_layers=2))
        _CACHE["w"] = (JGradTTS(config=_jcfg()), params, state)
    return _CACHE["w"]


def _pinned(batch, seed):
    g = np.random.default_rng(seed)
    y_len = batch["y_lengths"]
    return dict(batch, pinned_t=(0.05 + 0.9 * g.random(B)).astype(np.float32),
                pinned_z=g.standard_normal((B, OUT, F)).astype(np.float32),
                pinned_offsets=(g.random(B) * np.maximum(y_len - OUT, 1)).astype(np.int32))


def _global_batches():
    """The JAX test's two global batches (its BucketBatcher over its items)."""
    items = dist_worker.build_items()
    batcher = jbatching.BucketBatcher([it["y"].shape[0] for it in items], B, seed=37)
    return [_pinned(jbatching.pad_batch([items[int(j)] for j in idx], **BUCKETS), 20 + i)
            for i, idx in enumerate(batcher)]


def _unequal_batch():
    """A global batch whose first four rows (rank 0's) are long and last
    four (rank 1's) short, tokens and frames alike: rank 1's frames are
    fewer than the 16-frame segment, so its segment masks are partial."""
    g = np.random.default_rng(3)
    items = [{"x": g.integers(1, 64, size=(tx,)).astype(np.int64),
              "y": g.standard_normal((ty, F)).astype(np.float32)}
             for tx, ty in [(12, 32), (11, 31), (12, 30), (10, 32), (6, 12), (5, 13), (6, 10),
                            (4, 14)]]
    return _pinned(jbatching.pad_batch(items, **BUCKETS), 30)


def _jax_sharded_steps(batches):
    """`make_train_step(mesh=make_mesh())` on the 8 virtual devices, from the
    shared weights. The step and the first state are made once: the state's
    optimizer is a static field of the jit's input, and a new one would
    compile the step again."""
    if "jax" not in _CACHE:
        jm, params, _ = _weights()
        mesh = jmesh.make_mesh()
        state = create_train_state(jm, {"params": params}, LR)
        state = state.replace(step=jmesh.replicate(mesh, state.step),
                              params=jmesh.replicate(mesh, state.params),
                              opt_state=jmesh.replicate(mesh, state.opt_state))
        _CACHE["jax"] = (mesh, state, make_train_step(jm, out_size=OUT, mesh=mesh, donate=False))
    mesh, state, step = _CACHE["jax"]
    metrics = []
    for b in batches:
        state, m = step(state, jax.random.PRNGKey(0), jmesh.shard_batch(mesh, b))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax.tree_util.tree_map(np.asarray, state.params)


def _port_steps(batches):
    """The port's one-process step on the whole global batches."""
    model = port_model(_pcfg(), _weights()[2])
    opt = make_optimizer(model, LR)
    metrics = [{k: float(v) for k, v in
                train_step(model, opt, {k: torch.from_numpy(v) for k, v in b.items()}, None,
                           OUT).items()} for b in batches]
    return metrics, {k: v.detach().clone() for k, v in model.state_dict().items()}


def _check_dp(pool, batches):
    """Two ranks against both oracles; returns the ranks' metrics."""
    _, params, state = _weights()
    (m0, s0), (m1, s1) = pool.run(dp_steps, _pcfg(), state, batches, OUT, LR)
    jmetrics, jparams = _jax_sharded_steps(batches)
    pmetrics, pstate = _port_steps(batches)
    assert m0 == m1  # the all-reduced parts are the same on both ranks
    for k in s0:
        np.testing.assert_array_equal(s0[k], s1[k], err_msg=k)
    for got, jref, pref in zip(m0, jmetrics, pmetrics):
        for k in ("total_loss", "dur_loss", "prior_loss", "diff_loss"):
            np.testing.assert_allclose(got[k], jref[k], rtol=REL, atol=0, err_msg=k)
            np.testing.assert_allclose(got[k], pref[k], rtol=REL, atol=0, err_msg=k)
        np.testing.assert_allclose(got["grad_norm"], pref["grad_norm"], rtol=REL)
        np.testing.assert_allclose(got["grad_norm"], jref["grad_norm"], rtol=2e-4)
    after = {k: torch.from_numpy(v) for k, v in s0.items()}
    err = torch.cat([(after[k] - pstate[k]).abs().reshape(-1) for k in after])
    n_over, worst = int((err > 2e-6).sum()), float(err.max())
    print("two DP steps against the one-process port: elements over 2e-6, elements, largest "
          "difference:", (n_over, err.numel(), worst))
    assert n_over <= 1e-4 * err.numel() and worst <= 2e-5, (n_over, err.numel(), worst)

    before = {k: torch.from_numpy(v) for k, v in state.items()}
    print("two DP steps against JAX: elements over 2e-6, elements, largest difference:",
          _param_change(port_model(_pcfg(), s0), before, params, jparams))
    return m0


def test_dataloader_rank_slices_match_jax():
    """Each rank's batches are the JAX DataLoader's with the same arguments
    and seed, and the ranks' rows together are the one-host batch; several
    hosts without fixed buckets raise, as in the JAX package."""
    items = dist_worker.build_items()

    class DS:
        def __len__(self):
            return len(items)

        def __getitem__(self, i):
            return items[i]

        def lengths(self):
            return np.array([it["y"].shape[0] for it in items])

    kw = dict(batch_size=B, seed=37, min_frames=OUT, text_bucket=16, frame_bucket=32)
    whole = list(pbatching.DataLoader(DS(), **kw))
    assert len(whole) == 2
    ranks = []
    for host in (0, 1):
        jl = jbatching.DataLoader(DS(), host_id=host, num_hosts=2, **kw)
        pl = pbatching.DataLoader(DS(), host_id=host, num_hosts=2, **kw)
        jb, pb = list(jl), list(pl)
        assert len(pl) == len(jl) and len(jb) == len(pb) == 2
        for a, b in zip(jb, pb):
            assert a.keys() == b.keys() and b["x"].shape == (B // 2, 16)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        ranks.append(pb)
    for w, r0, r1 in zip(whole, *ranks):
        for k in w:
            np.testing.assert_array_equal(np.concatenate([r0[k], r1[k]]), w[k], err_msg=k)
    with pytest.raises(ValueError, match="fixed text_bucket"):
        pbatching.DataLoader(DS(), B, host_id=1, num_hosts=2)
    with pytest.raises(ValueError, match="must divide"):
        pbatching.DataLoader(DS(), 5, num_hosts=2, text_bucket=16, frame_bucket=32)


def test_dp_step_matches_jax_sharded_step(pool):
    """Two steps on the JAX test's global batches, each rank on its rows:
    the global batch's losses, and the JAX sharded step's parameters."""
    _check_dp(pool, _global_batches())


def test_dp_step_divides_by_the_global_batch_with_unequal_masks(pool):
    """The ranks' masks differ (rank 0: 45 tokens and 64 frames in its
    16-frame segments, rank 1: 21 and 49), so the mean of the ranks' own
    losses, which is what DDP's plain gradient average optimises, is
    another number: at the first step it reads 7.3e-3 relative off the
    global batch's total loss (duration 4.1e-2, prior 4.5e-3, diffusion
    1.2e-3), each over 100 times the tolerance. The step divides by the
    global counts and holds both oracles."""
    batch = _unequal_batch()
    m = _check_dp(pool, [batch, batch])[0]
    model = port_model(_pcfg(), _weights()[2])
    halves = []
    for rows in (slice(0, 4), slice(4, 8)):
        b = {k: torch.from_numpy(v[rows]) for k, v in batch.items()}
        total, parts = plosses.grad_tts_loss(
            model, None, b["x"], b["x_lengths"], b["y"], b["y_lengths"], out_size=OUT,
            pinned=(b["pinned_t"], b["pinned_z"], b["pinned_offsets"]))
        halves.append({"total_loss": float(total.detach()),
                       **{k: float(v.detach()) for k, v in parts.items()}})
    off = {k: abs((halves[0][k] + halves[1][k]) / 2 - m[k]) / abs(m[k]) for k in halves[0]}
    print("the plain mean's relative distance from the global loss:", off)
    assert min(off.values()) > 100 * REL, off


def test_replicate_and_mesh_layout(pool):
    """`replicate` makes every rank's parameters rank 0's; the mesh lays the
    ranks out row-major with one group a row and a column."""
    state = _weights()[2]
    (p0, meshes0), (p1, meshes1) = pool.run(replicate_and_mesh, _pcfg(), state)
    for k in state:
        np.testing.assert_array_equal(p0[k], state[k])
        np.testing.assert_array_equal(p1[k], state[k])
    assert meshes0[0] == ({"data": 0, "model": 0}, {"data": 2, "model": 1},
                          {"data": 2, "model": None})
    assert meshes1[0][0] == {"data": 1, "model": 0}


def test_single_process_defaults():
    """Without a launcher nothing is joined; the rank's device and the
    mesh's default to the card, which this machine lacks: they raise
    instead of running on the CPU. The 1 x 1 mesh keeps the whole batch."""
    assert "WORLD_SIZE" not in os.environ
    assert init_distributed() == HostInfo(0, 1, 1, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_distributed(init_method=f"tcp://localhost:{free_port()}", world_size=1, rank=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.make_mesh()
    assert not torch.distributed.is_initialized()
    mesh = pmesh.make_mesh(device_type="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.device == torch.device("cpu")
    b = _global_batches()[0]
    got = pmesh.shard_batch(mesh, b)
    assert all(torch.equal(got[k], torch.from_numpy(v)) for k, v in b.items())
    assert pmesh.local_slice(mesh, "data", 8) == slice(0, 8)
    two = dataclasses.replace(mesh, shape={"data": 2, "model": 1}, coords={"data": 1, "model": 0})
    assert pmesh.local_slice(two, "data", 8) == slice(4, 8)
    got = pmesh.shard_batch(two, b)
    assert all(torch.equal(got[k], torch.from_numpy(v)[4:]) for k, v in b.items())
    with pytest.raises(ValueError, match="do not split"):
        pmesh.local_slice(two, "data", 7)


def test_cli_train_mesh_under_torchrun(tmp_path):
    """`python -m torch.distributed.run --nproc_per_node=2` of
    `cli.train.main --mesh --device cpu` (through `tests/torch_train_worker.py`,
    which registers a test-width v1 preset) on a seeded phnm3 corpus of
    eight training and four validation utterances, batch 4 (2 a rank): an
    epoch, whose checkpoints rank 0 alone writes; a resume from `grad_1`,
    which gives both ranks the saved weights and Adam's steps; an early stop
    at patience 1 (learning rate 0, so the validation losses repeat), which
    ends both ranks after epoch 2 of 5. The ranks draw other t."""
    train = write_phnm_corpus(tmp_path, 8, 1)
    valid = write_phnm_corpus(tmp_path, 4, 2)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node=2",
           "--master_addr=localhost", f"--master_port={free_port()}",
           str(ROOT / "tests" / "torch_train_worker.py"), str(tmp_path), str(train), str(valid)]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-6000:]
    res = {}
    for line in out.stdout.splitlines():
        if line.startswith("RANK_RESULT "):
            r = json.loads(line[len("RANK_RESULT "):])
            res[r["rank"]] = r
    assert set(res) == {0, 1}, out.stdout[-3000:]
    r0, r1 = res[0], res[1]
    logs = tmp_path / "logs"
    assert {"grad_1", "grad_best", "grad_final"} <= {p.name for p in logs.iterdir()}
    assert r0["saves"] == ["grad_1", "grad_best", "grad_final"] and r1["saves"] == []
    assert r0["steps_per_epoch"] == r1["steps_per_epoch"] == 2
    assert r0["t_first_step"] != r1["t_first_step"] and len(r0["t_first_step"]) == 2
    for r in (r0, r1):
        assert r["resume_start_epoch"] == 2 and r["resumed_weights_equal_grad_1"]
        assert r["resumed_adam_steps"] == [2.0]
        assert r["early_stop_epochs"] == [1, 2]
    assert r0["resumed_digest"] == r1["resumed_digest"]
    assert r0["final_digest"] == r1["final_digest"]
