"""Tensor parallelism in the PyTorch port (`arttts_tpu_torch/parallel/tp.py`:
`tp_sharding`, `shard_tp`; `train_step` on a sharded model; `Trainer` on
a mesh with a "model" axis over 1) against the JAX package's
(`arttts_tpu/parallel/tp.py`, `tests/test_tp.py`), on the CPU over gloo.

Rule: the port shards exactly the parameters whose JAX leaves the JAX
rule shards, matched through the weight bridge (`utils/from_jax.py`), and
rank m stores the m-th of n equal slices of each.

Steps: the model, weights and batches of `tests/test_torch_parallel.py`
(n_feats 16, U-Net dim 16, two encoder layers, global batch 8, pinned
draws, dropout 0) on four gloo ranks (one torch thread each, spawned once
for the file). Oracles: the JAX `make_train_step(mesh=...)` on
`shard_tp(make_mesh(2, 2), state)` over 4 virtual devices and the port's
one-process step. Tolerances: the loss parts within 1e-5 relative of both;
`grad_norm` within 1e-5 relative of the port's one-process step and
within the DP test's 2e-4 of JAX's; the parameters after two steps within
`tests/test_torch_train.py`'s band against both.
"""

import copy
import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arttts_tpu.models.tts import GradTTSModel as JGradTTS
from arttts_tpu.parallel import mesh as jmesh
from arttts_tpu.parallel import tp as jtp
from arttts_tpu.train.step import create_train_state, make_train_step
from arttts_tpu.utils.torch_convert_utmos import convert_wav2vec2
from arttts_tpu_torch.core import config as pconfig
from arttts_tpu_torch.models.tts import GradTTSModel as PGradTTS
from arttts_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Encoder
from arttts_tpu_torch.parallel.mesh import Mesh
from arttts_tpu_torch.parallel.tp import shard_tp, tp_sharding
from arttts_tpu_torch.utils.from_jax import (grad_ttartic_state_dict, grad_tts_state_dict,
                                             wav2vec2_state_dict)
from tests import dist_worker
from tests.test_model import tiny_config
from tests.test_torch_parallel import LR, OUT, REL, _global_batches, _pcfg, _weights
from tests.test_torch_parallel import _port_steps as _port_steps_uncached
from tests.test_torch_train import _param_change
from tests.torch_dist_pool import (RankPool, lockstep_step, port_model, tp_steps,
                                  trainer_epoch)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs (`tests/test_torch_cli.py`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def pool():
    """The four gloo ranks, spawned as the file starts: they reach their
    group while the rule's tests run."""
    p = RankPool(4)
    yield p
    p.close()


@pytest.fixture(autouse=True, scope="module")
def jax_tp_steps():
    """The JAX sharded step's two steps, compiled and run on a thread from
    the file's start (XLA's compile, ~25 s, is the file's longest part).
    The shared weights are made here first: their seeded draw must not
    meet the rule's tests' seeding of torch's global generator."""
    _weights()
    with ThreadPoolExecutor(1) as ex:
        yield ex.submit(_jax_tp_steps, _global_batches())


def _mesh(n_model, m=0):
    """A 1 x n_model mesh at model coordinate m, without a process group
    (enough for the rule and the slicing)."""
    return Mesh(shape={"data": 1, "model": n_model}, coords={"data": 0, "model": m},
                groups={"data": None, "model": None}, device=torch.device("cpu"))


def _port_cfg(jcfg):
    d = dataclasses.asdict(jcfg)
    return pconfig.ModelConfig(**{**d, "encoder": pconfig.EncoderConfig(**d["encoder"]),
                                  "decoder": pconfig.DecoderConfig(**d["decoder"])})


def _jax_sharded_names(params, to_state_dict, n_model):
    """The port's names of the parameters whose JAX leaves the JAX rule
    shards at `n_model`: each leaf marked 1 (sharded) or 0, through the
    weight bridge."""
    mesh = jmesh.make_mesh(n_data=8 // n_model, n_model=n_model)
    shardings = jtp.tp_sharding(mesh, params)
    marks = jax.tree_util.tree_map(
        lambda x, s: np.full(np.shape(x), float("model" in s.spec), np.float32), params, shardings)
    sd = to_state_dict(marks)
    assert all(bool((v == v.reshape(-1)[0]).all()) for v in sd.values() if v.numel())
    return {k for k, v in sd.items() if v.numel() and float(v.reshape(-1)[0]) == 1.0}


@functools.lru_cache(maxsize=None)
def _jax_param_shapes(jcfg):
    """The JAX GradTTS model's parameter shapes (`jax.eval_shape` of its
    init: the rule reads shapes only); GradTTArtic's with its speaker
    pre-embedding."""
    B, T_x, T_y = 2, 8, 32
    key = jax.random.PRNGKey(0)
    x = (jnp.ones((B, T_x), jnp.int32) if jcfg.encoder.kind == "text"
         else jnp.zeros((B, T_x, jcfg.encoder.n_input_feats)))
    spk = jnp.zeros((B, jcfg.spk_preemb_dim)) if jcfg.name == "grad_ttartic" else None
    args = (x, jnp.full((B,), T_x, jnp.int32), jnp.zeros((B, T_y, jcfg.n_feats)),
            jnp.ones((B, T_y, 1)), jnp.zeros((B,)), spk)
    return jax.eval_shape(lambda: JGradTTS(config=jcfg).init(
        {"params": key, "dropout": key}, *args))["params"]


def _tts_case(jcfg):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        to_state_dict = (grad_ttartic_state_dict if jcfg.name == "grad_ttartic"
                         else grad_tts_state_dict)
        return PGradTTS(_port_cfg(jcfg)), _jax_param_shapes(jcfg), to_state_dict


def _artic_config():
    """`tests/test_torch_artic_model.py`'s GradTTArtic (v6's shape: 26
    trait inputs, two speakers, the speaker encoder and MLP, no duration
    predictor) at U-Net dim 16."""
    c = tiny_config()
    return dataclasses.replace(
        c, name="grad_ttartic", n_spks=2,
        encoder=dataclasses.replace(c.encoder, n_input_feats=26, n_heads=2,
                                    use_duration_predictor=False))


def _wav2vec2_case(_):
    """`tests/test_utmos.py`'s small wav2vec2 (2 heads of 12), its JAX tree
    from the JAX package's converter."""
    cfg = Wav2Vec2Config(conv_layers=((32, 10, 5), (32, 3, 2), (32, 2, 2)), hidden_dim=24,
                         num_layers=2, num_heads=2, ffn_dim=48, pos_conv_kernel=16,
                         pos_conv_groups=2)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        pm = Wav2Vec2Encoder(cfg)
    params = convert_wav2vec2(pm.state_dict(), cfg.num_layers, cfg.num_heads, "fairseq")
    return pm, params, wav2vec2_state_dict


@pytest.mark.parametrize("case, jcfg, n_model", [
    (_tts_case, tiny_config(), 2),
    (_tts_case, tiny_config(), 4),
    (_tts_case, tiny_config("text", "unet1d"), 2),
    (_tts_case, _artic_config(), 2),
    (_wav2vec2_case, None, 2),
], ids=["tiny-n2", "tiny-n4", "text-unet1d-n2", "grad-ttartic-n2", "wav2vec2-mha-n2"])
def test_rule_shards_the_jax_rules_parameters(case, jcfg, n_model):
    """The port's sharded set equals the JAX rule's (the tiny model's
    ConvTranspose weights on their kernel width at n 2 and not at 4; the
    MHA projections on their head dim); rank m stores the m-th slice of
    each parameter and of an existing Adam's moments, and the slices make
    the whole tensors."""
    model, params, to_state_dict = case(jcfg)
    want = _jax_sharded_names(params, to_state_dict, n_model)
    layout = tp_sharding(_mesh(n_model), model)
    got = {k for k, d in layout.items() if d is not None}
    assert got == want, (sorted(got - want), sorted(want - got))
    assert len(got) > 10
    assert set(layout) == {k for k, _ in model.named_parameters()}
    # an Adam with state: its moments are cut with the parameters
    opt = torch.optim.Adam(model.parameters())
    for i, p in enumerate(model.parameters()):
        p.grad = torch.full_like(p, 0.1 * (i + 1))
    opt.step()
    full = {k: v.clone() for k, v in model.state_dict().items()}
    moments = {k: opt.state[p]["exp_avg_sq"].clone() for k, p in model.named_parameters()}
    shards = []
    for m in range(n_model):
        copied, copied_opt = copy.deepcopy((model, opt))
        sharded = shard_tp(_mesh(n_model, m), copied, copied_opt)
        stored = {n.replace("parametrizations.", "").replace(".original", ""): p
                  for n, p in sharded.named_parameters()}
        assert set(stored) == set(layout)
        for k, d in layout.items():
            shape = list(full[k].shape)
            if d is not None:
                shape[d] //= n_model
            assert list(stored[k].shape) == shape, k
            state = copied_opt.state[stored[k]]
            assert list(state["exp_avg"].shape) == list(state["exp_avg_sq"].shape) == shape, k
        shards.append({k: (p, copied_opt.state[p]["exp_avg_sq"]) for k, p in stored.items()})
    for k, d in layout.items():
        if d is not None:
            for i, want in enumerate((full[k], moments[k])):
                assert torch.equal(torch.cat([s[k][i] for s in shards], dim=d), want), k
    mod, _, name = next(k for k, d in layout.items() if d is not None).rpartition(".")
    with pytest.raises(RuntimeError, match="outside `gathered"):
        getattr(sharded.get_submodule(mod), name)


def _jax_tp_steps(batches):
    """`make_train_step(mesh=...)` on `shard_tp(make_mesh(2, 2), state)`
    over the first 4 virtual devices, from the shared weights, compiled
    once at XLA's backend (LLVM) optimisation level 0: the same program, 6
    s less to compile. The step leaves the state model-sharded but in a
    layout of GSPMD's choosing (the biases too), so each step's state is
    put back in `shard_tp`'s layout: the same values, and the one compiled
    program for both steps."""
    jm, params, _ = _weights()
    mesh = jmesh.make_mesh(n_data=2, n_model=2, devices=jax.devices()[:4])
    state = jtp.shard_tp(mesh, create_train_state(jm, {"params": params}, LR))
    key = jax.random.PRNGKey(0)
    sharded = [jmesh.shard_batch(mesh, b) for b in batches]
    step = make_train_step(jm, out_size=OUT, mesh=mesh, donate=False).lower(
        state, key, sharded[0]).compile(compiler_options={"xla_backend_optimization_level": 0})
    metrics = []
    for b in sharded:
        state, m = step(state, key, b)
        metrics.append({k: float(v) for k, v in m.items()})
        assert any("model" in leaf.sharding.spec for leaf in jax.tree_util.tree_leaves(state.params))
        state = jtp.shard_tp(mesh, state)
    return metrics, jax.tree_util.tree_map(np.asarray, state.params)


@functools.lru_cache(maxsize=None)
def _port_steps(n_steps):
    """The port's one-process steps on the first `n_steps` global batches."""
    return _port_steps_uncached(_global_batches()[:n_steps])


def _check_band(got, ref, label):
    err = torch.cat([(torch.from_numpy(got[k]) - ref[k]).abs().reshape(-1) for k in ref])
    n_over, worst = int((err > 2e-6).sum()), float(err.max())
    print(f"{label}: elements over 2e-6, elements, largest difference:",
          (n_over, err.numel(), worst))
    assert n_over <= 1e-4 * err.numel() and worst <= 2e-5, (n_over, err.numel(), worst)


def test_tp_step_matches_jax_shard_tp_step(pool, jax_tp_steps):
    """A 2 x 2 data x model mesh: two steps of `train_step` on a sharded
    model (DDP over each "data" column) against the JAX sharded step and
    the port's one-process step; the parameters and both Adam moments stay
    at the shard's size; the gathered parameters are the same bits on all
    four ranks; two all-reduces of the model row a step (the gather, and
    the gradients' squares with the replicated gradients)."""
    _, params, state = _weights()
    batches = _global_batches()
    res = pool.run(tp_steps, _pcfg(), state, batches, OUT, LR, 2, 2)
    pmetrics, pstate = _port_steps(len(batches))
    jmetrics, jparams = jax_tp_steps.result()
    m0, g0, layout, stored, comm = res[0]
    for m, g, _, _, c in res[1:]:
        assert m == m0 and c == comm
        for k in g0:
            np.testing.assert_array_equal(g[k], g0[k], err_msg=k)
    for got, jref, pref in zip(m0, jmetrics, pmetrics):
        for k in ("total_loss", "dur_loss", "prior_loss", "diff_loss"):
            np.testing.assert_allclose(got[k], jref[k], rtol=REL, atol=0, err_msg=k)
            np.testing.assert_allclose(got[k], pref[k], rtol=REL, atol=0, err_msg=k)
        np.testing.assert_allclose(got["grad_norm"], pref["grad_norm"], rtol=REL)
        np.testing.assert_allclose(got["grad_norm"], jref["grad_norm"], rtol=2e-4)
    sharded = [k for k, d in layout.items() if d is not None]
    assert len(sharded) > 10
    for k, d in layout.items():
        shape = list(state[k].shape)
        if d is not None:
            shape[d] //= 2
        assert [list(s) for s in stored[k]] == [shape] * 3, k
    assert comm[0] == 2 * len(batches)
    _check_band(g0, pstate, "two TP steps against the one-process port")
    before = {k: torch.from_numpy(v) for k, v in state.items()}
    print("two TP steps against JAX's shard_tp step: elements over 2e-6, elements, largest "
          "difference:", _param_change(port_model(_pcfg(), g0), before, params, jparams))


def test_tp_composes_with_dp_replicated_state(pool):
    """A 4 x 1 mesh: `shard_tp` shards nothing (the JAX rule at a model
    axis of 1), and the same `train_step` is plain DP over 4 ranks."""
    _, _, state = _weights()
    batches = _global_batches()
    res = pool.run(tp_steps, _pcfg(), state, batches, OUT, LR, 4, 1)
    pmetrics, pstate = _port_steps(len(batches))
    m0, g0, layout, stored, comm = res[0]
    assert comm is None and all(d is None for d in layout.values())
    assert all(s[0] == s[1] == s[2] == state[k].shape for k, s in stored.items())
    for m, g, *_ in res[1:]:
        assert m == m0
        for k in g0:
            np.testing.assert_array_equal(g[k], g0[k], err_msg=k)
    for got, pref in zip(m0, pmetrics):
        assert np.isfinite(got["total_loss"])
        for k in ("total_loss", "dur_loss", "prior_loss", "diff_loss", "grad_norm"):
            np.testing.assert_allclose(got[k], pref[k], rtol=REL, atol=0, err_msg=k)
    _check_band(g0, pstate, "two DP steps over 4 ranks against the one-process port")


def test_trainer_on_a_mesh_with_a_model_axis(pool, tmp_path):
    """`Trainer` on a 2 x 2 mesh, where it raised before: the state is
    replicated over the "model" axis, so the four ranks end bit for bit
    equal, and equal to a 2 x 1 run's (the ranks of a model row batch the
    same rows with the same generator); the mesh's rank (0, 0) alone writes
    the checkpoints; a resume gives every rank the saved weights and Adam
    state."""
    items = dist_worker.build_items()
    base = pconfig.ExperimentConfig()
    exp = dataclasses.replace(
        base, model=_pcfg(),
        data=dataclasses.replace(base.data, max_text_len=dist_worker.TEXT_BUCKET,
                                 max_frame_len=dist_worker.FRAME_BUCKET),
        train=dataclasses.replace(base.train, batch_size=dist_worker.BATCH_SIZE, out_size=OUT,
                                  save_every=1, val_every=1, test_size=1))
    tp = pool.run(trainer_epoch, exp, items, tmp_path / "tp", 2, 2)
    dp = pool.run(trainer_epoch, exp, items, tmp_path / "dp", 2, 1)
    assert dp[2] is None and dp[3] is None
    digests = {r["digest"] for r in tp + dp[:2]}
    assert len(digests) == 1, [r["digest"][:8] for r in tp + dp[:2]]
    assert [r["is_main"] for r in tp] == [True, False, False, False]
    assert tp[0]["saves"] == ["grad_1", "grad_best", "grad_final"]
    assert all(r["saves"] == [] for r in tp[1:])
    assert {"grad_1", "grad_best", "grad_final"} <= set(tp[0]["files"])
    assert [r["rows"] for r in tp] == [[0, 4], [0, 4], [4, 8], [4, 8]]
    assert all(r["ddp"] for r in tp)
    for r in tp:
        assert r["start"] == 2 and r["resumed_digest"] == r["digest"]


def test_replicated_row_takes_its_first_ranks_gradients(pool):
    """`replicate_tp` over a 1 x 4 mesh: the ranks' batches differ (each
    rank's pinned t moved by 0.01 times its model coordinate), as their
    backward's bits may on the card; after a step every rank holds rank
    0's parameters, the bits of the one-process step on rank 0's batch, in
    one all-reduce of the whole gradient."""
    _, _, state = _weights()
    batch = _global_batches()[0]
    res = pool.run(lockstep_step, _pcfg(), state, batch, OUT, LR)
    _, pstate = _port_steps(1)
    losses = [r[0] for r in res]
    assert len(set(losses)) == 4  # the ranks computed other losses ...
    for _, params, comm in res:  # ... and took rank 0's step
        assert comm == (1, 4 * (sum(v.size for v in state.values()) + 3))
        for k in pstate:
            np.testing.assert_array_equal(params[k], pstate[k].numpy(), err_msg=k)
