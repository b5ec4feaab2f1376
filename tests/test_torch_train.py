"""GradTTS training in the PyTorch port (`arttts_tpu_torch/train/`) against
the JAX package's training path, on the CPU at small widths.

Both packages get the same weights (the JAX tree through the weight
bridge), dropout 0.0 on both sides (their random masks cannot match) and
the same pinned draws (t, z, segment offsets). On CPU tensors MAS runs the
plain version, which `tests/test_torch_mas.py` holds bit-exact against the
JAX implementations.

Tolerances: losses atol/rtol 2e-4 (float32, sums in other orders);
gradients max |g_port - g_jax| <= 1e-3 * max |g_jax| + 1e-7 per tensor;
three optimizer steps at lr 1e-4: losses and gradient norms rtol 2e-4, the
parameter change atol 2e-6 (2% of one step) except where Adam turns float
noise into a step (`_param_change`).
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arttts_tpu.core.config import DecoderConfig, EncoderConfig, ModelConfig
from arttts_tpu.data import batching as jbatching
from arttts_tpu.models import diffusion_sde as jdiff
from arttts_tpu.models.tts import GradTTSModel as JGradTTS
from arttts_tpu.ops import shape as jshape
from arttts_tpu.train import losses as jlosses
from arttts_tpu.train.step import create_train_state, make_train_step
from arttts_tpu_torch.core import config as pconfig
from arttts_tpu_torch.data import batching as pbatching
from arttts_tpu_torch.models import diffusion_sde as pdiff
from arttts_tpu_torch.models import layers as players
from arttts_tpu_torch.models.tts import GradTTSModel as PGradTTS
from arttts_tpu_torch.ops import shape as pshape
from arttts_tpu_torch.train import losses as plosses
from arttts_tpu_torch.train.step import eval_step, make_optimizer, train_step
from arttts_tpu_torch.train.trainer import Trainer
from arttts_tpu_torch.utils.from_jax import adam_state_from_jax, grad_tts_state_dict

N_FEATS = 16
B, T_X, T_Y, OUT = 2, 12, 48, 16
X_LENS, Y_LENS = (12, 9), (48, 37)
LR = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: under the suite's six
    workers torch's default of a thread a core oversubscribes the cores
    (`tests/test_torch_cli.py`); the trainer test took 149 s there against
    5.5 s alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(dropout=0.0, prenet_dropout=0.0):
    return ModelConfig(
        name="grad_tts", n_feats=N_FEATS,
        encoder=EncoderConfig(kind="text", n_vocab=149, n_channels=32, filter_channels=64,
                              filter_channels_dp=32, n_heads=2, n_layers=2, dropout=dropout,
                              prenet_dropout=prenet_dropout),
        decoder=DecoderConfig(dim=16),
    )


def _pcfg(j):
    d = dataclasses.asdict(j)
    return pconfig.ModelConfig(**{**d, "encoder": pconfig.EncoderConfig(**d["encoder"]),
                                  "decoder": pconfig.DecoderConfig(**d["decoder"])})


_CACHE = {}


def _jax_model():
    """The JAX model and its random parameters, with small distinct Rezero
    gains (they start at 0, which would silence every attention site and
    its gradients)."""
    if "jax" not in _CACHE:
        jm = JGradTTS(config=_jcfg())
        variables = jax.jit(jm.init)(
            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
            jnp.ones((1, T_X), jnp.int32), jnp.full((1,), T_X, jnp.int32),
            jnp.zeros((1, T_Y, N_FEATS)), jnp.ones((1, T_Y, 1)), jnp.zeros((1,)))
        params = jax.tree_util.tree_map(np.asarray, variables["params"])
        est = params["estimator"]
        for k in range(sum(1 for n in est if n.startswith("Rezero_"))):
            est[f"Rezero_{k}"]["g"] = np.full((1,), (0.03 + 0.01 * k) * (-1) ** k, np.float32)
        _CACHE["jax"] = (jm, params)
    return _CACHE["jax"]


def _port_model(params):
    pm = PGradTTS(_pcfg(_jcfg()))
    pm.load_state_dict(grad_tts_state_dict(params))
    return pm.train()


def _batch(seed):
    """A numpy batch with pinned draws: x (B, T_X) ids, y (B, T_Y, F),
    t (B,), z (B, OUT, F), offsets (B,)."""
    g = np.random.default_rng(seed)
    x = g.integers(1, 149, size=(B, T_X)).astype(np.int32)
    y = g.standard_normal((B, T_Y, N_FEATS)).astype(np.float32)
    for i in range(B):
        x[i, X_LENS[i]:] = 0
        y[i, Y_LENS[i]:] = 0.0
    return dict(
        x=x, x_lengths=np.asarray(X_LENS, np.int32), y=y, y_lengths=np.asarray(Y_LENS, np.int32),
        pinned_t=(0.05 + 0.9 * g.random(B)).astype(np.float32),
        pinned_z=g.standard_normal((B, OUT, N_FEATS)).astype(np.float32),
        pinned_offsets=(g.random(B) * np.maximum(np.asarray(Y_LENS) - OUT, 1)).astype(np.int32),
    )


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _pinned(b, to):
    return tuple(to(b[k]) for k in ("pinned_t", "pinned_z", "pinned_offsets"))


def _close(got, ref, atol=2e-4, rtol=2e-4, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), atol=atol, rtol=rtol, err_msg=msg)


def test_loss_helpers_match_jax():
    rng = np.random.default_rng(5)
    t_x, t_y, C = 7, 40, N_FEATS
    mu_x = rng.standard_normal((B, t_x, C)).astype(np.float32)
    y = rng.standard_normal((B, t_y, C)).astype(np.float32)
    x_mask = (np.arange(t_x)[None] < np.array([[7], [5]])).astype(np.float32)[..., None]
    y_lens = np.array([40, 29], np.int32)
    y_mask = (np.arange(t_y)[None] < y_lens[:, None]).astype(np.float32)[..., None]
    J, P = jnp.asarray, torch.from_numpy

    for a, b in zip(plosses.mas_log_prior(P(mu_x), P(y), P(x_mask), P(y_mask)),
                    jlosses.mas_log_prior(J(mu_x), J(y), J(x_mask), J(y_mask))):
        _close(a, b)
    attn = (rng.random((B, t_x, t_y)) < 0.3).astype(np.float32)
    off = np.array([30, 3], np.int32)  # 30 > 40 - 16: clamped, as dynamic_slice does
    for a, b in zip(plosses.cut_segments(None, P(y), P(attn), P(y_lens), OUT, offsets=P(off)),
                    jlosses.cut_segments(None, J(y), J(attn), J(y_lens), OUT, offsets=J(off))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    mu_y = rng.standard_normal((B, OUT, C)).astype(np.float32)
    m = y_mask[:, :OUT]
    _close(plosses.prior_loss_fn(P(y[:, :OUT]), P(mu_y), P(m), C),
           jlosses.prior_loss_fn(J(y[:, :OUT]), J(mu_y), J(m), C))
    logw, logw_hat = (rng.standard_normal((B, t_x, 1)).astype(np.float32) for _ in range(2))
    _close(pshape.duration_loss(P(logw), P(logw_hat), P(np.array([7, 5], np.int32))),
           jshape.duration_loss(J(logw), J(logw_hat), J(np.array([7, 5], np.int32))))
    t = np.array([0.3, 0.8], np.float32)
    z = rng.standard_normal((B, OUT, C)).astype(np.float32)
    for a, b in zip(pdiff.forward_diffusion(None, P(y[:, :OUT]), P(m), P(mu_y), P(t), 0.05, 20.0,
                                            z=P(z)),
                    jdiff.forward_diffusion(None, J(y[:, :OUT]), J(m), J(mu_y), J(t), 0.05, 20.0,
                                            z=J(z))):
        _close(a, b)
    est = rng.standard_normal((B, OUT, C)).astype(np.float32)
    _close(pdiff.diffusion_loss_from_estimate(P(est), P(z), P(m), P(t), C, 0.05, 20.0),
           jdiff.diffusion_loss_from_estimate(J(est), J(z), J(m), J(t), C, 0.05, 20.0))
    # the draws: t within its clamp, z of the asked shape, from the generator
    g = torch.Generator().manual_seed(0)
    ts = pdiff.sample_t(g, 1000)
    assert ts.min() >= 1e-5 and ts.max() <= 1 - 1e-5 and abs(float(ts.mean()) - 0.5) < 0.05


def _jax_loss_and_grads(params, b):
    jm, _ = _jax_model()

    def loss_of(p):
        return jlosses.grad_tts_loss(
            jm, {"params": p}, jax.random.PRNGKey(0), jnp.asarray(b["x"]),
            jnp.asarray(b["x_lengths"]), jnp.asarray(b["y"]), jnp.asarray(b["y_lengths"]),
            out_size=OUT, train=True, pinned=_pinned(b, jnp.asarray))

    (total, parts), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(params)
    return float(total), {k: float(v) for k, v in parts.items()}, grads


def _loss_and_grads():
    if "grads" not in _CACHE:
        _, params = _jax_model()
        b = _batch(1)
        jt, jparts, jgrads = _jax_loss_and_grads(params, b)
        pm = _port_model(params)
        tb = _torch_batch(b)
        total, parts = plosses.grad_tts_loss(pm, None, tb["x"], tb["x_lengths"], tb["y"],
                                             tb["y_lengths"], out_size=OUT,
                                             pinned=_pinned(tb, lambda v: v))
        total.backward()
        _CACHE["grads"] = (jt, jparts, jgrads, pm, float(total.detach()),
                           {k: float(v) for k, v in parts.items()})
    return _CACHE["grads"]


def test_grad_tts_loss_matches_jax():
    jt, jparts, _, _, pt, pparts = _loss_and_grads()
    assert pparts.keys() == jparts.keys() == {"dur_loss", "prior_loss", "diff_loss"}
    for k in jparts:
        _close(pparts[k], jparts[k], msg=k)
    _close(pt, jt)


def test_gradients_match_jax():
    """Every parameter's gradient against `jax.grad` of the same loss. The
    duration predictor sees detached features in both packages: without
    the detach the transformer's gradients take the duration loss too."""
    _, _, jgrads, pm, _, _ = _loss_and_grads()
    ref = grad_tts_state_dict(jgrads)
    worst = (0.0, "")
    for name, p in pm.named_parameters():
        g, r = p.grad.numpy(), ref[name].numpy()
        err, scale = float(np.abs(g - r).max()), float(np.abs(r).max())
        assert err <= 1e-3 * scale + 1e-7, (name, err, scale)
        worst = max(worst, (err / (1e-3 * scale + 1e-7), name))
    print(f"largest share of the gradient tolerance used: {worst[0]:.3g} ({worst[1]})")


def _jax_trajectory():
    """Three JAX steps from the shared weights, with the states after each."""
    if "traj" not in _CACHE:
        jm, params = _jax_model()
        state = create_train_state(jm, {"params": params}, LR)
        step = make_train_step(jm, out_size=OUT, donate=False)
        states, metrics = [state], []
        for s in range(3):
            batch = {k: jnp.asarray(v) for k, v in _batch(10 + s).items()}
            state, m = step(state, jax.random.PRNGKey(0), batch)
            states.append(state)
            metrics.append({k: float(v) for k, v in m.items()})
        _CACHE["traj"] = (states, metrics)
    return _CACHE["traj"]


def _param_change(pm, before, jax_before, jax_after):
    """The parameter change against the JAX package's, element by element,
    at atol 2e-6 (2% of one step at lr 1e-4). Adam divides each element's
    gradient by its own magnitude, so where a gradient lies at float noise
    (about 1e-8, Adam's eps; the attention key biases, whose gradient is
    zero in exact arithmetic, and single conv taps) the update is set by
    that noise: up to 1e-4 of the elements may then differ by up to 2e-5.
    Returns (elements over 2e-6, elements, largest difference)."""
    after = pm.state_dict()
    j0, j1 = grad_tts_state_dict(jax_before), grad_tts_state_dict(jax_after)
    n_over = n_all = 0
    worst = 0.0
    for name in before:
        err = ((after[name] - before[name]) - (j1[name] - j0[name])).abs()
        n_over += int((err > 2e-6).sum())
        n_all += err.numel()
        worst = max(worst, float(err.max()))
    assert n_over <= 1e-4 * n_all and worst <= 2e-5, (n_over, n_all, worst)
    return n_over, n_all, worst


def _check_step_metrics(m, jm):
    for k in ("total_loss", "grad_norm", "dur_loss", "prior_loss", "diff_loss"):
        _close(float(m[k]), jm[k], atol=0, rtol=2e-4, msg=k)


def test_three_steps_match_make_train_step():
    states, jmetrics = _jax_trajectory()
    _, params = _jax_model()
    pm = _port_model(params)
    opt = make_optimizer(pm, LR)
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    for s in range(3):
        m = train_step(pm, opt, _torch_batch(_batch(10 + s)), None, OUT)
        _check_step_metrics(m, jmetrics[s])
    print("three steps: elements over 2e-6, elements, largest difference:",
          _param_change(pm, before, states[0].params, states[3].params))


def test_adam_state_bridge_continues_a_jax_run():
    """Two JAX steps, then the params and the optax state bridged into the
    port: the port's third step is the JAX package's third step."""
    states, jmetrics = _jax_trajectory()
    pm = _port_model(jax.tree_util.tree_map(np.asarray, states[2].params))
    opt = make_optimizer(pm, LR)
    opt.load_state_dict(adam_state_from_jax(states[2].opt_state, pm, LR))
    assert all(float(opt.state[p]["step"]) == 2.0 for p in pm.parameters())
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    m = train_step(pm, opt, _torch_batch(_batch(12)), None, OUT)
    _check_step_metrics(m, jmetrics[2])
    print("bridged third step: elements over 2e-6, elements, largest difference:",
          _param_change(pm, before, states[2].params, states[3].params))


class _Synthetic:
    """In-memory dataset of symbol ids (T_x,) and mel frames (T_y, N_FEATS)."""

    def __init__(self, n, seed=0):
        g = np.random.default_rng(seed)
        self.items = []
        for _ in range(n):
            t_x = int(g.integers(5, 12))
            t_y = int(t_x * g.uniform(2.5, 4.5))
            self.items.append({"x": g.integers(1, 149, size=t_x).astype(np.int32),
                               "y": g.standard_normal((t_y, N_FEATS)).astype(np.float32)})

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    def lengths(self):
        return np.array([len(it["y"]) for it in self.items])


def test_dataloader_matches_jax():
    ds = _Synthetic(23, seed=4)
    for kw in (dict(batch_size=4, seed=7, min_frames=OUT), dict(batch_size=3, shuffle=False)):
        jl, pl = jbatching.DataLoader(ds, **kw), pbatching.DataLoader(ds, **kw)
        assert len(jl) == len(pl)
        for epoch in (1, 2):
            jl.set_epoch(epoch)
            pl.set_epoch(epoch)
            jb, pb = list(jl), list(pl)
            assert len(jb) == len(pb) > 0
            for a, b in zip(jb, pb):
                assert a.keys() == b.keys()
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                    assert a[k].dtype == b[k].dtype, k
    # several hosts need fixed pad buckets, in both packages
    with pytest.raises(ValueError, match="fixed text_bucket"):
        pbatching.DataLoader(ds, 4, num_hosts=2)
    with pytest.raises(ValueError, match="fixed text_bucket"):
        jbatching.DataLoader(ds, 4, num_hosts=2)
    # a consumer that stops early frees the prefetch thread
    threads = threading.active_count()
    it = iter(pbatching.DataLoader(ds, 2, prefetch=1))
    next(it)
    it.close()
    assert threading.active_count() == threads


def _encoder(dropout, prenet_dropout):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return PGradTTS(_pcfg(_jcfg(dropout, prenet_dropout))).encoder


def test_dropout_only_in_training_and_from_the_generator():
    x = torch.from_numpy(_batch(2)["x"])
    lens = torch.tensor(X_LENS, dtype=torch.int32)
    enc = _encoder(0.1, 0.5).eval()
    plain = _encoder(0.0, 0.0).eval()
    g = torch.Generator().manual_seed(3)
    state = g.get_state()
    ev = enc(x, lens, g)
    assert torch.equal(g.get_state(), state)  # eval mode draws nothing
    for a, b in zip(ev, plain(x, lens)):
        assert torch.equal(a, b)  # bit-identical to the encoder without dropout
    for a, b in zip(plain.train()(x, lens, g), ev):
        assert torch.equal(a, b)  # training mode at p = 0 equals eval
    enc.train()
    with pytest.raises(ValueError, match="Generator"):
        enc(x, lens)
    one = enc(x, lens, torch.Generator().manual_seed(1))[0]
    again = enc(x, lens, torch.Generator().manual_seed(1))[0]
    other = enc(x, lens, torch.Generator().manual_seed(2))[0]
    assert torch.equal(one, again) and not torch.equal(one, other)
    assert not torch.allclose(one, ev[0])


def test_dropout_sits_where_the_jax_encoder_has_it(monkeypatch):
    """The port draws dropout at the JAX positions, in the same order, with
    the same rates: (number of elements, rate) of every call."""
    import flax.linen as nn

    b = _batch(3)
    jm = JGradTTS(config=_jcfg(0.1, 0.5))  # the same parameters as at rate 0
    # built (and cached) before the interception: its `init` calls the
    # encoder's dropout layers too, and they are not the calls counted here
    params = _jax_model()[1]
    jcalls = []

    def intercept(next_fun, args, kwargs, context):
        if isinstance(context.module, nn.Dropout) and context.method_name == "__call__":
            jcalls.append((int(np.prod(args[0].shape)), context.module.rate))
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(intercept):  # records while the encoder traces
        jax.jit(lambda p, x, xl: jm.apply({"params": p}, x, xl, deterministic=False,
                                          method="encode", rngs={"dropout": jax.random.PRNGKey(2)})
                )(params, jnp.asarray(b["x"]), jnp.asarray(b["x_lengths"]))
    pcalls = []
    real = players.dropout

    def record(x, p, training, generator):
        if training:
            pcalls.append((x.numel(), p))
        return real(x, p, training, generator)

    monkeypatch.setattr(players, "dropout", record)
    enc = _encoder(0.1, 0.5).train()
    enc(torch.from_numpy(b["x"]), torch.from_numpy(b["x_lengths"]), torch.Generator())
    assert len(jcalls) == 3 + 4 * 2 + 2
    assert pcalls == jcalls


def test_trainer_fit_resume_and_eval(tmp_path):
    """Two epochs on an in-memory dataset: finite losses, the JAX file
    policy, and a resume at epoch 3 with Adam's step count restored."""
    model = _pcfg(_jcfg())
    train = pconfig.TrainConfig(log_dir=str(tmp_path / "logs"), n_epochs=2, batch_size=2,
                                save_every=2, val_every=2, out_size=OUT)
    cfg = pconfig.ExperimentConfig("tiny", model, pconfig.DataConfig(), train)
    ds, valid = _Synthetic(6, seed=1), _Synthetic(2, seed=2)
    trainer = Trainer(cfg, ds, valid_dataset=valid, device="cpu")
    first = [p.detach().clone() for p in trainer.model.parameters()]
    metrics = trainer.fit(n_epochs=2)
    assert {"total_loss", "grad_norm", "dur_loss"} <= metrics.keys()
    assert all(np.isfinite(v) for v in metrics.values())
    assert any(not torch.equal(a, p) for a, p in zip(first, trainer.model.parameters()))
    logs = tmp_path / "logs"
    for name in ("grad_2", "grad_final"):
        assert (logs / name / "state.pt").exists() and (logs / name / "meta.json").exists()
    assert (logs / "val.log").read_text().startswith("2\t")

    trainer2 = Trainer(cfg, ds, valid_dataset=valid, device="cpu")
    assert trainer2.resume() == 3
    steps = {float(s["step"]) for s in trainer2.optimizer.state.values()}
    assert steps == {2.0 * len(trainer.train_loader)}
    for a, b in zip(trainer.model.state_dict().values(), trainer2.model.state_dict().values()):
        assert torch.equal(a, b)
    # validation: the encoder deterministic, no gradient, the mode restored
    vb = {k: torch.from_numpy(v) for k, v in next(iter(trainer2.valid_loader)).items()}
    m = eval_step(trainer2.model, vb, torch.Generator().manual_seed(0))
    assert trainer2.model.training and all(not v.requires_grad for v in m.values())
    assert np.isfinite(float(m["total_loss"]))

    # steps_per_dispatch > 1: every batch still takes one step, in turn
    cfg2 = dataclasses.replace(cfg, train=dataclasses.replace(train, steps_per_dispatch=2))
    trainer3 = Trainer(cfg2, ds, device="cpu")
    trainer3.train_epoch(1)
    steps = {float(s["step"]) for s in trainer3.optimizer.state.values()}
    assert steps == {float(len(trainer3.train_loader))}


def test_loss_for_model_maps_each_family_as_jax():
    """Every preset's model family takes the loss the JAX package gives it:
    `grad_ttartic_loss` for GradTTArtic (v6, v6_zhCN, msml1h),
    `grad_tts_loss` for the rest."""
    from arttts_tpu.core import config as jconfig

    jconfig.get_preset("v1")  # builds the JAX package's preset table
    names = set()
    for preset, cfg in jconfig.PRESETS.items():
        assert pconfig.get_preset(preset).model.name == cfg.model.name, preset
        names.add(cfg.model.name)
    assert {"grad_tts", "art_tts", "attention_tts", "attention_tts_preblock",
            "grad_ttartic"} <= names
    for name in names:
        want = jlosses.loss_for_model(name).__name__
        assert plosses.loss_for_model(name) is getattr(plosses, want), name
    assert plosses.loss_for_model("grad_ttartic") is plosses.grad_ttartic_loss
