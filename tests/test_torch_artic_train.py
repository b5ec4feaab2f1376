"""Training of the multi-speaker articulatory model (GradTTArtic: v6,
v6_zhCN, msml1h) in the PyTorch port against the JAX package's, on the CPU
at small widths; and the batching it needs: trait items with speaker
inputs and durations, language upsampling, the length-grouped samplers.

The model is v6's shape at small encoder widths (26 trait inputs, the 64-d
speaker embedding concatenated, two heads, no duration predictor; a 1024-d
speaker pre-embedding; the 2D U-Net at dim 16 on its module path). The
port model is seeded and carried to JAX by the JAX package's converter;
the weights and the optax state come back through `utils/from_jax.py`.
Dropout is 0.0 on both sides and both get the same pinned draws. The
alignment is the durations' path (`generate_path`): no MAS. The clip is
small (`CLIP`) so that it acts on the encoder and the decoder, and would
act on the speaker encoding layer, which the reference leaves unclipped.

Tolerances, as `tests/test_torch_train.py` and
`tests/test_torch_train_presets.py`: losses atol/rtol 2e-4; gradients
max |g_port - g_jax| <= 1e-3 * max |g_jax| + 1e-7 per tensor; three steps
at lr 1e-4: losses and gradient norms rtol 2e-4, the parameter change
atol 2e-6 except where Adam turns float noise into a step; Adam's first
moments (the clipped gradients' average) as the gradients. Batching and
sampling are NumPy in both packages: equal, bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arttts_tpu.core.config import DecoderConfig, EncoderConfig, ModelConfig
from arttts_tpu.data import batching as jbatching
from arttts_tpu.models.tts import GradTTSModel as JGradTTS
from arttts_tpu.train import losses as jlosses
from arttts_tpu.train.step import create_train_state, make_train_step
from arttts_tpu.utils.torch_convert_acoustic import convert_grad_ttartic
from arttts_tpu.voxcommunis import sampler as jsampler
from arttts_tpu_torch.core import config as pconfig
from arttts_tpu_torch.data import batching as pbatching
from arttts_tpu_torch.models.tts import GradTTSModel as PGradTTS
from arttts_tpu_torch.train import losses as plosses
from arttts_tpu_torch.train.step import (UNCLIPPED_SUBMODULES, global_norm, make_optimizer,
                                         train_step)
from arttts_tpu_torch.utils.from_jax import adam_state_from_jax, grad_ttartic_state_dict
from arttts_tpu_torch.voxcommunis import sampler as psampler
from tests.test_torch_train_presets import _param_change

N_LAYERS = 1
B, T_X, T_Y, OUT = 2, 12, 48, 16
X_LENS, Y_LENS = (12, 9), (48, 37)
LR = 1e-4
CLIP = 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite's parallel run
    (six pytest workers) shares the machine's cores, and torch's default of
    a thread a core then oversubscribes them (`tests/test_torch_cli.py`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg():
    return ModelConfig(
        name="grad_ttartic", n_feats=16, n_spks=2,
        encoder=EncoderConfig(kind="ipa_trait", n_input_feats=26, n_channels=16,
                              filter_channels=32, filter_channels_dp=16, n_heads=2,
                              n_layers=N_LAYERS, dropout=0.0, prenet_dropout=0.0,
                              use_duration_predictor=False),
        decoder=DecoderConfig(dim=16))


def _pcfg(j):
    d = dataclasses.asdict(j)
    return pconfig.ModelConfig(**{**d, "encoder": pconfig.EncoderConfig(**d["encoder"]),
                                  "decoder": pconfig.DecoderConfig(**d["decoder"])})


_CACHE = {}


def _models():
    """(JAX model, JAX params as numpy, the port's state dict) with the same
    weights."""
    if "models" not in _CACHE:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(9)
            pm = PGradTTS(_pcfg(_jcfg()))
        est = pm.decoder.estimator
        with torch.no_grad():
            for k, site in enumerate([lv[2] for lv in est.downs] + [est.mid_attn]
                                     + [u[2] for u in est.ups]):
                site.fn.g.fill_((0.03 + 0.01 * k) * (-1) ** k)
        sd = {k: v.clone() for k, v in pm.state_dict().items()}
        params = jax.tree_util.tree_map(np.asarray,
                                        convert_grad_ttartic(sd, n_enc_layers=N_LAYERS))
        _CACHE["models"] = (JGradTTS(config=_jcfg()), params, sd)
    return _CACHE["models"]


def _port_model(sd=None):
    pm = PGradTTS(_pcfg(_jcfg()))
    pm.load_state_dict(sd if sd is not None else _models()[2])
    return pm.train()


def _batch(seed):
    """A numpy batch: x (B, T_X, 26) traits whose last channel is the
    aligned durations (2-4 frames a phone, inside each utterance's frames),
    y (B, T_Y, 16), spk (B, 1024) pre-embeddings, durations (B, T_X), and
    the pinned draws t (B,), z (B, OUT, 16), offsets (B,)."""
    g = np.random.default_rng(seed)
    x = g.integers(-1, 2, size=(B, T_X, 26)).astype(np.float32)
    x[..., 25] = g.integers(2, 5, size=(B, T_X))
    y = g.standard_normal((B, T_Y, 16)).astype(np.float32)
    for i in range(B):
        x[i, X_LENS[i]:] = 0
        y[i, Y_LENS[i]:] = 0.0
    assert (x[..., 25].sum(1) <= np.asarray(Y_LENS)).all()
    return dict(
        x=x, x_lengths=np.asarray(X_LENS, np.int32), y=y, y_lengths=np.asarray(Y_LENS, np.int32),
        spk=g.standard_normal((B, 1024)).astype(np.float32), durations=x[..., 25].copy(),
        pinned_t=(0.05 + 0.9 * g.random(B)).astype(np.float32),
        pinned_z=g.standard_normal((B, OUT, 16)).astype(np.float32),
        pinned_offsets=(g.random(B) * np.maximum(np.asarray(Y_LENS) - OUT, 1)).astype(np.int32),
    )


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _pinned(b, to):
    return tuple(to(b[k]) for k in ("pinned_t", "pinned_z", "pinned_offsets"))


def _close(got, ref, atol=2e-4, rtol=2e-4, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), atol=atol, rtol=rtol, err_msg=msg)


def _loss_and_grads():
    if "grads" not in _CACHE:
        jm, params, _ = _models()
        b = _batch(10)  # the trajectory's first batch

        def loss_of(p):
            return jlosses.grad_ttartic_loss(
                jm, {"params": p}, jax.random.PRNGKey(0), *map(jnp.asarray, (
                    b["x"], b["x_lengths"], b["y"], b["y_lengths"])),
                spk=jnp.asarray(b["spk"]), durations=jnp.asarray(b["durations"]), out_size=OUT,
                train=True, pinned=_pinned(b, jnp.asarray))

        (jt, jparts), jgrads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(params)
        pm = _port_model()
        tb = _torch_batch(b)
        total, parts = plosses.grad_ttartic_loss(
            pm, None, tb["x"], tb["x_lengths"], tb["y"], tb["y_lengths"], spk=tb["spk"],
            durations=tb["durations"], out_size=OUT, pinned=_pinned(tb, lambda v: v))
        total.backward()
        _CACHE["grads"] = (float(jt), {k: float(v) for k, v in jparts.items()}, jgrads, pm,
                           float(total.detach()), {k: float(v) for k, v in parts.items()})
    return _CACHE["grads"]


def _jax_trajectory():
    """Three JAX steps (`make_train_step`, the clip at CLIP) from the shared
    weights, with the states after each."""
    if "traj" not in _CACHE:
        jm, params, _ = _models()
        state = create_train_state(jm, {"params": params}, LR, grad_clip_norm=CLIP)
        step = make_train_step(jm, out_size=OUT, loss_fn=jlosses.grad_ttartic_loss,
                               donate=False)
        states, metrics = [state], []
        for s in range(3):
            state, m = step(state, jax.random.PRNGKey(0),
                            {k: jnp.asarray(v) for k, v in _batch(10 + s).items()})
            states.append(state)
            metrics.append({k: float(v) for k, v in m.items()})
        _CACHE["traj"] = (states, metrics)
    return _CACHE["traj"]


def test_grad_ttartic_loss_matches_jax():
    jt, jparts, _, _, pt, pparts = _loss_and_grads()
    assert pparts.keys() == jparts.keys() == {"prior_loss", "diff_loss"}
    for k in jparts:
        _close(pparts[k], jparts[k], msg=k)
    _close(pt, jt)
    b = _torch_batch(_batch(10))
    with pytest.raises(ValueError, match="durations"):
        plosses.grad_ttartic_loss(_port_model(), None, b["x"], b["x_lengths"], b["y"],
                                  b["y_lengths"], spk=b["spk"], out_size=OUT,
                                  pinned=_pinned(b, lambda v: v))


def test_grad_ttartic_gradients_match_jax():
    """Every gradient against `jax.value_and_grad`, the speaker encoding
    layer's and the estimator's speaker MLP's included."""
    _, _, jgrads, pm, _, _ = _loss_and_grads()
    ref = grad_ttartic_state_dict(jgrads)
    assert {n for n, _ in pm.named_parameters()} == set(ref)
    assert any(n.startswith("spk_enc.") for n in ref)
    for name, p in pm.named_parameters():
        g, r = p.grad.numpy(), ref[name].numpy()
        err, scale = float(np.abs(g - r).max()), float(np.abs(r).max())
        assert err <= 1e-3 * scale + 1e-7, (name, err, scale)


def _check_step_metrics(m, jm):
    assert set(m) == set(jm) == {"total_loss", "grad_norm", "prior_loss", "diff_loss"}
    for k in jm:
        _close(float(m[k]), jm[k], atol=0, rtol=2e-4, msg=k)


def _check_moments(opt, pm, jstate):
    """The port's Adam first moments against optax's mu, per tensor within
    the gradient tolerance."""
    mu = grad_ttartic_state_dict(jstate.opt_state[1][0].mu)
    for name, p in pm.named_parameters():
        got, ref = opt.state[p]["exp_avg"].numpy(), mu[name].numpy()
        err, scale = float(np.abs(got - ref).max()), float(np.abs(ref).max())
        assert err <= 1e-3 * scale + 1e-9, (name, err, scale)


def test_grad_ttartic_three_steps_match_make_train_step():
    states, jmetrics = _jax_trajectory()
    _, params, _ = _models()
    pm = _port_model()
    opt = make_optimizer(pm, LR)
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    grads = []
    for s in range(3):
        m = train_step(pm, opt, _torch_batch(_batch(10 + s)), None, OUT, CLIP,
                       plosses.grad_ttartic_loss)
        grads.append({n: p.grad.clone() for n, p in pm.named_parameters()})
        _check_step_metrics(m, jmetrics[s])
    _param_change(pm.state_dict(), before, params, states[3].params, grads,
                  to_sd=grad_ttartic_state_dict)
    _check_moments(opt, pm, states[3])


def test_speaker_module_unclipped_while_the_clip_acts():
    """One step at CLIP: the encoder's and the decoder's gradients have
    norms above CLIP, so Adam's first moment holds 0.1 * CLIP / norm of
    them; the speaker encoding layer's norm is above CLIP too, and its
    moment holds 0.1 of its raw gradient, as optax's after
    `make_train_step`'s first step. A clip of every top-level submodule
    would scale it as well."""
    states, _ = _jax_trajectory()
    _, _, jgrads, _, _, _ = _loss_and_grads()  # the raw gradients of the first batch
    raw = grad_ttartic_state_dict(jgrads)
    pm = _port_model()
    opt = make_optimizer(pm, LR)
    train_step(pm, opt, _torch_batch(_batch(10)), None, OUT, CLIP, plosses.grad_ttartic_loss)
    assert UNCLIPPED_SUBMODULES == ("spk_enc", "spk_emb")
    for group in ("encoder", "decoder", "spk_enc"):
        names = [n for n, _ in pm.named_parameters() if n.startswith(group + ".")]
        norm = float(global_norm(raw[n] for n in names))
        assert norm > 2 * CLIP, (group, norm)
        scale = 1.0 if group == "spk_enc" else CLIP / (norm + 1e-6)
        for n, p in pm.named_parameters():
            if n in names:
                want = 0.1 * scale * raw[n]
                err = float((opt.state[p]["exp_avg"] - want).abs().max())
                assert err <= 1e-3 * float(want.abs().max()) + 1e-9, (n, err)
    _check_moments(opt, pm, states[1])


def test_adam_state_bridge_continues_a_grad_ttartic_run():
    """Two JAX steps, then the params and the optax state (with its
    `spk_encoder` moments) bridged into the port: the port's third step is
    the JAX package's third step."""
    states, jmetrics = _jax_trajectory()
    pm = _port_model(grad_ttartic_state_dict(states[2].params))
    opt = make_optimizer(pm, LR)
    opt.load_state_dict(adam_state_from_jax(states[2].opt_state, pm, LR))
    assert all(float(opt.state[p]["step"]) == 2.0 for p in pm.parameters())
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    m = train_step(pm, opt, _torch_batch(_batch(12)), None, OUT, CLIP, plosses.grad_ttartic_loss)
    _check_step_metrics(m, jmetrics[2])
    grads = [{n: p.grad.clone() for n, p in pm.named_parameters()}]
    _param_change(pm.state_dict(), before, states[2].params, states[3].params, grads,
                  to_sd=grad_ttartic_state_dict)
    _check_moments(opt, pm, states[3])


# ---------------------------------------------------------------------------
# batching and sampling


def _items(n, seed, spk_vector=True):
    """Trait items {"x" (T_x, 26), "y" (T_y, 16), "spk", "durations" (T_x,)}:
    the speaker a 1024-d pre-embedding or an int id."""
    g = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t_x = int(g.integers(5, 40))
        x = g.integers(-1, 2, size=(t_x, 26)).astype(np.float32)
        x[:, 25] = g.integers(1, 5, t_x)
        out.append({"x": x, "y": g.standard_normal((int(x[:, 25].sum()), 16)).astype(np.float32),
                    "spk": (g.standard_normal(1024).astype(np.float32) if spk_vector
                            else np.asarray(int(g.integers(0, 4)), np.int32)),
                    "durations": x[:, 25].copy()})
    return out


def _same_batches(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("spk_vector", [True, False])
def test_pad_batch_matches_jax_on_trait_items(spk_vector):
    items = _items(5, 1, spk_vector)
    for kw in ({}, {"min_frames": 128}):
        p, j = pbatching.pad_batch(items, **kw), jbatching.pad_batch(items, **kw)
        _same_batches(p, j)
    assert p["x"].shape[2] == 26 and p["durations"].dtype == np.float32
    assert p["spk"].shape == ((5, 1024) if spk_vector else (5,))


class _Multilingual:
    """An in-memory multilingual set: items of three languages of 11, 4 and
    7 utterances, in that order, with `lang_sizes` and `lengths()`."""

    def __init__(self):
        self.items = _items(22, 2)
        self.lang_sizes = [11, 4, 7]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    def lengths(self):
        return np.array([len(it["y"]) for it in self.items])


@pytest.mark.parametrize("upsample", [None, 0.5, 0.9])
def test_dataloader_matches_jax_with_language_upsampling(upsample):
    """Two epochs of the training loader, language upsampling on (the
    sampler's rng carries from one epoch to the next) or off, batches equal
    to the JAX package's."""
    ds = _Multilingual()
    kw = dict(batch_size=4, seed=7, min_frames=OUT, language_upsample=upsample)
    jl, pl = jbatching.DataLoader(ds, **kw), pbatching.DataLoader(ds, **kw)
    assert len(jl) == len(pl) == 5
    for epoch in (1, 2):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        jb, pb = list(jl), list(pl)
        assert len(jb) == len(pb) == 5
        for a, b in zip(jb, pb):
            _same_batches(a, b)
    plain = _Multilingual()
    plain.lang_sizes = None  # a set without languages cannot be upsampled
    with pytest.raises(ValueError, match="lang_sizes"):
        pbatching.DataLoader(plain, 4, language_upsample=0.5)


def test_samplers_give_the_jax_index_streams():
    """`get_length_grouped_indices` (with and without given indices and a
    mega-batch size), `LengthGroupedSampler` and
    `LengthGroupedLanguageUpSampler` over three epochs each: the same
    indices as the JAX package's for the same seed."""
    lengths = np.random.default_rng(4).integers(10, 500, 97)
    drawn = np.random.default_rng(5).integers(0, 97, 97)  # as the language sampler draws
    for kw in ({}, {"mega_batch_mult": 3}, {"indices": drawn}):
        p = psampler.get_length_grouped_indices(lengths, 8, rng=np.random.default_rng(1), **kw)
        j = jsampler.get_length_grouped_indices(lengths, 8, rng=np.random.default_rng(1), **kw)
        assert p == j and len(p) == 97
    pairs = [(psampler.LengthGroupedSampler(8, lengths, seed=3),
              jsampler.LengthGroupedSampler(8, lengths, seed=3)),
             (psampler.LengthGroupedLanguageUpSampler(8, lengths, [50, 30, 17], 0.5, seed=3),
              jsampler.LengthGroupedLanguageUpSampler(8, lengths, [50, 30, 17], 0.5, seed=3))]
    for p, j in pairs:
        assert len(p) == len(j) == 97
        epochs = [list(p) for _ in range(3)]
        assert epochs == [list(j) for _ in range(3)]
        assert epochs[0] != epochs[1]  # the rng carries over: each epoch differs
    np.testing.assert_array_equal(pairs[1][0].probas, pairs[1][1].probas)
