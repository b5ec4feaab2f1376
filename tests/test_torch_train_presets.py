"""Training of the trait-input single-speaker presets in the PyTorch port
(`arttts_tpu_torch/train/`) against the JAX package's training path, on the
CPU at small widths, one case per decoder kind: v1 (the 2D U-Net at 16
rows), v3 (2D at 80 rows), v5 (the 1D U-Net) and v5_preblock (the 2D U-Net
behind the channel-attention preblock); and the port's `eval/metrics.py`.
`tests/test_torch_train_cli.py` runs `cli.train` on every preset.

The port model is seeded (small distinct Rezero gains so the linear
attentions count) and carried to JAX by the JAX package's converters;
dropout is 0.0 on both sides (their random masks cannot match) and both get
the same pinned draws (t, z, segment offsets). On CPU tensors MAS runs the
plain version, which `tests/test_torch_mas.py` holds bit-exact against the
JAX implementations.

Tolerances, as `tests/test_torch_train.py`: losses atol/rtol 2e-4 (float32,
sums in other orders); gradients max |g_port - g_jax| <= 1e-3 *
max |g_jax| + 1e-7 per tensor; three optimizer steps at lr 1e-4: losses
and gradient norms rtol 2e-4, the parameter change atol 2e-6 (2% of one
step) except where Adam turns float noise into a step (`_param_change`:
elements whose gradient at some step lies within the gradient tolerance of
zero).
The metrics are NumPy in both packages: equal to rtol 1e-12.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arttts_tpu.core.config import DecoderConfig, EncoderConfig, ModelConfig
from arttts_tpu.eval import metrics as jmetrics
from arttts_tpu.train import losses as jlosses
from arttts_tpu.train.step import create_train_state, make_train_step
from arttts_tpu.utils.torch_convert_acoustic import convert_grad_tts
from arttts_tpu_torch.core import config as pconfig
from arttts_tpu_torch.eval import metrics as pmetrics
from arttts_tpu_torch.models.tts import GradTTSModel as PGradTTS
from arttts_tpu_torch.train import losses as plosses
from arttts_tpu_torch.train.step import make_optimizer, train_step
from arttts_tpu_torch.utils.from_jax import grad_tts_state_dict

N_LAYERS = 1
B, T_X, T_Y, OUT = 2, 12, 48, 16
X_LENS, Y_LENS = (12, 9), (48, 37)
LR = 1e-4
# preset -> (model family, decoder kind, feature rows)
KINDS = {"v1": ("art_tts", "unet2d", 16), "v3": ("art_tts", "unet2d", 80),
         "v5": ("attention_tts", "unet1d", 16),
         "v5_preblock": ("attention_tts_preblock", "unet1d_preblock", 16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite's parallel run
    (six pytest workers) shares the machine's cores, and torch's default of
    a thread a core then oversubscribes them (`tests/test_torch_cli.py`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(preset):
    name, kind, n_feats = KINDS[preset]
    return ModelConfig(
        name=name, n_feats=n_feats,
        encoder=EncoderConfig(kind="ipa_trait", n_input_feats=25, n_channels=16,
                              filter_channels=32, filter_channels_dp=16, n_heads=1,
                              n_layers=N_LAYERS, dropout=0.0, prenet_dropout=0.0),
        decoder=DecoderConfig(kind=kind, dim=16))


def _pcfg(j):
    d = dataclasses.asdict(j)
    return pconfig.ModelConfig(**{**d, "encoder": pconfig.EncoderConfig(**d["encoder"]),
                                  "decoder": pconfig.DecoderConfig(**d["decoder"])})


_CACHE = {}


def _models(preset):
    """(JAX model, JAX params as numpy, the port's state dict) with the same
    weights."""
    if preset not in _CACHE:
        jcfg = _jcfg(preset)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(7)
            pm = PGradTTS(_pcfg(jcfg))
        est = pm.decoder.estimator
        with torch.no_grad():
            for k, site in enumerate([lv[2] for lv in est.downs] + [est.mid_attn]
                                     + [u[2] for u in est.ups]):
                site.fn.g.fill_((0.03 + 0.01 * k) * (-1) ** k)
        sd = {k: v.clone() for k, v in pm.state_dict().items()}
        params = convert_grad_tts(sd, n_enc_layers=N_LAYERS,
                                  decoder_kind="unet1d" if jcfg.decoder.kind == "unet1d"
                                  else "unet2d")
        params = jax.tree_util.tree_map(np.asarray, params)
        from arttts_tpu.models.tts import GradTTSModel as JGradTTS

        _CACHE[preset] = (JGradTTS(config=jcfg), params, sd)
    return _CACHE[preset]


def _port_model(preset, sd=None):
    pm = PGradTTS(_pcfg(_jcfg(preset)))
    pm.load_state_dict(sd if sd is not None else _models(preset)[2])
    return pm.train()


def _batch(seed, n_feats):
    """A numpy batch with pinned draws: x (B, T_X, 25) ternary traits, y
    (B, T_Y, F), t (B,), z (B, OUT, F), offsets (B,)."""
    g = np.random.default_rng(seed)
    x = g.integers(-1, 2, size=(B, T_X, 25)).astype(np.float32)
    y = g.standard_normal((B, T_Y, n_feats)).astype(np.float32)
    for i in range(B):
        x[i, X_LENS[i]:] = 0
        y[i, Y_LENS[i]:] = 0.0
    return dict(
        x=x, x_lengths=np.asarray(X_LENS, np.int32), y=y, y_lengths=np.asarray(Y_LENS, np.int32),
        pinned_t=(0.05 + 0.9 * g.random(B)).astype(np.float32),
        pinned_z=g.standard_normal((B, OUT, n_feats)).astype(np.float32),
        pinned_offsets=(g.random(B) * np.maximum(np.asarray(Y_LENS) - OUT, 1)).astype(np.int32),
    )


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _pinned(b, to):
    return tuple(to(b[k]) for k in ("pinned_t", "pinned_z", "pinned_offsets"))


def _close(got, ref, atol=2e-4, rtol=2e-4, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), atol=atol, rtol=rtol, err_msg=msg)


def _loss_and_grads(preset):
    key = ("grads", preset)
    if key not in _CACHE:
        jm, params, _ = _models(preset)
        b = _batch(1, KINDS[preset][2])

        def loss_of(p):
            return jlosses.grad_tts_loss(
                jm, {"params": p}, jax.random.PRNGKey(0), *map(jnp.asarray, (
                    b["x"], b["x_lengths"], b["y"], b["y_lengths"])),
                out_size=OUT, train=True, pinned=_pinned(b, jnp.asarray))

        (jt, jparts), jgrads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(params)
        pm = _port_model(preset)
        tb = _torch_batch(b)
        total, parts = plosses.grad_tts_loss(pm, None, tb["x"], tb["x_lengths"], tb["y"],
                                             tb["y_lengths"], out_size=OUT,
                                             pinned=_pinned(tb, lambda v: v))
        total.backward()
        _CACHE[key] = (float(jt), {k: float(v) for k, v in jparts.items()}, jgrads, pm,
                       float(total.detach()), {k: float(v) for k, v in parts.items()})
    return _CACHE[key]


@pytest.mark.parametrize("preset", list(KINDS))
def test_trait_loss_matches_jax(preset):
    jt, jparts, _, _, pt, pparts = _loss_and_grads(preset)
    assert pparts.keys() == jparts.keys() == {"dur_loss", "prior_loss", "diff_loss"}
    for k in jparts:
        _close(pparts[k], jparts[k], msg=k)
    _close(pt, jt)


@pytest.mark.parametrize("preset", list(KINDS))
def test_trait_gradients_match_jax(preset):
    """Every parameter's gradient against `jax.value_and_grad` of the same
    loss, the duration predictor's included."""
    _, _, jgrads, pm, _, _ = _loss_and_grads(preset)
    ref = grad_tts_state_dict(jgrads)
    assert {n for n, _ in pm.named_parameters()} == set(ref)
    for name, p in pm.named_parameters():
        g, r = p.grad.numpy(), ref[name].numpy()
        err, scale = float(np.abs(g - r).max()), float(np.abs(r).max())
        assert err <= 1e-3 * scale + 1e-7, (name, err, scale)


def _param_change(after, before, jax_before, jax_after, grads, to_sd=grad_tts_state_dict):
    """The parameter change after three steps against the JAX package's,
    element by element, at atol 2e-6 (2% of one step at lr 1e-4). Adam
    divides each element's gradient by its own magnitude, so where an
    element's gradient was within the gradient tolerance of zero at some
    step (|g| <= 1e-3 * max|g| + 1e-7 of its tensor, where its sign is
    float noise in either package) that step's update is set by the noise.
    Such elements may differ by up to 6 lr (two opposite updates of at
    most lr a step), and at most 1e-3 of all elements may be such
    (measured: 10 of 581,896 on v1, 85 of 584,496 on v5_preblock, every
    one with a gradient within 1.2e-4 of max|g| of zero at some step).
    `grads`: the port's gradients of each step."""
    j0, j1 = to_sd(jax_before), to_sd(jax_after)
    n_over = n_all = 0
    for name in before:
        err = ((after[name] - before[name]) - (j1[name] - j0[name])).abs()
        over = err > 2e-6
        n_over += int(over.sum())
        n_all += err.numel()
        if over.any():
            noise = torch.zeros_like(over)
            for g in grads:
                noise |= g[name].abs() <= 1e-3 * g[name].abs().max() + 1e-7
            assert bool(noise[over].all()) and float(err.max()) <= 6 * LR, (
                name, float(err.max()))
    assert n_over <= 1e-3 * n_all, (n_over, n_all)


@pytest.mark.parametrize("preset", list(KINDS))
def test_trait_three_steps_match_make_train_step(preset):
    jm, params, _ = _models(preset)
    n_feats = KINDS[preset][2]
    state = create_train_state(jm, {"params": params}, LR)
    step = make_train_step(jm, out_size=OUT, donate=False)
    pm = _port_model(preset)
    opt = make_optimizer(pm, LR)
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    grads = []
    for s in range(3):
        b = _batch(10 + s, n_feats)
        state, jm_s = step(state, jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in b.items()})
        m = train_step(pm, opt, _torch_batch(b), None, OUT)
        grads.append({n: p.grad.clone() for n, p in pm.named_parameters()})
        for k in ("total_loss", "grad_norm", "dur_loss", "prior_loss", "diff_loss"):
            _close(float(m[k]), float(jm_s[k]), atol=0, rtol=2e-4, msg=f"step {s} {k}")
    _param_change(pm.state_dict(), before, params, state.params, grads)


def test_metrics_match_jax():
    """`eval/metrics.py` is a copy of the JAX package's NumPy module: DTW
    path and distance, the normalised score with its aligned signals, PCC
    (also of a constant), the EMA mean PCC and the mel L2."""
    r = np.random.default_rng(3)
    a, b = r.standard_normal((23, 16)), r.standard_normal((31, 16))
    pp, pd = pmetrics.dtw_path(a, b)
    jp, jd = jmetrics.dtw_path(a, b)
    assert pp == jp and pd == jd
    for got, want in zip(pmetrics.normalized_dtw_score(a, b), jmetrics.normalized_dtw_score(a, b)):
        np.testing.assert_array_equal(got, want)
    p1, j1 = pmetrics.dtw_path(a[:, 0][None], b[:, 0][None]), jmetrics.dtw_path(a[:, 0][None],
                                                                                  b[:, 0][None])
    assert p1 == j1
    for x, y in ((a[:, 0], a[:, 1]), (a[:, 2], np.ones(23))):
        assert pmetrics.pearson_correlation(x, y) == jmetrics.pearson_correlation(x, y)
    assert pmetrics.pearson_correlation(a[:, 2], np.ones(23)) == 0.0
    np.testing.assert_allclose(pmetrics.ema_mean_pcc(a, a[::-1]),
                               jmetrics.ema_mean_pcc(a, a[::-1]), rtol=1e-12)
    assert pmetrics.mel_l2(a, b) == jmetrics.mel_l2(a, b)
