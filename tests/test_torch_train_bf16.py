"""bf16 decoder training in the port (`compute_dtype="bfloat16"`) against its
own float32 step and against the JAX package's bf16 step, on the CPU.

The shape is the JAX gate's (`tests/test_train_bf16.py`: v1 shrunk to 32
encoder channels, one layer, decoder dim 16; B=2, T_x 24, T_y 64, out_size
32), and the same for the preblock decoder (v5_preblock). The weights are
the port's from a seed (small distinct Rezero gains so the attentions
count), carried to JAX by the JAX package's converter; dropout is off and
both sides take the same pinned draws (t, z, segment offsets).

(a) The JAX gate's bounds, port bf16 against port float32: the loss within
    2% of max(|f32|, 1), the gradients' cosine above 0.99 and their norm
    ratio within 0.8-1.25. The parameters, their gradients and Adam's
    moments stay float32.
(b) Against the JAX bf16 step by the size and direction of the bf16
    effect (ROADMAP "bf16 parity": deeper than one module the bf16
    function is chaotic at the ulp level, so it cannot be held closer). The
    JAX steps are jitted in a process of their own with XLA's excess
    precision off, so that the bf16 program rounds each operation's result
    as the port's modules do (by default XLA on the CPU keeps float32
    between fused bf16 operations, and the port then does not track it).
    Over the whole gradient: the port's distance to JAX's bf16 gradient at
    most SHARE of JAX's own bf16-vs-f32 distance, the port's bf16 effect
    (bf16 - f32) JAX's in size (0.5-2x) and direction (cosine at least
    0.3); the port's float32 step is the control and must fail the
    distance. The gradient distance alone separates the control: it reads
    0.99999-1.000002 of JAX's gap against SHARE 0.95, the port's bf16 step
    0.77-0.84. The loss's bf16 effect is about 1e-4 of it and its sign
    changes with the seed, so no loss bound can tell bf16 from float32
    here: the loss against JAX's bf16 loss within the gate's band is a
    sanity check only (the float32 control passes it too).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arttts_tpu.core.config import get_preset
from arttts_tpu.models.tts import GradTTSModel as JGradTTS
from arttts_tpu.train import losses as jlosses
from arttts_tpu.utils.torch_convert_acoustic import convert_grad_tts
from arttts_tpu_torch.core import config as pconfig
from arttts_tpu_torch.models.tts import GradTTSModel as PGradTTS
from arttts_tpu_torch.train import losses as plosses
from arttts_tpu_torch.train.step import make_optimizer
from arttts_tpu_torch.utils.from_jax import grad_tts_state_dict

ROOT = Path(__file__).resolve().parents[1]
B, T_X, T_Y, OUT = 2, 24, 64, 32
PRESETS = ("v1", "v5_preblock")
# the port's bf16 gradient's distance to JAX's bf16 gradient, as a share of
# JAX's own bf16-vs-f32 distance: measured 0.77 (v1) and 0.84
# (v5_preblock), effect sizes 0.83 and 0.88, cosines 0.66 and 0.61; the
# port's float32 gradient reads 0.99999 and 1.000002. The gate (a) reads a
# loss change of 2.4e-4 and 6.2e-5, cosines 0.99997 and 0.99995, norm
# ratios 0.9994 and 0.9997; the bf16 losses are 1.6e-4 and 7.1e-5 from
# JAX's
SHARE = 0.95


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs (see tests/test_torch_cli.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(preset, dtype):
    m = get_preset(preset).model
    return dataclasses.replace(
        m, encoder=dataclasses.replace(m.encoder, n_channels=32, filter_channels=64,
                                       filter_channels_dp=64, n_layers=1, dropout=0.0,
                                       prenet_dropout=0.0),
        decoder=dataclasses.replace(m.decoder, dim=16, compute_dtype=dtype))


def _pcfg(j):
    d = dataclasses.asdict(j)
    return pconfig.ModelConfig(**{**d, "encoder": pconfig.EncoderConfig(**d["encoder"]),
                                  "decoder": pconfig.DecoderConfig(**d["decoder"])})


def _case(preset):
    """The batch, the pinned draws and the seeded weights (the port's state
    dict) of one preset, the same in every process."""
    rng = np.random.default_rng(0)
    j32 = _jcfg(preset, "float32")
    F_in, F = j32.encoder.n_input_feats, j32.n_feats
    b = dict(x=rng.integers(-1, 2, size=(B, T_X, F_in)).astype(np.float32),
             x_lengths=np.full((B,), T_X, np.int32),
             y=rng.standard_normal((B, T_Y, F)).astype(np.float32),
             y_lengths=np.full((B,), T_Y, np.int32))
    pin = ((0.05 + 0.9 * rng.random(B)).astype(np.float32),
           rng.standard_normal((B, OUT, F)).astype(np.float32),
           (rng.random(B) * (T_Y - OUT)).astype(np.int32))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        seeded = PGradTTS(_pcfg(j32))
    est = seeded.decoder.estimator
    with torch.no_grad():
        for k, site in enumerate([lv[2] for lv in est.downs] + [est.mid_attn]
                                 + [u[2] for u in est.ups]):
            site.fn.g.fill_((0.03 + 0.01 * k) * (-1) ** k)
    return b, pin, seeded.state_dict()


def _jax_main(path):
    """The JAX steps of every preset and dtype (jitted), saved to `path`;
    run in a process of its own with XLA's excess precision off, so that
    the bf16 program rounds every operation's result to bf16, as the JAX
    modules do op by op (by default XLA on the CPU keeps float32 between
    fused bf16 operations)."""
    jax.config.update("jax_platforms", "cpu")
    out = {}
    for preset in PRESETS:
        b, pin, sd = _case(preset)
        params = jax.tree_util.tree_map(np.asarray, convert_grad_tts(sd, n_enc_layers=1))
        for dtype in ("float32", "bfloat16"):
            jm = JGradTTS(config=_jcfg(preset, dtype))

            def loss_of(p, jm=jm):
                return jlosses.grad_tts_loss(
                    jm, {"params": p}, jax.random.PRNGKey(7),
                    *map(jnp.asarray, (b["x"], b["x_lengths"], b["y"], b["y_lengths"])),
                    out_size=OUT, train=True, pinned=tuple(map(jnp.asarray, pin)))

            (total, _), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(params)
            out[f"{preset}/{dtype}/loss"] = np.float64(total)
            for n, g in grad_tts_state_dict(jax.tree_util.tree_map(np.asarray, grads)).items():
                out[f"{preset}/{dtype}/grad/{n}"] = g.numpy()
    np.savez(path, **out)


@pytest.fixture(scope="module")
def jax_steps(tmp_path_factory):
    """`_jax_main`'s results: {preset: {dtype: (loss, {name: gradient})}}."""
    path = tmp_path_factory.mktemp("jax_bf16") / "steps.npz"
    flags = os.environ.get("XLA_FLAGS", "") + " --xla_allow_excess_precision=false"
    subprocess.run([sys.executable, "-c", f"from tests.test_torch_train_bf16 import _jax_main; "
                    f"_jax_main({str(path)!r})"], cwd=ROOT, check=True, timeout=600,
                   env={**os.environ, "XLA_FLAGS": flags.strip(), "JAX_PLATFORMS": "cpu"})
    z = np.load(path)
    out = {}
    for preset in PRESETS:
        for dtype in ("float32", "bfloat16"):
            pre = f"{preset}/{dtype}/grad/"
            out.setdefault(preset, {})[dtype] = (
                float(z[f"{preset}/{dtype}/loss"]),
                {k[len(pre):]: torch.from_numpy(z[k]) for k in z.files if k.startswith(pre)})
    return out


_CACHE = {}


def _port_steps(preset):
    """{dtype: (loss, {name: gradient})} of the port, and its bf16 model
    after its gradient."""
    if preset in _CACHE:
        return _CACHE[preset]
    b, pin, sd = _case(preset)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    out = {}
    for dtype in ("float32", "bfloat16"):
        pm = PGradTTS(_pcfg(_jcfg(preset, dtype)))
        pm.load_state_dict(sd)
        pm.train()
        total, _ = plosses.grad_tts_loss(pm, None, tb["x"], tb["x_lengths"], tb["y"],
                                         tb["y_lengths"], out_size=OUT,
                                         pinned=tuple(map(torch.from_numpy, pin)))
        total.backward()
        out[dtype] = (float(total.detach()),
                      {n: p.grad.clone() for n, p in pm.named_parameters()})
    _CACHE[preset] = (out, pm)
    return _CACHE[preset]


def _flat(grads):
    return np.concatenate([grads[k].numpy().ravel() for k in sorted(grads)]).astype(np.float64)


def _cos(a, b):
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize("preset", PRESETS)
def test_bf16_step_meets_the_jax_gate(preset):
    """(a): the port's bf16 step against its float32 step within the JAX
    gate's bounds; parameters, gradients and Adam's moments float32."""
    out, pm = _port_steps(preset)
    assert pm.decoder.estimator.dtype == torch.bfloat16
    (l32, g32), (l16, g16) = out["float32"], out["bfloat16"]
    assert l16 != l32 and not all(torch.equal(g16[k], g32[k]) for k in g32)  # bf16 acts
    assert abs(l16 - l32) <= 0.02 * max(abs(l32), 1.0), (l32, l16)
    a, b = _flat(g32), _flat(g16)
    assert _cos(a, b) > 0.99
    assert 0.8 < np.linalg.norm(b) / np.linalg.norm(a) < 1.25
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in pm.parameters())
    opt = make_optimizer(pm, 1e-4)
    opt.step()
    assert all(t.dtype == torch.float32 for s in opt.state.values()
               for k, t in s.items() if k != "step")


@pytest.mark.parametrize("preset", PRESETS)
def test_bf16_step_tracks_the_jax_bf16_step(preset, jax_steps):
    """(b): the port's bf16 gradient against JAX's bf16 step by the size and
    direction of the bf16 effect, the port's float32 step failing; then
    the loss within the gate's band of JAX's bf16 loss, a sanity check
    that the control would pass too."""
    port, jx = _port_steps(preset)[0], jax_steps[preset]
    assert set(port["bfloat16"][1]) == set(jx["bfloat16"][1])
    j32, j16 = (_flat(jx[d][1]) for d in ("float32", "bfloat16"))
    p32, p16 = (_flat(port[d][1]) for d in ("float32", "bfloat16"))
    gap = np.linalg.norm(j16 - j32)
    assert gap > 1e-4 * np.linalg.norm(j32)  # the mode is in effect
    effect, jeffect = p16 - p32, j16 - j32
    assert np.linalg.norm(p16 - j16) <= SHARE * gap
    assert 0.5 <= np.linalg.norm(effect) / gap <= 2.0
    assert _cos(effect, jeffect) >= 0.3
    assert np.linalg.norm(p32 - j16) > SHARE * gap  # the control
    jl16, pl16 = jx["bfloat16"][0], port["bfloat16"][0]  # sanity only, not a bf16 check
    assert abs(pl16 - jl16) <= 0.02 * max(abs(jl16), 1.0)
