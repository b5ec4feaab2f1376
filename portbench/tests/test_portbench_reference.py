"""The plain reference against the port's module path, at small sizes on the
CPU: the same seeded tensors loaded into both, the same inputs."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import harness, seeds
from portbench.reference import tts as R
from portbench.reference.vocoders import vocode_windows
from portbench.tests.tiny import tiny_config

TOL = 1e-5


def both(name: str, seed: int = 4):
    cfg = tiny_config(name)
    state, voc_state = harness.seeded_weights(cfg, seed, "cpu")
    ref_m, ref_v = harness.reference_models(cfg)
    return (cfg, harness.program_model(cfg, seeds.clone_state(state)),
            harness.program_vocoder(cfg, seeds.clone_state(voc_state)),
            harness.reference_on(ref_m, state), harness.reference_on(ref_v, voc_state))


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-12))


@pytest.mark.parametrize("name", ["v2", "v6"])
def test_encoder_matches(name):
    cfg, pm, _, rm, _ = both(name)
    g = torch.Generator().manual_seed(0)
    if name == "v2":
        x = torch.randint(0, cfg["model"]["encoder"]["n_vocab"], (2, 23), generator=g)
        spk = None
    else:
        x = torch.randn(2, 23, 26, generator=g)
        spk = torch.randn(2, 1024, generator=g)
    xl = torch.tensor([23, 17], dtype=torch.int32)
    a = pm.encode(x, xl, spk)
    b = rm.encoder(x, xl, None, rm.speaker(spk))
    for u, v in zip(a, b):
        assert rel(u, v) <= TOL


@pytest.mark.parametrize("name,T,masked_norm", [("v2", 128, False), ("v2", 256, False),
                                                ("v6", 64, True)])
def test_unet_matches_module_path_and_kernel_path(name, T, masked_norm):
    from arttts_tpu_torch.models.unet2d_fast import make_score_fn
    from arttts_tpu_torch.infer.pipeline import with_masked_norm

    cfg, pm, _, rm, _ = both(name)
    if masked_norm:
        pm = with_masked_norm(pm)
    F = cfg["model"]["n_feats"]
    g = torch.Generator().manual_seed(1)
    x, mu = torch.randn(1, T, F, generator=g), torch.randn(1, T, F, generator=g)
    m = torch.ones(1, T, 1)
    m[:, T - 37:] = 0
    t = torch.tensor([0.4])
    spk = torch.randn(1, 1024, generator=g) if name == "v6" else None
    want = rm.score(x * m, m, mu, t, rm.speaker(spk), rm.gn(T, masked_norm))
    fast = make_score_fn(pm, T=T)(x * m, m, mu, t, spk)
    assert rel(fast, want) <= TOL
    if not (name == "v2" and T % 256 == 0):  # the module path's own statistics
        assert rel(pm.estimate_noise(x * m, m, mu, t, spk), want) <= TOL


def test_hifigan_matches():
    from arttts_tpu_torch.infer.sampler import vocode

    _, _, pv, _, rv = both("v2")
    mel = torch.randn(1, 24, 80, generator=torch.Generator().manual_seed(2))
    assert rel(pv(mel)[..., 0], rv(mel)) <= TOL
    assert rel(vocode(pv, mel, device="cpu")[..., 0], rv(mel)) <= TOL


def test_sparc_chunked_matches():
    from arttts_tpu_torch.infer.chunked import vocode_sparc

    cfg, _, pv, _, rv = both("v6")
    sp = cfg["sparc"]
    g = np.random.default_rng(3)
    spk = g.standard_normal(1024).astype(np.float32)
    for T in (40, 150):  # one placed window, and several
        feats = g.standard_normal((T, 14)).astype(np.float32)
        got = vocode_sparc(pv, feats, spk, device="cpu", chunk=sp["chunk"], halo=sp["halo"],
                           win_batch=sp["win_batch"])
        s = torch.as_tensor(spk)[None]
        want = vocode_windows(
            lambda b: rv(torch.as_tensor(b), s.expand(b.shape[0], -1)).detach().numpy(),
            feats, sp["chunk"], sp["halo"], sp["win_batch"])
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_mas_numpy_matches_the_port():
    from arttts_tpu_torch.ops.mas import mas_reference_numpy

    g = np.random.default_rng(5)
    value = g.standard_normal((3, 9, 21)).astype(np.float32)
    t_xs, t_ys = np.array([9, 5, 7]), np.array([21, 12, 7])
    for b in range(3):
        value[b, t_xs[b]:] = 0
        value[b, :, t_ys[b]:] = 0
    assert np.array_equal(R.mas_numpy(value, t_xs, t_ys),
                          mas_reference_numpy(value, t_xs, t_ys).astype(np.float32))


def test_training_loss_and_step_match():
    """Three steps of the port's train_step against the reference's loss
    and Adam, from the seed and from the state the window opens on: the
    same dropout masks (one generator), pinned draws."""
    from portbench.drivers.train_steps import Driver
    from portbench.tests.tiny import tiny_spec

    run = harness.Run(tiny_spec("v2.train"), 9, 0.1, torch.device("cpu"), False, "v2.train")
    drv = Driver(run)
    drv.setup()
    drv.window(harness.Tracer(False, 0, 0, run.device))
    got = drv.check(None)
    for side in ("", "window_"):
        assert got[side + "loss_gap"] <= 1e-6
        assert got[side + "grad_gap"] <= 1e-5
        assert got[side + "update_gap"] <= 1e-5
    assert (drv.window_start["t"], drv.window_start["batch"]) == (3, 0)  # after 3 batches


def test_serve_request_matches_the_port():
    from arttts_tpu_torch.infer.sampler import serve_text_to_wav

    cfg, pm, pv, rm, rv = both("v2")
    x = torch.randint(0, 149, (1, 30), generator=torch.Generator().manual_seed(6))
    wav, y_len, bucket = serve_text_to_wav(pm, pv, torch.Generator().manual_seed(7), x,
                                           torch.tensor([30], dtype=torch.int32),
                                           n_timesteps=10, device="cpu")
    g = torch.Generator().manual_seed(7)
    dec, y_ref, b_ref = R.serve_request(rm, x, 10, lambda s: torch.randn(s, generator=g))
    assert (int(y_len[0]), bucket) == (y_ref, b_ref) == (90, 128)
    assert rel(wav[0, :, 0], rv(dec)[0]) <= 1e-4
