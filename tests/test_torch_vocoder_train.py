"""Parity of the port's vocoder GAN training with the JAX package's, on the
CPU: the period and scale discriminators (every logit and feature map, at
wav lengths that pin flax's SAME splits, the reflect fold and the pooled
lengths), the three GAN losses, the mel that carries a gradient and its
gradient, one whole GAN step from bridged weights and Adam states, the
segment dataset (crops bit for bit under one seed), `cli.train_vocoder`
end to end, and the entry points' default to the card.

The discriminators are the JAX package's at full size (70.7 M parameters,
built once with `jax.jit(init)`); the generator is the tiny one of
`tests/test_vocoder_training.py`. On the CPU the port's discriminator step
takes its generator pass on K4/K5's plain versions.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arttts_tpu.audio.mel import MelConfig as JMelConfig
from arttts_tpu.audio.mel import MelSpectrogram as JMel
from arttts_tpu.data import vocoder_dataset as jvd
from arttts_tpu.models import hifigan as jh
from arttts_tpu.train.vocoder_trainer import VocoderGAN as JVocoderGAN
from arttts_tpu.train.vocoder_trainer import VocoderTrainState
from arttts_tpu_torch.audio.io import load_wav
from arttts_tpu_torch.audio.mel import MelConfig, MelSpectrogram
from arttts_tpu_torch.data import vocoder_dataset as pvd
from arttts_tpu_torch.models import hifigan as ph
from arttts_tpu_torch.train.vocoder_trainer import ADAM_BETAS, VocoderGAN
from arttts_tpu_torch.utils.from_jax import (
    disc_state_dict,
    hifigan_state_dict,
    msd_state_dict,
    mpd_state_dict,
    plain_adam_state_from_jax,
)
from tests.test_torch_frontend import FLOOR_REGION, TOL_MEL, TOL_MEL_CORPUS
from tests.test_vocoder_dataset import _write_wavs

SR = 22050
SEG = 2048  # 8 frames at hop 256, as tests/test_vocoder_dataset.py
TINY = dict(upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
            upsample_initial_channel=32, resblock_kernel_sizes=(3,),
            resblock_dilation_sizes=((1, 3),))
TINY_ARGS = ["--upsample-rates", "8", "8", "4", "--upsample-kernels", "16", "16", "8",
             "--initial-channel", "16", "--resblock-kernels", "3", "--resblock-dilations", "1,3"]
# a forward's outputs: max |port - JAX| <= TOL_FWD * max(1, max |JAX|)
TOL_FWD = 1e-5
# one GAN step: the metrics' relative distance (measured at most 4.2e-7), and
# each parameter tensor's move against the JAX move, ||port - JAX|| / ||JAX||
# (measured at most 5.1e-3, in the scale discriminator's grouped convs, where
# Adam's normalised step magnifies the rounding of elements whose first
# moment nearly cancels; at most 1.1e-5 in the generator)
TOL_METRIC = 1e-5
TOL_UPDATE = 2e-2
# the mel's gradient: max |port - jax.grad| / max |jax.grad| (measured 2.2e-6)
TOL_MEL_GRAD = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs (the suite's parallel run
    gives each worker a share of the cores, as `tests/test_torch_cli.py`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def disc():
    """The JAX MPD and MSD, their parameters (jitted inits) and the port's
    discriminators carrying the same weights through the bridge."""
    mpd, msd = jh.MultiPeriodDiscriminator(), jh.MultiScaleDiscriminator()
    w = jnp.zeros((1, SEG, 1), jnp.float32)
    params = {"mpd": jax.jit(mpd.init)(jax.random.PRNGKey(1), w, w)["params"],
              "msd": jax.jit(msd.init)(jax.random.PRNGKey(2), w, w)["params"]}
    pmpd, pmsd = ph.MultiPeriodDiscriminator(), ph.MultiScaleDiscriminator()
    pmpd.load_state_dict(mpd_state_dict(params["mpd"]))
    pmsd.load_state_dict(msd_state_dict(params["msd"]))
    return dict(mpd=mpd, msd=msd, params=params, pmpd=pmpd, pmsd=pmsd)


def _max_err(got, want):
    """max |got - want| / max(1, max |want|), the tolerance's measure."""
    return float(np.abs(got - want).max() / max(1.0, float(np.abs(want).max())))


def _fmap_to_jax_layout(t):
    """A port feature map (B, C, H, W) or (B, C, T) -> the JAX layout."""
    a = t.detach().numpy()
    return np.moveaxis(a, 1, -1)


@pytest.mark.parametrize("length", [2047, 2048, 2050])
def test_discriminators_match_jax(disc, length):
    """Every logit and feature map of both discriminators, on real and
    generated wavs of a length that is odd or even and leaves different
    remainders modulo the periods (2, 3, 5, 7, 11) and the strides (2, 4)."""
    rng = np.random.default_rng(length)
    y = (0.5 * rng.standard_normal((2, length, 1))).astype(np.float32)
    y_hat = (0.5 * rng.standard_normal((2, length, 1))).astype(np.float32)
    t = lambda a: torch.from_numpy(a).transpose(1, 2)  # noqa: E731
    with torch.no_grad():
        for name in ("mpd", "msd"):
            want = disc[name].apply({"params": disc["params"][name]}, y, y_hat)
            got = disc["p" + name](t(y), t(y_hat))
            for jl, pl in zip(want[:2], got[:2]):  # logits
                assert len(jl) == len(pl)
                for a, b in zip(jl, pl):
                    assert b.shape == a.shape
                    assert _max_err(b.numpy(), np.asarray(a)) <= TOL_FWD
            for jf, pf in zip(want[2:], got[2:]):  # feature maps
                for jd, pd in zip(jf, pf):
                    assert len(jd) == len(pd)
                    for a, b in zip(jd, pd):
                        b = _fmap_to_jax_layout(b)
                        assert b.shape == a.shape
                        assert _max_err(b, np.asarray(a)) <= TOL_FWD


def test_same_padding_and_pooling_lengths():
    """flax SAME under a stride pads the odd one after; the pooled scales
    have ceil(T / 2) frames."""
    assert ph.same_pad(2048, 41, 2) == (19, 20)
    assert ph.same_pad(2048, 41, 4) == (18, 19)
    assert ph.same_pad(2049, 5, 3) == (1, 1)  # H a multiple of 3: not torch's (2, 2)
    assert ph.same_pad(683, 5, 3) == (1, 2)
    x = torch.arange(1.0, 8.0)[None, None]
    want = jax.numpy.asarray(jh.nn.avg_pool(jnp.arange(1.0, 8.0)[None, :, None], (4,),
                                            strides=(2,), padding="SAME"))[0, :, 0]
    np.testing.assert_array_equal(ph.avg_pool_same(x)[0, 0].numpy(), np.asarray(want))


def test_gan_losses_match_jax():
    rng = np.random.default_rng(3)
    shapes = [(2, 17), (2, 40), (2, 9)]
    r = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    g = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    fr = [[rng.standard_normal((2, 4, 5)).astype(np.float32) for _ in range(3)] for _ in r]
    fg = [[rng.standard_normal((2, 4, 5)).astype(np.float32) for _ in range(3)] for _ in r]
    T = lambda xs: [torch.from_numpy(a) for a in xs]  # noqa: E731
    np.testing.assert_allclose(float(ph.discriminator_loss(T(r), T(g))),
                               float(jh.discriminator_loss(r, g)), rtol=1e-6)
    np.testing.assert_allclose(float(ph.generator_loss(T(g))), float(jh.generator_loss(g)),
                               rtol=1e-6)
    np.testing.assert_allclose(float(ph.feature_loss([T(x) for x in fr], [T(x) for x in fg])),
                               float(jh.feature_loss(fr, fg)), rtol=1e-6)


def test_mel_carries_a_gradient_that_matches_jax():
    """`MelSpectrogram.differentiable` keeps the graph; its value is the
    inference call's, and the gradient of a weighted sum of the log-mel
    matches `jax.grad` of the JAX `MelSpectrogram` (DFT as two real
    matmuls) on the same wav, including frames at the log floor."""
    rng = np.random.default_rng(4)
    y = (0.3 * rng.standard_normal((2, SEG))).astype(np.float32)
    y[1, :1500] = 0.0  # frames 0-3 silent: magnitudes at the root's eps, mels clamped
    mel = MelSpectrogram(MelConfig(), device="cpu")
    w = rng.standard_normal((2, mel.num_frames(SEG), 80)).astype(np.float32)
    yt = torch.from_numpy(y).requires_grad_(True)
    out = mel.differentiable(yt)
    np.testing.assert_array_equal(out.detach().numpy(), mel(y).numpy())
    (out * torch.from_numpy(w)).sum().backward()
    jmel = JMel(JMelConfig())
    want_val = np.asarray(jmel(y))
    want = np.asarray(jax.grad(lambda a: jnp.sum(jmel(a) * w))(jnp.asarray(y)))
    assert (want_val[1] <= np.log(1e-5) + 1e-6).any()  # the clamp acts somewhere
    np.testing.assert_allclose(out.detach().numpy(), want_val, atol=TOL_MEL, rtol=0)
    got = yt.grad.numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= TOL_MEL_GRAD * np.abs(want).max()


def _jax_state(disc, gen):
    """`VocoderGAN.init_state`'s state on these parameters; the fresh Adam
    states written out (`optax.adam(...).init`: a zero count and zero
    moments) rather than traced."""
    import optax

    gen_params = jax.jit(gen.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 80)))["params"]

    def fresh(params):
        zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), params)
        return (optax.ScaleByAdamState(count=np.zeros((), np.int32), mu=zeros, nu=zeros),
                optax.EmptyState())

    return VocoderTrainState(step=np.zeros((), np.int32), gen_params=gen_params,
                             disc_params=disc["params"], gen_opt=fresh(gen_params),
                             disc_opt=fresh(disc["params"]),
                             gen_tx=optax.adam(2e-4, *ADAM_BETAS),
                             disc_tx=optax.adam(2e-4, *ADAM_BETAS))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_gan_step_matches_jax(disc):
    """One GAN step of the port against the jitted JAX step, from the JAX
    run's weights and Adam states after one step (carried by the bridge) on
    the same batch: the five metrics within TOL_METRIC, and each updated
    parameter tensor's move (new - old) within TOL_UPDATE of the JAX move
    (relative L2). The port's discriminator pass runs the generator on
    K4/K5's plain versions, the JAX step on its module path."""
    jgen = jh.HiFiGANGenerator(**TINY)
    step = JVocoderGAN(generator=jgen).make_train_step()
    rng = np.random.default_rng(5)
    batches = [{"mel": rng.standard_normal((2, 4, 80)).astype(np.float32),
                "wav": (0.3 * rng.standard_normal((2, 4 * 256, 1))).astype(np.float32)}
               for _ in range(2)]
    state, _ = step(_jax_state(disc, jgen), batches[0])
    before = _np_tree({"gen": state.gen_params, "disc": state.disc_params,
                       "gen_opt": state.gen_opt, "disc_opt": state.disc_opt})

    gen_sd = lambda t: hifigan_state_dict(t, num_ups=3, num_kernels=1)  # noqa: E731
    gan = VocoderGAN(generator=ph.HiFiGANGenerator(**TINY), device="cpu")
    gan.load_weights({"gen": gen_sd(before["gen"]), "disc": disc_state_dict(before["disc"])})
    gan.gen_opt.load_state_dict(plain_adam_state_from_jax(
        before["gen_opt"], gan.generator, gen_sd, 2e-4, ADAM_BETAS))
    gan.disc_opt.load_state_dict(plain_adam_state_from_jax(
        before["disc_opt"], gan.disc, disc_state_dict, 2e-4, ADAM_BETAS))
    flat = lambda w: {f"{k}.{n}": v.clone() for k, sd in w.items()  # noqa: E731
                      for n, v in sd.items()}
    start = flat(gan.weights())

    state, jm = step(state, batches[1])
    got = gan.train_step(batches[1])
    assert set(got) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(got[k]), float(jm[k]), rtol=TOL_METRIC)
    want = flat({"gen": gen_sd(_np_tree(state.gen_params)),
                 "disc": disc_state_dict(_np_tree(state.disc_params))})
    now = flat(gan.weights())
    assert set(now) == set(want)
    for n, w in want.items():
        move = w - start[n]
        assert move.norm() > 0, n
        assert ((now[n] - start[n] - move).norm() / move.norm()).item() <= TOL_UPDATE, n


def _datasets(paths, **cfg):
    c = dict(segment_size=SEG, sample_rate=SR, **cfg)
    return (jvd.VocoderSegmentDataset(paths, jvd.VocoderDataConfig(**c), JMelConfig()),
            pvd.VocoderSegmentDataset(paths, pvd.VocoderDataConfig(**c), MelConfig(),
                                      device="cpu"))


def _same_batch(jb, pb, fine_tuning=False):
    """Equal wav crops bit for bit; the mel equal (fine-tuning: loaded) or
    within the frontend tests' mel tolerances (computed)."""
    np.testing.assert_array_equal(pb["wav"].numpy(), jb["wav"])
    got, want = pb["mel"].numpy(), np.asarray(jb["mel"])
    assert got.shape == want.shape and got.dtype == np.float32
    if fine_tuning:
        np.testing.assert_array_equal(got, want)
        return
    np.testing.assert_allclose(got, want, atol=TOL_MEL_CORPUS, rtol=0)
    above = want > FLOOR_REGION
    np.testing.assert_allclose(got[above], want[above], atol=TOL_MEL, rtol=0)


def test_segment_dataset_matches_jax(tmp_path):
    """Under one seed the port draws the JAX dataset's crops bit for bit
    (`sample_batch` and an epoch of `batches`), pads the short clip with
    zeros, normalises the peak to 0.95 and computes the batch's mel; a wav
    at another rate than the config's raises."""
    paths = _write_wavs(tmp_path)  # 30,000, 9,000 and 1,200 samples
    jds, pds = _datasets(paths)
    assert pds.seg_frames == jds.seg_frames == SEG // 256
    jr, pr = np.random.default_rng(1), np.random.default_rng(1)
    for _ in range(3):
        _same_batch(jds.sample_batch(4, jr), pds.sample_batch(4, pr))
    for jb, pb in zip(jds.batches(2, seed=7, drop_last=False),
                      pds.batches(2, seed=7, drop_last=False), strict=True):
        _same_batch(jb, pb)
    b = pds.sample_batch(8, np.random.default_rng(2))
    assert b["wav"].shape == (8, SEG, 1) and b["mel"].shape == (8, SEG // 256, 80)
    assert b["wav"].abs().max() <= 0.951
    short = _datasets([paths[2]])[1].sample_batch(1, np.random.default_rng(3))["wav"][0, :, 0]
    assert torch.all(short[1200:] == 0) and short[:1200].abs().max() > 0
    other_rate = _datasets(paths[:1])[1]
    other_rate.config = pvd.VocoderDataConfig(segment_size=SEG, sample_rate=16000)
    with pytest.raises(ValueError, match="rate 22050 != expected 16000"):
        other_rate.sample_batch(1, np.random.default_rng(0))


def test_segment_dataset_fine_tuning_matches_jax(tmp_path):
    """Fine-tuning crops: the base mels read from `<stem>.npy` (frame-major
    and channel-major), frame i paired with wav samples [i hop, (i+1) hop),
    the same crops as the JAX dataset bit for bit; a clip shorter than the
    segment zero-pads both."""
    paths = _write_wavs(tmp_path)
    mel_dir = tmp_path / "mels"
    mel_dir.mkdir()
    for k, p in enumerate(paths):
        n_frames = len(load_wav(p)[0]) // 256
        mel = np.tile(np.arange(n_frames, dtype=np.float32)[:, None], (1, 80))
        stem = os.path.splitext(os.path.basename(p))[0]
        np.save(mel_dir / f"{stem}.npy", mel.T if k == 1 else mel)
    jds, pds = _datasets(paths, fine_tuning=True, base_mels_dir=str(mel_dir))
    jr, pr = np.random.default_rng(4), np.random.default_rng(4)
    for _ in range(3):
        jb, pb = jds.sample_batch(6, jr), pds.sample_batch(6, pr)
        _same_batch(jb, pb, fine_tuning=True)
        for i in range(6):
            col = pb["mel"][i, :, 0].numpy()
            wav = pb["wav"][i, :, 0].numpy()
            if col[0] == 0 and col[-1] == 0:  # the short clip: zero-padded
                continue
            np.testing.assert_array_equal(np.diff(col), 1.0)
            m0 = int(col[0])
            for p in paths[:2]:  # the crop is the wav at the mel's frames
                full = load_wav(p)[0]
                if np.array_equal(full[m0 * 256:m0 * 256 + SEG], wav):
                    break
            else:
                raise AssertionError(f"crop {i} is not aligned to its frames")


def test_train_vocoder_cli_end_to_end(tmp_path):
    """`cli.train_vocoder` on the CPU: 2 GAN steps of the tiny generator on
    generated audio write `voc_2` (weights of the generator and both
    discriminators, no optimizer state); a 1-step fine-tune from it on
    base mels restarts the count and writes `voc_1`, starting from
    `voc_2`'s weights."""
    from arttts_tpu_torch.cli import train_vocoder
    from arttts_tpu_torch.core.checkpoint import latest_checkpoint, load_vocoder_checkpoint

    wav_dir = tmp_path / "wavs"
    wav_dir.mkdir()
    paths = _write_wavs(wav_dir, n=2, lengths=(30000, 9000))
    out = tmp_path / "ckpt"
    common = ["--wav-dir", str(wav_dir), "--out-dir", str(out), "--batch-size", "2",
              "--segment-size", str(SEG), "--log-every", "1", "--device", "cpu", *TINY_ARGS]
    assert train_vocoder.main(common + ["--steps", "2", "--save-every", "2"]) == 0
    ck = load_vocoder_checkpoint(str(out / "voc_2"))
    assert ck["step"] == 2 and set(ck) == {"gen", "disc", "step"}
    assert latest_checkpoint(str(out), prefix="voc_") == str(out / "voc_2")
    with torch.device("meta"):  # the names and shapes the CLI's model has
        gen = ph.HiFiGANGenerator(**{**TINY, "upsample_initial_channel": 16})
        discs = torch.nn.ModuleDict({"mpd": ph.MultiPeriodDiscriminator(),
                                     "msd": ph.MultiScaleDiscriminator()})
    gen.load_state_dict(ck["gen"], assign=True)
    discs.load_state_dict(ck["disc"], assign=True)

    mel_dir = tmp_path / "base_mels"
    mel_dir.mkdir()
    mel_fn = MelSpectrogram(MelConfig(), device="cpu")
    for p in paths:
        wav = load_wav(p)[0]
        stem = os.path.splitext(os.path.basename(p))[0]
        np.save(mel_dir / f"{stem}.npy", mel_fn(wav[: len(wav) // 256 * 256]).numpy())
    assert train_vocoder.main(common + ["--steps", "1", "--save-every", "1", "--base-mels-dir",
                                        str(mel_dir), "--init-ckpt", str(out / "voc_2")]) == 0
    ft = load_vocoder_checkpoint(str(out / "voc_1"))
    assert ft["step"] == 1
    moved = [k for k, v in ft["gen"].items() if not torch.equal(v, ck["gen"][k])]
    assert moved and all((ft["gen"][k] - ck["gen"][k]).abs().max() < 1e-2 for k in moved)


def test_vocoder_entries_need_the_card_by_default(monkeypatch, tmp_path):
    """`VocoderGAN`, `VocoderSegmentDataset` and `cli.train_vocoder` take the
    card unless asked for the CPU, and raise where there is none."""
    from arttts_tpu_torch.cli import train_vocoder

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VocoderGAN(generator=ph.HiFiGANGenerator(**TINY))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pvd.VocoderSegmentDataset(_write_wavs(tmp_path, n=1, lengths=(3000,)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_vocoder.main(["--wav-dir", str(tmp_path), "--out-dir", str(tmp_path / "o"),
                            "--steps", "1", *TINY_ARGS])
    assert not (tmp_path / "o").exists()
