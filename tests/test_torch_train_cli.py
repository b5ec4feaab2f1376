"""The port's training entry points end to end on the CPU: `cli.train` on
every preset it trains (v0, v1, v1_1, v3, v5, v5_preblock from filelists;
v6, v6_zhCN and msml1h, with its language upsampling, from VoxCommunis
layouts), a resume from `grad_1`, and the items `Trainer.synthesize_samples`
synthesises: the JAX trainer's seeded choice, with the speaker input and
the aligned durations for GradTTArtic.

Presets run at test widths (`tiny_preset`: encoder 16 channels and one
layer; the 2D U-Net at the kernels' geometry, whose plain versions run on
CPU tensors; the 1D decoders at dim 16) on tiny seeded corpora written per
test. The checks are exact (item identity, step counts, files, weights
equal after a resume) or finiteness; the numerics are held against the JAX
package in `tests/test_torch_train_presets.py` and
`tests/test_torch_artic_train.py`.
"""

import argparse
import dataclasses

import numpy as np
import pytest
import torch

from arttts_tpu_torch.cli import train as ptrain_cli
from arttts_tpu_torch.core import config as pconfig
from arttts_tpu_torch.models.tts import build_model
from arttts_tpu_torch.text.phnms import build_phnm3
from arttts_tpu_torch.train import losses as plosses
from arttts_tpu_torch.train.trainer import Trainer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite's parallel run
    (six pytest workers) shares the machine's cores, and torch's default of
    a thread a core then oversubscribes them (`tests/test_torch_cli.py`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_phnm_corpus(root, n, seed, mel=False):
    """A seeded phnm3 corpus under `root` in the JAX package's layout:
    `phnm3/utt*_phnm3.npy` alignments, SPARC tracks under
    `encoded_audio_en/emasrc`, and (`mel`) 22.05 kHz wavs under `wavs/`;
    returns the filelist's path."""
    r = np.random.default_rng(seed)
    (root / "phnm3").mkdir(parents=True, exist_ok=True)
    (root / "encoded_audio_en" / "emasrc").mkdir(parents=True, exist_ok=True)
    if mel:
        from arttts_tpu_torch.audio.io import save_wav

        (root / "wavs").mkdir(exist_ok=True)
    lines = []
    for i in range(n):
        k = 4 + int(r.integers(0, 4))
        bounds = np.concatenate([[0.0], np.cumsum(r.uniform(0.06, 0.16, k))])
        phones = list(r.choice(["h", "ə", "l", "oʊ", "t", "s", "aɪ", "n"], k))
        stem = f"utt{seed}_{i:03d}"
        np.save(root / "phnm3" / f"{stem}_phnm3.npy", build_phnm3(phones, bounds))
        np.save(root / "encoded_audio_en" / "emasrc" / f"{stem}.npy",
                r.standard_normal((int(bounds[-1] * 50) + 1, 14)).astype(np.float32))
        if mel:
            t = np.arange(int(22050 * bounds[-1])) / 22050.0
            save_wav(root / "wavs" / f"{stem}.wav",
                     (0.2 * np.sin(2 * np.pi * (140 + 20 * i) * t)
                      + 0.02 * r.standard_normal(t.size)).astype(np.float32), 22050)
        lines.append(f"DUMMY/wavs/{stem}.wav|DUMMY/phnm3/{stem}_phnm3.npy")
    fl = root / f"list{seed}.txt"
    fl.write_text("\n".join(lines))
    return fl


def write_text_corpus(root, n, seed):
    """A seeded text corpus (`wav|text` rows, SPARC tracks under
    `encoded/emasrc`) for v0's text_artic dataset; returns the filelist."""
    texts = ["the quick brown fox.", "printing was done.", "a list of files on one card.",
             "four sentences make a batch."]
    r = np.random.default_rng(seed)
    (root / "encoded" / "emasrc").mkdir(parents=True, exist_ok=True)
    lines = []
    for i in range(n):
        np.save(root / "encoded" / "emasrc" / f"txt{seed}_{i:03d}.npy",
                r.standard_normal((int(r.integers(40, 70)), 14)).astype(np.float32))
        lines.append(f"DUMMY/wavs/txt{seed}_{i:03d}.wav|{texts[i % len(texts)]}")
    fl = root / f"text{seed}.txt"
    fl.write_text("\n".join(lines))
    return fl


VOX_PHONES = ["a", "t", "t͡ʃ", "aɪ", "kʰ", "SIL", "ɛ", "i", "o", "m", "n", "s"]


def write_vox_corpus(root, langs, n, seed):
    """A seeded VoxCommunis layout under `root`: per language a manifest
    (`manifests/{lang}.tsv`), a 100 Hz alignment (`alignments/{lang}.align`,
    phone runs of even length, so the 50 Hz durations are whole), SPARC
    tracks of as many 50 Hz frames under `encoded_audio_multi/{lang}/emasrc`
    and 1024-d speaker pre-embeddings under `spk_preemb`."""
    r = np.random.default_rng(seed)
    (root / "manifests").mkdir(parents=True, exist_ok=True)
    (root / "alignments").mkdir(parents=True, exist_ok=True)
    for lang in langs:
        enc = root / "encoded_audio_multi" / lang
        (enc / "emasrc").mkdir(parents=True, exist_ok=True)
        (enc / "spk_preemb").mkdir(parents=True, exist_ok=True)
        rows, aligns = [str(root / "wavs")], []
        for i in range(n):
            fid = f"cv_{lang}_{lang}_{i:04d}"
            seq = []
            for p in r.choice(VOX_PHONES, int(r.integers(5, 12))):
                seq += [str(p)] * (2 * int(r.integers(1, 5)))
            frames = len(seq) // 2
            art = r.standard_normal((frames, 14)).astype(np.float32)
            art[:, 13] = np.abs(art[:, 13]) + 0.1
            np.save(enc / "emasrc" / f"{fid}.npy", art)
            np.save(enc / "spk_preemb" / f"{fid}.npy",
                    r.standard_normal(1024).astype(np.float32))
            rows.append(f"{lang}/{fid}.wav\t{frames * 320}")
            aligns.append(f"{fid}\t{' '.join(seq)}")
        (root / "manifests" / f"{lang}.tsv").write_text("\n".join(rows) + "\n")
        (root / "alignments" / f"{lang}.align").write_text("\n".join(aligns) + "\n")


def tiny_preset(name, **train):
    """Preset `name` at test widths (encoder 16 channels, one layer; the 1D
    decoders at dim 16, the 2D U-Net at its own, the kernels' geometry, so
    sample synthesis takes the kernel path), batch 2, one synthesised
    sample, a checkpoint every epoch, registered as `tiny_{name}`; its data
    settings are the preset's own."""
    cfg = pconfig.get_preset(name)
    m = cfg.model
    decoder = m.decoder if m.decoder.kind == "unet2d" else dataclasses.replace(m.decoder, dim=16)
    model = dataclasses.replace(
        m, encoder=dataclasses.replace(m.encoder, n_channels=16, filter_channels=32,
                                       filter_channels_dp=16, n_layers=1), decoder=decoder)
    train = {"test_size": 1, **train}
    tiny = dataclasses.replace(cfg, name=f"tiny_{name}", model=model, train=dataclasses.replace(
        cfg.train, batch_size=2, save_every=1, val_every=1, out_size=16, **train))
    pconfig.register_preset(tiny)
    return tiny


@pytest.fixture
def preset_registry():
    """Registers tiny presets through `make(name, **train)` and removes
    them after the test."""
    made = []

    def make(name, **train):
        made.append(tiny_preset(name, **train))
        return made[-1]

    yield make
    for cfg in made:
        del pconfig.PRESETS[cfg.name]


def _cli_args(preset, root):
    """`cli.train`'s data flags for `preset` on the corpora written under
    `root` (train: 4 utterances a language, validation: 2 or the same
    layout), as a user passes them."""
    kind = pconfig.get_preset(preset).data.dataset
    if kind == "ms_phnm_artic":
        langs = {"v6": ["it"], "v6_zhCN": ["zh-CN"], "msml1h": ["it", "fr"]}[preset]
        write_vox_corpus(root, langs, 4, seed=1)
        extra = ["--separate-files"] if preset == "msml1h" else []
        return ["--manifest", str(root / "manifests"), "--alignment", str(root / "alignments"),
                "--valid-filelist", "same-layout", *extra]
    if kind == "text_artic":
        train, valid = write_text_corpus(root, 4, 1), write_text_corpus(root, 2, 2)
    else:
        train = write_phnm_corpus(root, 4, 1, mel=kind == "phnm_mel")
        valid = write_phnm_corpus(root, 2, 2, mel=kind == "phnm_mel")
    return ["--artic-dir", str(root / "encoded"), "--train-filelist", str(train),
            "--valid-filelist", str(valid)]


PRESETS = ["v0", "v1", "v1_1", "v3", "v5", "v5_preblock", "v6", "v6_zhCN", "msml1h"]


@pytest.mark.parametrize("preset", PRESETS)
def test_cli_train_trains_each_preset(preset, preset_registry, tmp_path):
    """`python -m arttts_tpu_torch.cli.train --device cpu` at test widths:
    one epoch (two batches) with validation, one synthesised sample and its
    DTW score where a writer is, and the checkpoints; finite losses, the
    weights moved, the family's loss. msml1h draws its batches by its
    preset's language upsampling (0.9) over two languages."""
    cfg = preset_registry(preset)
    trainer = ptrain_cli.main(["--preset", cfg.name, "--data-root", str(tmp_path),
                               *_cli_args(preset, tmp_path), "--log-dir",
                               str(tmp_path / "logs"), "--epochs", "1", "--device", "cpu"])
    seeded = build_model(cfg.model, device="cpu", seed=cfg.train.random_seed).state_dict()
    state = trainer.model.state_dict()
    assert any(not torch.equal(seeded[k], v) for k, v in state.items())
    assert all(torch.isfinite(v).all() for v in state.values())
    aligned = cfg.model.name == "grad_ttartic"
    assert trainer.loss_fn is (plosses.grad_ttartic_loss if aligned else plosses.grad_tts_loss)
    sampler = trainer.train_loader.lang_sampler
    assert (sampler is not None) == (preset == "msml1h")
    if sampler is not None:
        assert trainer.train_loader.dataset.langs == ["fr", "it"]
        np.testing.assert_allclose(sampler.probas, [0.5, 0.5])  # equal sizes
    assert len(trainer.train_loader) == (4 if preset == "msml1h" else 2)
    for name in ("grad_1", "grad_best", "grad_final"):
        assert (tmp_path / "logs" / name / "state.pt").exists()
    val = (tmp_path / "logs" / "val.log").read_text()
    assert val.startswith("1\t") and ("dur_loss" in val) != aligned and "diff_loss" in val
    steps = {float(s["step"]) for s in trainer.optimizer.state.values()}
    assert steps == {float(len(trainer.train_loader))}


@pytest.mark.parametrize("preset", ["v1", "v6"])
def test_cli_train_resumes(preset, preset_registry, tmp_path):
    """An epoch through `cli.train`, then `--resume` from `grad_1` for a
    second: the resumed run starts at epoch 2 with Adam's step count
    restored and the saved weights. `--mesh` without a launcher is a world
    of one: its epoch gives the first run's weights bit for bit."""
    cfg = preset_registry(preset)
    common = ["--preset", cfg.name, "--data-root", str(tmp_path), *_cli_args(preset, tmp_path),
              "--log-dir", str(tmp_path / "logs"), "--device", "cpu"]
    first = ptrain_cli.main(common + ["--epochs", "1"])
    saved = {k: v.clone() for k, v in first.model.state_dict().items()}
    n = len(first.train_loader)
    resumed = []
    real_epoch = Trainer.train_epoch

    def spy(self, epoch):
        resumed.append((epoch, {k: v.clone() for k, v in self.model.state_dict().items()},
                        {float(s["step"]) for s in self.optimizer.state.values()}))
        return real_epoch(self, epoch)

    Trainer.train_epoch = spy
    try:
        second = ptrain_cli.main(common + ["--epochs", "2", "--resume",
                                           str(tmp_path / "logs" / "grad_1")])
    finally:
        Trainer.train_epoch = real_epoch
    meshed = ptrain_cli.main(common + ["--epochs", "1", "--mesh", "--log-dir",
                                       str(tmp_path / "mesh_logs")])
    assert all(torch.equal(saved[k], v) for k, v in meshed.model.state_dict().items())
    assert second.start_epoch == 2 and [e for e, _, _ in resumed] == [2]
    assert resumed[0][2] == {float(n)}
    assert all(torch.equal(saved[k], v) for k, v in resumed[0][1].items())
    assert {float(s["step"]) for s in second.optimizer.state.values()} == {2.0 * n}
    assert (tmp_path / "logs" / "grad_2" / "state.pt").exists()


class _Recorder:
    """A writer that keeps what the trainer logs."""

    def __init__(self):
        self.scalars, self.images = {}, {}

    def add_scalar(self, tag, value, step):
        self.scalars[tag] = value

    def add_image(self, tag, img, step, dataformats="CHW"):
        self.images[tag] = img


@pytest.mark.parametrize("preset", ["v1", "v6"])
def test_synthesize_samples_takes_the_jax_trainers_items(preset, preset_registry, tmp_path,
                                                        monkeypatch):
    """`Trainer.synthesize_samples` synthesises the JAX trainer's items,
    `default_rng(37).choice(len, test_size, replace=False)` of the
    validation set (not its first ones), each with its speaker input and,
    for GradTTArtic, `ceil(durations)`; a finite DTW score is logged for
    each."""
    from arttts_tpu_torch.data.datasets import build_dataset
    from arttts_tpu_torch.infer import sampler

    cfg = preset_registry(preset, test_size=3)
    args = argparse.Namespace(
        data_root=str(tmp_path), cmudict=None, artic_dir=None, mel_cache=None,
        manifest=str(tmp_path / "manifests"), alignment=str(tmp_path / "alignments"),
        separate_files=False)
    if preset == "v6":
        write_vox_corpus(tmp_path, ["it"], 7, seed=3)
        fl = None
    else:
        fl = str(write_phnm_corpus(tmp_path, 7, seed=3))
    valid = build_dataset(cfg, args, fl, device="cpu")
    rec = _Recorder()
    trainer = Trainer(cfg, valid, valid_dataset=valid, tb_writer=rec, device="cpu",
                      log_dir=str(tmp_path / "logs"))
    seen = []
    real = sampler.synthesize

    def spy(model, generator, x, x_lengths, **kw):
        seen.append((np.asarray(x)[0], kw["spk"], kw["x_durations"]))
        return real(model, generator, x, x_lengths, **kw)

    monkeypatch.setattr(sampler, "synthesize", spy)
    trainer.synthesize_samples(1, n_timesteps=2)
    want = np.random.default_rng(37).choice(len(valid), 3, replace=False)
    assert len(seen) == 3 and sorted(want) != [0, 1, 2]
    for (x, spk, dur), i in zip(seen, want):
        item = valid[int(i)]
        np.testing.assert_array_equal(x, item["x"])
        if preset == "v6":
            np.testing.assert_array_equal(spk, item["spk"][None])
            np.testing.assert_array_equal(dur, np.ceil(item["durations"])[None])
        else:
            assert spk is None and dur is None  # single speaker, MAS-aligned
    assert sorted(rec.scalars) == [f"validation/dtw_{i}" for i in range(3)]
    assert all(np.isfinite(v) and v > 0 for v in rec.scalars.values())
    assert len(rec.images) == 6 and trainer.model.training
