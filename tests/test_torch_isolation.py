"""The PyTorch port stands alone and never falls back to the CPU.

- importing every module of `arttts_tpu_torch` loads no JAX, Flax, Optax
  or `arttts_tpu` module (checked in a fresh interpreter), and no source
  of the package or `chip_smoke.py` names one in an import;
- the kernel modules import without CUDA, and asking for the card where
  there is none raises instead of running on the CPU;
- on CPU tensors the kernel wrappers run their plain versions and count
  no launch; their CUDA side checks every operand before a launch.
"""

import dataclasses
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "arttts_tpu")


def test_port_imports_no_jax_in_a_fresh_interpreter():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import arttts_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(arttts_tpu_torch.__path__,\n"
        "                                                'arttts_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "print(json.dumps({'imported': names, 'loaded': sorted(sys.modules)}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=120)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "arttts_tpu_torch.infer.sampler" in res["imported"]
    assert "arttts_tpu_torch.ops.resblock2d" in res["imported"]
    for mod in ("ops.mrf", "ops.upsample", "infer.chunked", "ops.mas", "train.losses",
                "train.step", "train.trainer", "data.batching", "core.checkpoint",
                "utils.early_stopping", "text.ipa_features", "voxcommunis.utils",
                "voxcommunis.io", "voxcommunis.decoder", "voxcommunis.data", "data.features",
                "data.ms_datasets", "audio.io", "infer.pipeline", "text.cleaners",
                "text.numbers", "text.cmudict", "text.sequence", "text.converters",
                "text.phnms", "data.filelist", "audio.mel", "data.datasets", "core.paths",
                "core.runtime", "models.unet1d", "cli.synthesize", "cli.vocode", "cli.train",
                "voxcommunis.sampler", "eval.metrics", "models.lstm", "models.wav2vec2",
                "models.utmos", "models.wavlm", "models.sparc_encoder", "audio.pitch",
                "eval.utmos_scorer", "eval.quanti", "cli.score", "cli.pipeline",
                "cli.encode_audio", "cli.demo", "utils.reference_weights",
                "parallel.distributed", "parallel.mesh", "parallel.tp", "models.unet2d_sp"):
        assert f"arttts_tpu_torch.{mod}" in res["imported"]
    bad = [m for m in res["loaded"] if m.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_port_sources_name_no_jax_import():
    pat = re.compile(r"^\s*(?:import|from)\s+(" + "|".join(FORBIDDEN) + r")(?:\.|\s|$)", re.M)
    files = sorted((ROOT / "arttts_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    names = {f.relative_to(ROOT).as_posix() for f in files}
    for new in ("text/ipa_features.py", "voxcommunis/__init__.py", "voxcommunis/utils.py",
                "voxcommunis/io.py", "voxcommunis/decoder.py", "voxcommunis/data.py",
                "data/features.py", "data/ms_datasets.py", "audio/io.py", "infer/pipeline.py",
                "text/cleaners.py", "text/numbers.py", "text/cmudict.py", "text/sequence.py",
                "text/converters.py", "text/phnms.py", "data/filelist.py", "audio/mel.py",
                "data/datasets.py", "core/paths.py", "core/runtime.py", "models/unet1d.py",
                "cli/synthesize.py", "cli/vocode.py", "cli/train.py", "voxcommunis/sampler.py",
                "eval/__init__.py", "eval/metrics.py", "models/lstm.py", "models/wav2vec2.py",
                "models/utmos.py", "models/wavlm.py", "models/sparc_encoder.py",
                "audio/pitch.py", "eval/utmos_scorer.py", "eval/quanti.py", "cli/score.py",
                "cli/pipeline.py", "cli/encode_audio.py", "cli/demo.py",
                "utils/reference_weights.py", "parallel/tp.py"):
        assert f"arttts_tpu_torch/{new}" in names, new
    # no read of the JAX package's data files either (its copies live in the port)
    from arttts_tpu_torch.core import paths

    assert paths.CMUDICT_PATH == ROOT / "arttts_tpu_torch" / "resources" / "cmu_dictionary"
    assert paths.CMUDICT_PATH.is_file()
    res = re.compile(r"arttts_tpu[/.]resources|[\"']resources[\"']")
    for f in files:
        text = f.read_text()
        assert not pat.findall(text), f
        assert not res.findall(text), f


def test_kernel_modules_need_no_cuda_until_called(monkeypatch):
    from arttts_tpu_torch.ops import _build, mas, mrf, resblock2d, updown, upsample  # noqa: F401

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="CUDA"):
        _build.library("resblock2d")
    assert "mas" in _build.SOURCES and "mas_path" in _build.SIGNATURES["mas"]


def test_cuda_requests_raise_without_a_card(monkeypatch):
    from arttts_tpu_torch.core import config
    from arttts_tpu_torch.infer import chunked, sampler
    from arttts_tpu_torch.models.hifigan import build_vocoder
    from arttts_tpu_torch.models.tts import build_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = config.get_preset("v2").model
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_vocoder(device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chunked.vocode_chunked(lambda c: c, np.zeros((10, 14), np.float32))
    small = config.ModelConfig(
        name="grad_tts", n_feats=16,
        encoder=config.EncoderConfig(kind="text", n_vocab=149, n_channels=16,
                                     filter_channels=16, filter_channels_dp=16, n_heads=2,
                                     n_layers=1))
    model = build_model(small, device="cpu")
    x = np.ones((1, 5), np.int64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sampler.encode_text(model, x, np.array([5]))  # device defaults to "cuda"
    with pytest.raises(ValueError, match="lives on cpu"):
        sampler.encode_text(model, x, np.array([5]), device="meta")

    from arttts_tpu_torch.core.config import ExperimentConfig
    from arttts_tpu_torch.ops import mas
    from arttts_tpu_torch.train.trainer import Trainer

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(ExperimentConfig(model=small), train_dataset=None)  # device defaults to "cuda"

    class OnCard(torch.Tensor):
        """A CPU tensor that reports a CUDA device, to reach the kernel side."""

        @property
        def device(self):
            return torch.device("cuda")

    value = torch.zeros(1, 3, 5).as_subclass(OnCard)
    with pytest.raises(RuntimeError, match="CUDA kernels need a CUDA device"):
        mas.maximum_path(value, torch.ones(1, 3, 5))  # no plain version on a CUDA tensor


def _mrf_branch(C, k, dilations=(1, 3, 5)):
    from arttts_tpu_torch.ops.mrf import MRFBranch

    n = len(dilations)
    return MRFBranch(w1=torch.zeros(n, C, C, k), b1=torch.zeros(n, C), w2=torch.zeros(n, C, C, k),
                     b2=torch.zeros(n, C), dilations=dilations)


def test_wrappers_take_plain_versions_only_on_cpu():
    from arttts_tpu_torch.ops import resblock2d as rb
    from arttts_tpu_torch.ops import updown

    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 64, 4, 8, generator=g)
    lens = torch.tensor([6], dtype=torch.int32)
    w = rb.BlockWeights(w1=torch.randn(64, 64, 3, 3, generator=g) * 0.05, b1=torch.zeros(64),
                        gn1_w=torch.ones(64), gn1_b=torch.zeros(64))
    before = (rb.resblock2d.launches, updown.downsample2d.launches)
    y = rb.resblock2d([x], lens, None, w, masked_stats=True, eps=1e-5)
    d = updown.downsample2d(x, lens, torch.randn(64, 64, 3, 3, generator=g), torch.zeros(64))
    assert (rb.resblock2d.launches, updown.downsample2d.launches) == before
    assert y.shape == x.shape and d.shape == (1, 64, 2, 4)
    assert rb.resblock2d_plain.cuda_calls == 0
    with pytest.raises(ValueError, match="cpu or cuda"):
        rb.resblock2d([x.to("meta")], lens.to("meta"), None, w, masked_stats=True, eps=1e-5)
    with pytest.raises(ValueError, match="cpu or cuda"):
        updown.conv_transpose2d(x.to("meta"), lens, torch.zeros(64, 64, 4, 4), torch.zeros(64))

    from arttts_tpu_torch.ops import mrf, upsample

    x1 = torch.randn(2, 32, 40, generator=g)
    br = [_mrf_branch(32, k) for k in (3, 7, 11)]
    w_up, b_up = torch.randn(32, 32, 4, generator=g) * 0.1, torch.zeros(32)
    before = (mrf.mrf_stage.launches, upsample.upsample1d.launches)
    s = mrf.mrf_stage(x1, br)
    u = upsample.upsample1d(x1, w_up, b_up, 2, 1)
    assert (mrf.mrf_stage.launches, upsample.upsample1d.launches) == before
    assert s.shape == x1.shape and u.shape == (2, 32, 80)
    assert mrf.mrf_stage_plain.cuda_calls == upsample.upsample1d_plain.cuda_calls == 0
    with pytest.raises(ValueError, match="cpu or cuda"):
        mrf.mrf_stage(x1.to("meta"), br)
    with pytest.raises(ValueError, match="cpu or cuda"):
        upsample.upsample1d(x1.to("meta"), w_up, b_up, 2, 1)

    from arttts_tpu_torch.ops import mas

    value, mask = torch.randn(2, 5, 9, generator=g), torch.ones(2, 5, 9)
    before = mas.maximum_path.launches
    path = mas.maximum_path(value, mask)
    assert mas.maximum_path.launches == before and mas.maximum_path_plain.cuda_calls == 0
    assert path.shape == value.shape and float(path.sum()) == 2 * 9
    with pytest.raises(ValueError, match="cpu or cuda"):
        mas.maximum_path(value.to("meta"), mask.to("meta"))


def test_kernel_operands_are_checked_before_launch():
    """The CUDA side of each wrapper validates shapes, types and contiguity
    before any pointer reaches a kernel (checked here on CPU tensors, with
    no library: the checks raise first)."""
    from arttts_tpu_torch.ops import resblock2d as rb
    from arttts_tpu_torch.ops import updown

    x = torch.zeros(1, 64, 4, 8)
    lens = torch.tensor([8], dtype=torch.int32)
    with pytest.raises(ValueError, match="bias"):
        updown._downsample2d_cuda(None, x, lens, torch.zeros(64, 64, 3, 3), torch.zeros(32))
    with pytest.raises(ValueError, match="bias"):
        updown._conv_transpose2d_cuda(None, x, lens, torch.zeros(64, 64, 4, 4), torch.zeros(65))
    with pytest.raises(ValueError, match="lengths"):
        updown._downsample2d_cuda(None, x, lens.long(), torch.zeros(64, 64, 3, 3),
                                  torch.zeros(64))
    w = rb.BlockWeights(w1=torch.zeros(64, 64, 3, 3), b1=torch.zeros(64), gn1_w=torch.ones(64),
                        gn1_b=torch.zeros(64), w2=torch.zeros(64, 64, 3, 3), b2=torch.zeros(64),
                        gn2_w=torch.ones(64), gn2_b=torch.zeros(64))
    with pytest.raises(ValueError, match="temb"):
        rb._resblock2d_cuda(None, [x], lens, torch.zeros(1, 128), w, True, 1e-5, None)
    with pytest.raises(ValueError, match="input chunk 0"):
        rb._resblock2d_cuda(None, [x.transpose(2, 3)], lens, torch.zeros(1, 64), w, True,
                            1e-5, None)

    from arttts_tpu_torch.ops import mrf, upsample

    x1 = torch.zeros(2, 64, 40)
    br = [_mrf_branch(64, 3), _mrf_branch(64, 11)]
    with pytest.raises(ValueError, match="channels"):
        mrf._mrf_stage_cuda(None, torch.zeros(2, 48, 40), [_mrf_branch(48, 3)], None)
    with pytest.raises(ValueError, match="kernel size"):
        mrf._mrf_stage_cuda(None, x1, [_mrf_branch(64, 5)], None)
    with pytest.raises(ValueError, match="branch 1 w2"):
        mrf._mrf_stage_cuda(None, x1, [br[0], dataclasses.replace(
            br[1], w2=torch.zeros(3, 64, 64, 3))], None)
    with pytest.raises(ValueError, match="dilations"):
        mrf._mrf_stage_cuda(None, x1, [br[0], _mrf_branch(64, 7, (1, 3))], None)
    with pytest.raises(ValueError, match="film a"):
        mrf._mrf_stage_cuda(None, x1, br, (torch.zeros(2, 3, 1, 64), torch.zeros(2, 3, 2, 64)))
    with pytest.raises(ValueError, match="x"):
        mrf._mrf_stage_cuda(None, x1.transpose(1, 2).contiguous().transpose(1, 2), br, None)
    w_up = torch.zeros(64, 32, 4)
    with pytest.raises(ValueError, match="bias"):
        upsample._upsample1d_cuda(None, x1, w_up, torch.zeros(64), 2, 1, 0)
    with pytest.raises(ValueError, match="stride 2, kernel 4"):
        upsample._upsample1d_cuda(None, x1, torch.zeros(64, 32, 16), torch.zeros(32), 8, 4, 0)
    with pytest.raises(ValueError, match="output_padding"):
        upsample._upsample1d_cuda(None, x1, w_up, torch.zeros(32), 2, 1, 2)
    with pytest.raises(ValueError, match="weight"):
        upsample._upsample1d_cuda(None, x1, torch.zeros(32, 32, 4), torch.zeros(32), 2, 1, 0)
    with pytest.raises(ValueError, match="Cin <= 256"):
        upsample._upsample1d_cuda(None, torch.zeros(1, 288, 40), torch.zeros(288, 32, 4),
                                  torch.zeros(32), 2, 1, 0)
    w_off = torch.zeros(1 + w_up.numel())[1:].view(w_up.shape)  # 4 bytes past an aligned start
    with pytest.raises(ValueError, match="16-byte aligned"):
        upsample._upsample1d_cuda(None, x1, w_off, torch.zeros(32), 2, 1, 0)
    assert not upsample.upsample_supported(2, 4, 288, 32)
    assert upsample.upsample_supported(2, 4, 128, 64) and upsample.upsample_supported(2, 4, 64, 32)

    from arttts_tpu_torch.ops import mas

    v = torch.zeros(2, 7, 30)
    tx, ty = torch.tensor([7, 5], dtype=torch.int32), torch.tensor([30, 20], dtype=torch.int32)
    with pytest.raises(ValueError, match="value"):
        mas._maximum_path_cuda(None, v.double(), tx, ty)
    with pytest.raises(ValueError, match="value"):
        mas._maximum_path_cuda(None, v.transpose(1, 2).contiguous().transpose(1, 2), tx, ty)
    with pytest.raises(ValueError, match="value"):
        mas._maximum_path_cuda(None, v[0], tx, ty)
    with pytest.raises(ValueError, match="t_xs"):
        mas._maximum_path_cuda(None, v, tx.long(), ty)
    with pytest.raises(ValueError, match="t_ys"):
        mas._maximum_path_cuda(None, v, tx, torch.tensor([30], dtype=torch.int32))
    with pytest.raises(ValueError, match=">= 1"):
        mas._maximum_path_cuda(None, torch.zeros(2, 7, 0), tx, ty)
    with pytest.raises(ValueError, match="exceeds"):
        mas._maximum_path_cuda(None, torch.zeros(1, mas.MAX_T_X + 1, 1), tx[:1], ty[:1])

    class TooManyWords:  # a library whose plan needs more words than an int counts
        @staticmethod
        def mas_dec_words(B, T_x, T_y):
            return -1

    with pytest.raises(ValueError, match="decision words"):
        mas._maximum_path_cuda(TooManyWords(), v, tx, ty)


def test_artic_entries_need_the_card_by_default(monkeypatch, tmp_path):
    """The articulatory serving entries (`infer/pipeline.py`) take the card
    unless asked for the CPU, and raise where there is none."""
    from arttts_tpu_torch.core import config
    from arttts_tpu_torch.infer import pipeline, sampler
    from arttts_tpu_torch.models.hifigan import build_sparc_vocoder
    from arttts_tpu_torch.models.tts import build_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    exp = config.get_preset("v6")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(exp.model, device="cuda")
    small = dataclasses.replace(exp.model, encoder=dataclasses.replace(
        exp.model.encoder, n_channels=16, filter_channels=16, n_layers=1))
    model = build_model(small, device="cpu")
    item = {"x": np.ones((5, 26), np.float32), "spk": np.zeros(1024, np.float32),
            "durations": np.ones(5, np.float32)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.run_acoustic_inference(exp, model, [item], str(tmp_path / "a"), use_align=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sampler.encode_text(model, item["x"][None], np.array([5]), item["spk"][None])
    np.save(tmp_path / "u.npy", np.zeros((29, 8), np.float32))
    voc = build_sparc_vocoder(device="cpu", channels=32, spk_emb_size=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.run_sparc_vocoder(voc, [str(tmp_path / "u.npy")], np.zeros(1024, np.float32),
                                   str(tmp_path / "w"), pitch_stats=(100.0, 20.0))

    # the single-speaker serving path: mel extraction, the mel vocoder runner
    # and both CLIs (no --device: the card)
    from arttts_tpu_torch.audio.mel import MelSpectrogram
    from arttts_tpu_torch.cli import synthesize, vocode
    from arttts_tpu_torch.models.hifigan import build_vocoder

    with pytest.raises(RuntimeError, match="no CUDA device"):
        MelSpectrogram()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.run_mel_vocoder(build_vocoder(device="cpu", upsample_initial_channel=32),
                                 [str(tmp_path / "u.npy")], str(tmp_path / "w"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthesize.main(["--preset", "v1", "--ckpt", str(tmp_path / "ckpt"), "--filelist",
                         str(tmp_path / "list.txt"), "--save-dir", str(tmp_path / "cli_a")])
    for mode in ("mel", "sparc"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            vocode.main(["--mode", mode, "--torch-ckpt", str(tmp_path / "g.pt"), "--pred-dir",
                         str(tmp_path), "--save-dir", str(tmp_path / "cli_w")])
    assert not (tmp_path / "cli_a").exists() and not (tmp_path / "cli_w").exists()

    # the training CLI (no --device: the card), before any data is read
    from arttts_tpu_torch.cli import train

    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--preset", "v1", "--train-filelist", str(tmp_path / "list.txt"),
                    "--log-dir", str(tmp_path / "cli_t")])
    assert not (tmp_path / "cli_t").exists()
