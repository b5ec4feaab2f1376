"""One rank of `arttts_tpu_torch.cli.train --mesh --device cpu` under
`python -m torch.distributed.run`, for
`tests/test_torch_parallel.py::test_cli_train_mesh_under_torchrun`:

    python -m torch.distributed.run --nproc_per_node=2 \
        tests/torch_train_worker.py ROOT TRAIN_LIST VALID_LIST

It joins the launcher's process group, registers a test-width v1 preset
(the widths of `tests/test_torch_train_cli.py:tiny_preset`, buckets of 32
tokens and 128 frames), then runs `cli.train.main` three times on the
phnm3 corpus under ROOT, each finding the group joined: one epoch into
ROOT/logs (with a writer, where tensorboardX imports, so rank 0
synthesises a sample); two epochs resumed from ROOT/logs/grad_1; five
epochs at patience 1 and learning rate 0 into ROOT/stop. It prints
one line `RANK_RESULT {json}`: the checkpoints this rank wrote, the t of
its first step, the resumed run's start, weights and Adam steps, and the
early-stopped run's epochs.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from arttts_tpu_torch.cli import train as cli  # noqa: E402
from arttts_tpu_torch.core import checkpoint  # noqa: E402
from arttts_tpu_torch.core import config as pconfig  # noqa: E402
from arttts_tpu_torch.parallel.distributed import init_distributed  # noqa: E402
from arttts_tpu_torch.train import losses  # noqa: E402
from arttts_tpu_torch.train.trainer import Trainer  # noqa: E402


def preset(name, **train):
    cfg = pconfig.get_preset("v1")
    m = cfg.model
    model = dataclasses.replace(m, encoder=dataclasses.replace(
        m.encoder, n_channels=16, filter_channels=32, filter_channels_dp=16, n_layers=1))
    tiny = dataclasses.replace(
        cfg, name=name, model=model,
        data=dataclasses.replace(cfg.data, max_text_len=32, max_frame_len=128),
        train=dataclasses.replace(cfg.train, batch_size=4, save_every=1, val_every=1,
                                  out_size=16, test_size=1, **train))
    pconfig.register_preset(tiny)


def digest(model) -> str:
    h = hashlib.sha256()
    for v in model.state_dict().values():
        h.update(v.detach().numpy().tobytes())
    return h.hexdigest()


def main():
    root, train_list, valid_list = Path(sys.argv[1]), sys.argv[2], sys.argv[3]
    preset("dp_v1")
    preset("dp_v1_stop", patience=1, learning_rate=0.0)
    common = ["--data-root", str(root), "--train-filelist", train_list, "--valid-filelist",
              valid_list, "--mesh", "--device", "cpu"]
    res = {"saves": [], "t_first_step": None}

    real_save, real_sample_t = torch.save, losses.sample_t

    def save(obj, f, *a, **k):
        res["saves"].append(Path(f).parent.name)
        return real_save(obj, f, *a, **k)

    def sample_t(*a, **k):
        t = real_sample_t(*a, **k)
        if res["t_first_step"] is None:
            res["t_first_step"] = t.tolist()
        return t

    # one process group for the three runs: each `main` finds it joined
    init_distributed(device="cpu")
    checkpoint.torch.save, losses.sample_t = save, sample_t
    first = cli.main(["--preset", "dp_v1", *common, "--log-dir", str(root / "logs"),
                      "--epochs", "1"])
    checkpoint.torch.save = real_save
    res["rank"] = int(os.environ["RANK"])
    # sample synthesis (rank 0, behind a barrier) ran in the first run; the
    # others log nowhere
    cli.tensorboard_writer = lambda log_dir: None
    res["steps_per_epoch"] = len(first.train_loader)

    real_epoch = Trainer.train_epoch
    seen = {}

    def spy(self, epoch):
        if "digest" not in seen:
            saved = checkpoint.load_checkpoint(str(root / "logs" / "grad_1"))["model"]
            seen["equal"] = all(torch.equal(saved[k], v)
                                for k, v in self.model.state_dict().items())
            seen["digest"] = digest(self.model)
            seen["steps"] = sorted({float(s["step"]) for s in self.optimizer.state.values()})
        return real_epoch(self, epoch)

    Trainer.train_epoch = spy
    resumed = cli.main(["--preset", "dp_v1", *common, "--log-dir", str(root / "logs"),
                        "--epochs", "2", "--resume", str(root / "logs" / "grad_1")])
    Trainer.train_epoch = real_epoch
    res.update(resume_start_epoch=resumed.start_epoch, resumed_weights_equal_grad_1=seen["equal"],
               resumed_digest=seen["digest"], resumed_adam_steps=seen["steps"],
               final_digest=digest(resumed.model))

    epochs = []

    def count(self, epoch):
        epochs.append(epoch)
        return real_epoch(self, epoch)

    Trainer.train_epoch = count
    cli.main(["--preset", "dp_v1_stop", *common, "--log-dir", str(root / "stop"),
              "--epochs", "5"])
    res["early_stop_epochs"] = epochs
    torch.distributed.destroy_process_group()
    print("RANK_RESULT " + json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
