"""Config-driven trainer (port of `arttts_tpu/train/trainer.py`): the
object `cli/train.py` builds, for every preset. The preset selects the
model family and, through `config.model.name`, its loss
(`train/losses.py:loss_for_model`: MAS-aligned `grad_tts_loss` or the
duration-aligned `grad_ttartic_loss`).

The epoch loop stays on the host; each step runs on the card
(`train/step.py`, MAS on kernel K6). Batches carry "spk" and "durations"
to the card when the dataset gives them; `language_upsample` draws a
multilingual set's batches by language upsampling. Per epoch: scalar
logging, periodic validation, synthesis samples of a fixed seeded choice
of validation items with their DTW score (with a writer), early
stopping, and `grad_{epoch}` / `grad_best` / `grad_final` checkpoints that
include the optimizer state. Any object with `__len__`,
`__getitem__` -> {"x", "y"[, "spk", "durations"]} and `lengths()` serves
as a dataset.

With `steps_per_dispatch > 1` the JAX package scans K steps in one launch;
its own tests hold that the same trajectory as K sequential steps, and here
every batch takes its step in turn.

Data parallelism (`mesh=` with a "data" axis of n > 1, one process a
device, `cli/train.py --mesh` under `torch.distributed.run`): rank i of
the axis batches its rows of the same global batches at the fixed buckets
`config.data.max_text_len` / `max_frame_len`, draws from its own
generator (seed + i), and steps on the global batch's loss
(`train/step.py`, K6 on its rows; DDP over the "data" axis broadcasts
its first rank's parameters when it wraps the model). Every rank
validates on the whole validation set, as the JAX trainer does; the
early-stopping decision is taken on losses averaged over the ranks, so
all leave the loop together; the mesh's rank (0, 0) alone logs,
synthesises the samples and writes the checkpoints, each followed by a
barrier over the whole mesh, and every rank resumes from the same files.

A "model" axis over 1 replicates the state over it, as the JAX trainer
does (`parallel/tp.py:shard_tp` is the train step's layout, not the
trainer's): the ranks of a model row share their data coordinate, so they
batch the same rows and draw from the same generator, and
`parallel/tp.py:replicate_tp` gives the row its first rank's gradients
each step (on the card the backward's bits differ between ranks), so they
take the same update.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from arttts_tpu_torch.core.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from arttts_tpu_torch.core.config import ExperimentConfig
from arttts_tpu_torch.core.device import resolve
from arttts_tpu_torch.data.batching import DataLoader
from arttts_tpu_torch.eval.metrics import normalized_dtw_score
from arttts_tpu_torch.models.tts import build_model
from arttts_tpu_torch.ops.shape import fix_len_compatibility
from arttts_tpu_torch.parallel.tp import replicate_tp
from arttts_tpu_torch.train.losses import loss_for_model
from arttts_tpu_torch.train.step import data_parallel, eval_step, make_optimizer, train_step
from arttts_tpu_torch.utils.early_stopping import EarlyStopping

log = logging.getLogger("arttts_tpu_torch.train")


class Trainer:
    def __init__(
        self,
        config: ExperimentConfig,
        train_dataset,
        valid_dataset=None,
        log_dir: Optional[str] = None,
        tb_writer=None,
        device="cuda",
        language_upsample: Optional[float] = None,
        mesh=None,
    ):
        """`tb_writer`: a TensorBoard-style writer (`add_scalar`,
        `add_image`), or None for no logging there (rank 0's is used, the
        others' ignored). The model is built from `config.train.random_seed`
        on `device`. `language_upsample`: the training loader's language
        upsampling factor (None: off). `mesh` (`parallel/mesh.py`): data
        parallelism over its "data" axis, the state replicated over its
        "model" axis (see the module note)."""
        self.config = config
        self.loss_fn = loss_for_model(config.model.name)
        self.device = resolve(device)
        t = config.train
        self.model = build_model(config.model, device=self.device, seed=t.random_seed).train()
        self.optimizer = make_optimizer(self.model, t.learning_rate)
        self.mesh = mesh
        host_id, num_hosts = (0, 1) if mesh is None else (mesh.coords["data"],
                                                            mesh.shape["data"])
        self.is_main = mesh is None or mesh.coords == {"data": 0, "model": 0}
        if mesh is not None:
            replicate_tp(mesh, self.model)
        self.ddp = None
        if num_hosts > 1:
            self.ddp = data_parallel(self.model, self.loss_fn, mesh.groups["data"])
            if t.steps_per_dispatch > 1:
                log.warning("steps_per_dispatch=%d: with %d hosts each batch takes its step "
                            "in turn", t.steps_per_dispatch, num_hosts)
        self.log_dir = Path(log_dir or t.log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.tb = tb_writer if self.is_main else None
        # several hosts: fixed pad shapes, so that every rank's batch has one shape
        fixed = num_hosts > 1
        self.train_loader = DataLoader(train_dataset, batch_size=t.batch_size,
                                       seed=t.random_seed, min_frames=t.out_size,
                                       host_id=host_id, num_hosts=num_hosts,
                                       language_upsample=language_upsample,
                                       text_bucket=config.data.max_text_len if fixed else None,
                                       frame_bucket=config.data.max_frame_len if fixed else None)
        self.valid_loader = (
            DataLoader(valid_dataset, batch_size=t.batch_size, shuffle=False,
                       min_frames=t.out_size)
            if valid_dataset is not None else None
        )
        self.valid_dataset = valid_dataset
        # every draw of training (dropout, segment offsets, t, z); each rank its own
        self.generator = torch.Generator(device=self.device).manual_seed(t.random_seed + host_id)
        self.early_stopping = EarlyStopping(patience=t.patience, step_size=t.save_every)
        self.start_epoch = 1
        n_params = sum(p.numel() for p in self.model.parameters())
        log.info("Total parameters: %.2fm", n_params / 1e6)

    def _on_device(self, batch) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.asarray(v)).to(self.device) for k, v in batch.items()}

    # ------------------------------------------------------------------
    def resume(self, ckpt_path: Optional[str] = None) -> int:
        """Restore the weights, optimizer state and early stopping; returns
        the epoch to start from."""
        path = ckpt_path or latest_checkpoint(str(self.log_dir))
        if path is None:
            return 1
        restored = load_checkpoint(path)
        self.model.load_state_dict(restored["model"])
        self.optimizer.load_state_dict(restored["optimizer"])
        if "early_stop" in restored["extra"]:
            self.early_stopping = EarlyStopping.from_state_dict(restored["extra"]["early_stop"])
        self.start_epoch = restored["extra"].get("epoch", restored["step"]) + 1
        log.info("Resumed from %s at epoch %d", path, self.start_epoch)
        return self.start_epoch

    def _barrier(self) -> None:
        """Wait for every rank of the mesh: its "data" column, then its
        "model" row (each column has met before any row meets)."""
        if self.mesh is None:
            return
        for axis in ("data", "model"):
            if self.mesh.groups[axis] is not None:
                dist.barrier(group=self.mesh.groups[axis])

    def _save(self, name: str, epoch: int) -> None:
        if self.is_main:
            extra = {"epoch": epoch, "early_stop": self.early_stopping.state_dict()}
            save_checkpoint(str(self.log_dir), name, self.model.state_dict(),
                            self.optimizer.state_dict(), epoch, extra)
        self._barrier()  # no rank reads a checkpoint before it is whole

    # ------------------------------------------------------------------
    def train_epoch(self, epoch: int) -> Dict[str, float]:
        self.train_loader.set_epoch(epoch)
        t = self.config.train
        agg: Dict[str, list] = {}
        for batch in self.train_loader:
            metrics = train_step(self.model, self.optimizer, self._on_device(batch),
                                 self.generator, t.out_size, t.grad_clip_norm, self.loss_fn,
                                 ddp=self.ddp)
            for k, v in metrics.items():
                agg.setdefault(k, []).append(v)
        # one wait for the card per epoch
        out = {k: float(torch.stack(vs).mean()) for k, vs in agg.items()}
        if self.tb:
            for k, v in out.items():
                self.tb.add_scalar(f"training/{k}", v, epoch)
        return out

    def validate(self, epoch: int) -> Dict[str, float]:
        """Validation losses on full sequences; the same draws every call."""
        if self.valid_loader is None:
            return {}
        generator = torch.Generator(device=self.device).manual_seed(0)
        agg: Dict[str, list] = {}
        for batch in self.valid_loader:
            for k, v in eval_step(self.model, self._on_device(batch), generator,
                                  self.loss_fn).items():
                agg.setdefault(k, []).append(v)
        out = {k: float(torch.stack(vs).mean()) for k, vs in agg.items()}
        if self.tb:
            for k, v in out.items():
                self.tb.add_scalar(f"validation/{k}", v, epoch)
        return out

    def synthesize_samples(self, epoch: int, n_timesteps: int = 50) -> None:
        """Synthesise `test_size` validation items, the seeded choice
        `valid_dataset.sample_test_batch` makes (as the JAX trainer), each
        with its speaker input and, for GradTTArtic, its aligned durations
        rounded up; log the generated features and the alignment as images
        and `validation/dtw_{i}`, the DTW score against the target. The
        images are `utils/plotting.py`'s HWC plots, as the JAX trainer logs
        them, where matplotlib imports, and the arrays scaled to [0, 1]
        where it does not."""
        if self.valid_dataset is None or self.tb is None:
            return
        from arttts_tpu_torch.infer.sampler import frame_bucket, synthesize
        from arttts_tpu_torch.utils.plotting import plot_alignment, plot_tensor

        try:
            import matplotlib  # noqa: F401
            plots = {"generated_dec": plot_tensor, "alignment": plot_alignment}
        except ImportError:
            plots = None
        items = self.valid_dataset.sample_test_batch(
            min(self.config.train.test_size, len(self.valid_dataset)))
        aligned = self.config.model.name == "grad_ttartic"
        self.model.eval()
        try:
            for i, item in enumerate(items):
                x = np.asarray(item["x"])[None]
                spk = np.asarray(item["spk"])[None] if "spk" in item else None
                durations = (np.ceil(item["durations"])[None]
                             if aligned and "durations" in item else None)
                max_frames = frame_bucket(
                    fix_len_compatibility(max(64, 2 * np.asarray(item["y"]).shape[0])))
                _, dec, attn, y_len = synthesize(
                    self.model, self.generator, x, np.array([x.shape[1]], np.int32),
                    n_timesteps=n_timesteps, max_frames=int(max_frames),
                    x_durations=durations, device=self.device, spk=spk)
                L = int(y_len[0])
                dec = dec[0, :L].float().cpu()
                for name, img in (("generated_dec", dec.T), ("alignment", attn[0, :, :L])):
                    img = img.float().cpu().numpy()
                    if plots:
                        self.tb.add_image(f"image_{i}/{name}", plots[name](img), epoch,
                                          dataformats="HWC")
                    else:
                        img = (img - img.min()) / (img.max() - img.min() + 1e-8)
                        self.tb.add_image(f"image_{i}/{name}", img[None], epoch)
                score, _, _ = normalized_dtw_score(dec.numpy(), np.asarray(item["y"]))
                self.tb.add_scalar(f"validation/dtw_{i}", score, epoch)
        finally:
            self.model.train()

    def _log(self, name: str, epoch: int, metrics: Dict[str, float]) -> None:
        if self.is_main:
            with open(self.log_dir / name, "a") as f:
                f.write(f"{epoch}\t{metrics}\n")

    def _mean_over_ranks(self, values: list) -> list:
        """`values` averaged over the data-parallel ranks, so that every rank
        takes the same early-stopping decision."""
        if self.ddp is None:
            return values
        v = torch.tensor(values, dtype=torch.float64, device=self.device)
        dist.all_reduce(v, group=self.ddp.process_group)
        return (v / dist.get_world_size(self.ddp.process_group)).tolist()

    # ------------------------------------------------------------------
    def fit(self, n_epochs: Optional[int] = None) -> Dict[str, float]:
        t = self.config.train
        n_epochs = n_epochs or t.n_epochs
        last_metrics: Dict[str, float] = {}
        for epoch in range(self.start_epoch, n_epochs + 1):
            t0 = time.time()
            train_metrics = self.train_epoch(epoch)
            last_metrics = train_metrics
            log.info(
                "epoch %d: loss=%.4f (dur=%.4f prior=%.4f diff=%.4f) %.1fs",
                epoch,
                train_metrics.get("total_loss", float("nan")),
                train_metrics.get("dur_loss", float("nan")),
                train_metrics.get("prior_loss", float("nan")),
                train_metrics.get("diff_loss", float("nan")),
                time.time() - t0,
            )
            self._log("train.log", epoch, train_metrics)

            val_metrics: Dict[str, float] = {}
            if epoch % t.val_every == 0:
                val_metrics = self.validate(epoch)
                self._log("val.log", epoch, val_metrics)

            if epoch % t.save_every == 0:
                self.synthesize_samples(epoch)  # rank 0's writer only
                self._barrier()
                # without a validation set, early stopping and grad_best
                # follow the training losses
                ref = val_metrics or train_metrics
                losses = self._mean_over_ranks(
                    [ref.get(k, float("inf"))
                     for k in ("prior_loss", "diff_loss", "dur_loss", "total_loss")])
                _, improved = self.early_stopping.step(losses)
                self._save(f"grad_{epoch}", epoch)
                if improved:
                    self._save("grad_best", epoch)
                if self.early_stopping.should_stop:
                    log.info("Early stopping at epoch %d", epoch)
                    break
        self._save("grad_final", n_epochs)
        return last_metrics
