"""Training steps, as `cli.train` steps a preset: the port's
`train/step.py:train_step` (encoder, MAS on K6, U-Net forward and backward
on the module path, per-group clip, Adam) at the configuration's batch
size, out_size, learning rate and clip.

The traffic file gives the utterance durations (a distribution in seconds;
the batches hold its quantiles, sorted and cut into batches as a
length-grouped sampler cuts them, so every seed does the same work), the
number of distinct batches, and the frames a symbol lasts. The seed draws
the batches' order, symbols and mel frames, and every step's pinned draws
(segment offsets, diffusion times, noise) and dropout masks. The batches
are padded by the port's `data/batching.py:pad_batch` to its default
buckets and made on the device at set-up; the window cycles through them.

Correct: set-up builds the model and its Adam state once, drives them
through the first steps (the window's call, on batches that all differ)
and hands the same objects to the window. The plain reference follows:
- the first `check.steps` steps, from the seed's weights: the first step's
  loss parts, the first gradient as Adam received it (from its state after
  one step), by the worst tensor, and each tensor's change after the last
  of them, by the median tensor;
- the window's own first step, from the model, Adam state and dropout
  stream as the window opened (the reference cannot work out again the
  set-up steps between, which rounding makes differ in their last bits):
  its loss parts, its gradient (from Adam's first moment before and after
  it) and each tensor's change, each by the worst tensor.
Later steps are not compared one by one: the backward's atomic sums differ
in their last bits from run to run, and a near tie in MAS then takes
another path in either of two runs of one seed.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench import harness, seeds
from portbench.harness import Window

PARTS = ("dur_loss", "prior_loss", "diff_loss")


def first_gradient(m0: dict, m1: dict) -> dict:
    """The gradient Adam received in a step, from its first moment before
    and after it (m1 = beta1 m0 + (1 - beta1) g, beta1 = 0.9)."""
    return {n: (m1[n] - 0.9 * m0[n]) / (1 - 0.9) for n in m1}


class Driver:
    def __init__(self, run: harness.Run):
        self.run = run
        self.cfg = run.spec.config
        self.tr = run.spec.traffic
        self.dev = run.device
        self.t = self.cfg["train"]
        self.frame_rate = self.cfg["audio"]["sample_rate"] / self.cfg["audio"]["hop_length"]

    # ---- traffic
    def batches(self):
        """The distinct batches, each a dict of device tensors with its
        pinned draws, and (tokens, frames) of every row."""
        from arttts_tpu_torch.data.batching import pad_batch

        tr, seed, B = self.tr, self.run.seed, self.t["batch_size"]
        n = B * tr["distinct_batches"]
        secs = np.sort(seeds.quantiles(tr["duration_s"], n))
        groups = [secs[i: i + B] for i in range(0, n, B)]
        n_vocab, n_feats = self.cfg["model"]["encoder"]["n_vocab"], self.cfg["model"]["n_feats"]
        out_size = self.t["out_size"]
        batches = []
        for b, grp in enumerate(seeds.shuffled(groups, seed, "batches")):
            g = seeds.rng(seed, "batch", b)
            items = []
            for s in grp:
                frames = int(round(s * self.frame_rate))
                tokens = max(1, int(round(frames / tr["frames_per_symbol"])))
                items.append({"x": g.integers(0, n_vocab, tokens).astype(np.int64),
                              "y": g.standard_normal((frames, n_feats), dtype=np.float32)})
            nb = pad_batch(items, min_frames=out_size)
            batch = {k: torch.as_tensor(v, device=self.dev) for k, v in nb.items()}
            yl = batch["y_lengths"].cpu().numpy()
            max_off = np.maximum(yl - out_size, 0)
            batch["pinned_offsets"] = torch.as_tensor(np.floor(g.random(B) * max_off),
                                                      device=self.dev)
            batch["pinned_t"] = torch.as_tensor(
                np.clip(g.random(B), 1e-5, 1 - 1e-5).astype(np.float32), device=self.dev)
            batch["pinned_z"] = torch.randn((B, out_size, n_feats), device=self.dev,
                                            generator=seeds.generator(self.dev, seed, "z", b))
            rows = [(len(it["x"]), len(it["y"])) for it in items]
            batches.append((batch, rows))
        return batches

    def setup(self):
        self.state, _ = harness.seeded_weights(self.cfg, self.run.seed, self.dev)
        self.batches_ = self.batches()
        self.dropout = lambda: seeds.generator(self.dev, self.run.seed, "dropout")  # noqa: E731
        self.run.phase("weights")
        if self.run.control:
            return
        from arttts_tpu_torch.train import step
        from arttts_tpu_torch.train.losses import loss_for_model

        self.step_mod = step
        self.model = harness.program_model(self.cfg, seeds.clone_state(self.state))
        self.opt = step.make_optimizer(self.model, self.t["learning_rate"])
        self.loss_fn = loss_for_model(self.cfg["model"]["name"])
        self.gen = self.dropout()
        self.run.phase("program")
        n_check = self.tr["check"]["steps"]
        m0 = {n: torch.zeros_like(p) for n, p in self.model.named_parameters()}
        self.steps = 0
        first = []
        for i in range(len(self.batches_)):  # the checked steps, then every batch's shape
            first.append(self.step(i))
            if i == 0:
                m1 = self.moments()
            if i == n_check - 1:
                params = self.params()
        self.seed_side = (first[:n_check], first_gradient(m0, m1), params)

    def step(self, i: int):
        batch, _ = self.batches_[i % len(self.batches_)]
        with torch.profiler.record_function("portbench.train_step"):
            m = self.step_mod.train_step(self.model, self.opt, batch, self.gen,
                                         self.t["out_size"], self.t["grad_clip_norm"],
                                         self.loss_fn)
        self.steps += 1
        return m

    def params(self):
        return {n: p.detach().clone() for n, p in self.model.named_parameters()}

    def moments(self):
        """Adam's first moment of every parameter (zeros before its first step)."""
        return {n: self.opt.state[p]["exp_avg"].clone() if p in self.opt.state
                else torch.zeros_like(p) for n, p in self.model.named_parameters()}

    def snapshot(self) -> dict:
        """The training state as it stands: parameters, Adam's moments and
        step count, the dropout stream, and the batch the next step takes."""
        named = list(self.model.named_parameters())
        steps = {int(self.opt.state[p]["step"]) if p in self.opt.state else 0 for _, p in named}
        if len(steps) != 1:
            raise RuntimeError(f"Adam has stepped the parameters unevenly: {sorted(steps)}")
        return {"params": self.params(), "m": self.moments(),
                "v": {n: self.opt.state[p]["exp_avg_sq"].clone() if p in self.opt.state
                      else torch.zeros_like(p) for n, p in named},
                "t": steps.pop(), "gen": self.gen.get_state(),
                "batch": self.steps % len(self.batches_)}

    # ---- window
    def window(self, tracer) -> Window:
        if self.run.control:
            return Window([], 1.0, 0, 0, [])
        start = self.snapshot()
        records, slice_records = [], []
        t_start = time.perf_counter()
        deadline = t_start + self.run.seconds
        i = 0
        while time.perf_counter() < deadline or i == 0:
            tracer.unit(i)
            k = self.steps % len(self.batches_)
            m = self.step(k)
            rec = {"batch": k, "loss": m["total_loss"], "before_slice": tracer.before_slice}
            records.append(rec)
            if tracer.tracing:
                slice_records.append(rec)
            if i == 0:  # what the check compares of the window's own first step
                self.window_side = ([m], first_gradient(start["m"], self.moments()),
                                    self.params())
            i += 1
        tracer.finish()
        harness.sync(self.dev)
        window_s = time.perf_counter() - t_start
        self.window_start = start
        losses = torch.stack([r["loss"] for r in records]).cpu().numpy() if records else []
        failed = int(np.sum(~np.isfinite(losses)))
        return Window(records, window_s, len(records), failed, slice_records)

    def end_to_end(self, w: Window) -> dict:
        return {"train_utts_per_s": w.attempted * self.t["batch_size"] / w.window_s}

    def free_program(self):
        for name in ("model", "opt"):
            if hasattr(self, name):
                delattr(self, name)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ---- the reference
    def seed_start(self) -> dict:
        return {"params": self.state, "m": None, "v": None, "t": 0, "gen": None, "batch": 0}

    def reference_run(self, start: dict, n_steps: int, n_record: int, tf32=False):
        """The reference stepping `n_steps` from `start` (a `snapshot`, or
        the seed's weights): the losses of the first `n_record` steps, the
        first step's clipped gradient, the parameters after `n_record`
        steps, and a snapshot after all of them."""
        from portbench.reference.tts import Adam, train_loss

        model, _ = harness.reference_models(self.cfg)
        model = harness.reference_on(model, seeds.clone_state(start["params"])).train()
        opt = Adam(model, self.t["learning_rate"], self.t["grad_clip_norm"])
        if start["m"] is not None:
            opt.load(start["m"], start["v"], start["t"])
        gen = self.dropout()
        if start["gen"] is not None:
            gen.set_state(start["gen"])
        losses, first, params = [], None, None
        n_b = len(self.batches_)
        with harness.tf32_mode(tf32):
            for i in range(n_steps):
                batch, _ = self.batches_[(start["batch"] + i) % n_b]
                for p in model.parameters():
                    p.grad = None
                total, parts = train_loss(model, gen, batch, self.t["out_size"])
                total.backward()
                grads = opt.step()
                if first is None:
                    first = grads
                if i < n_record:
                    losses.append({k: v.detach()
                                   for k, v in dict(parts, total_loss=total).items()})
                if i == n_record - 1:
                    params = {n: p.detach().clone() for n, p in model.named_parameters()}
        end = {"params": {n: p.detach() for n, p in model.named_parameters()},
               "m": opt.m, "v": opt.v, "t": opt.t, "gen": gen.get_state(),
               "batch": (start["batch"] + n_steps) % n_b}
        return (losses, first, params), end

    def gaps(self, side, ref, start_params):
        """The compared numbers of one side's steps against the reference's,
        both from `start_params`."""
        (losses, first, params), (r_losses, r_first, r_params) = side, ref
        # the first step's loss parts: a later step's swing between runs of one seed (a
        # near tie in MAS takes another path); the change below covers them
        loss_gap = 0.0
        for k in PARTS + ("total_loss",):
            a, b = float(losses[0][k]), float(r_losses[0][k])
            gap = abs(a - b) / max(abs(b), 1e-12) if math.isfinite(a) else math.inf
            loss_gap = max(loss_gap, gap)
        names = list(r_first)
        g_ref = {n: float(r_first[n].norm()) for n in names}
        d_ref = {n: float((r_params[n] - start_params[n]).norm()) for n in names}
        g_med, d_med = float(np.median(list(g_ref.values()))), float(np.median(list(d_ref.values())))
        # tensors whose reference gradient is nought to rounding move by round-off alone
        moving = [n for n in names if g_ref[n] >= 1e-3 * g_med]
        grad_gap = max(abs(float(first[n].norm()) - g_ref[n]) / max(g_ref[n], g_med)
                       for n in names)
        # each tensor's change: after several steps the median tensor (a MAS path that
        # another run of the seed also takes moves the worst tensor far), after one the
        # worst
        updates = [abs(float((params[n] - start_params[n]).norm()) - d_ref[n])
                   / max(d_ref[n], d_med) for n in moving]
        return {"loss_gap": loss_gap, "grad_gap": grad_gap,
                "update_gap": float(np.median(updates)), "update_gap_worst": max(updates)}

    def check(self, w: Window) -> dict:
        n_check = self.tr["check"]["steps"]
        if self.run.control:
            # the reference in TF32 in the program's place: set-up's steps, then the window's
            seed_side, start = self.reference_run(self.seed_start(), len(self.batches_),
                                                  n_check, tf32=True)
            window_side, _ = self.reference_run(start, 1, 1, tf32=True)
        else:
            seed_side, window_side, start = self.seed_side, self.window_side, self.window_start
        out = self.gaps(seed_side, self.reference_run(self.seed_start(), n_check, n_check)[0],
                        self.state)
        win = self.gaps(window_side, self.reference_run(start, 1, 1)[0], start["params"])
        out.update(window_loss_gap=win["loss_gap"], window_grad_gap=win["grad_gap"],
                   window_update_gap=win["update_gap_worst"],
                   window_update_gap_median=win["update_gap"])
        return out

    # ---- work
    def work(self, records):
        total = 0
        for r in records:
            for tokens, frames in self.batches_[r["batch"]][1]:
                total += self.run.work.train_utterance(tokens, frames, self.t["out_size"])
        return total, 0, 0
