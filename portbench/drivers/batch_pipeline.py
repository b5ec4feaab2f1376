"""Batched synthesis of a test set, as `cli.pipeline --batch-size N` runs
it for the articulatory models: successive chunks of items through the
port's `infer/pipeline.py:run_acoustic_inference_batched` (artifacts on
disk), then `run_sparc_vocoder` (wavs on disk), under `TMPDIR`.

The traffic file gives the chunk's size, the batch size, the number of
speakers, the utterance durations (a distribution in seconds; every chunk
holds the same quantiles, so every seed does the same work), the frames a
phone lasts on average and the solver's steps. The seed draws each item's
phone features (ternary, with the duration column), how its frames split
over its phones, its speaker, the speakers' pre-embeddings, the vocoder's
speaker vector and pitch statistics, and each chunk's noise.

Correct: after the window, a sample of the finished items drawn from the
seed, the longest among them, is synthesized again by the plain reference
at its batch's buckets with the same noise, denormalised and vocoded
through the same windows; the decoder rows, the input map and the wav are
compared.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from portbench import harness, seeds
from portbench.harness import Window


class Items:
    """A chunk as the pipeline reads a dataset: `len`, items by index and
    a manifest of ids."""

    def __init__(self, items, chunk: int):
        self.items = items
        self.manifest = [(f"c{chunk:04d}_{k:03d}", None) for k in range(len(items))]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


class Driver:
    def __init__(self, run: harness.Run):
        self.run = run
        self.cfg = run.spec.config
        self.tr = run.spec.traffic
        self.dev = run.device
        self.rate = self.cfg["audio"]["frame_rate"]
        base = Path(os.environ.get("TMPDIR") or tempfile.gettempdir())
        # the run's artifacts and wavs, removed after its check (no cache: one a process)
        self.out = base / f"portbench-{run.workload}-{os.getpid()}"

    # ---- traffic
    def chunk(self, c: int):
        """Chunk c's items: {"x" (T_x, 26), "spk" (1024,), "durations"}."""
        tr, seed = self.tr, self.run.seed
        secs = seeds.quantiles(tr["duration_s"], tr["chunk_items"])
        n_feat = self.cfg["model"]["encoder"]["n_input_feats"] - 1
        items = []
        for k, s in enumerate(seeds.shuffled(secs, seed, "chunk", c)):
            g = seeds.rng(seed, "item", c, k)
            frames = int(round(s * self.rate))
            n = max(1, int(round(frames / tr["frames_per_phone"])))
            cuts = np.sort(g.choice(np.arange(1, frames), n - 1, replace=False))
            dur = np.diff(np.concatenate([[0], cuts, [frames]])).astype(np.float32)
            x = np.concatenate([g.integers(-1, 2, (n, n_feat)).astype(np.float32),
                                dur[:, None]], axis=1)
            spk = self.speakers[int(g.integers(0, tr["speakers"]))]
            items.append({"x": x, "spk": spk, "durations": x[:, -1].astype(np.float32)})
        return items

    def setup(self):
        tr, seed = self.tr, self.run.seed
        self.state, self.voc_state = harness.seeded_weights(self.cfg, seed, self.dev)
        g = seeds.rng(seed, "speakers")
        self.speakers = g.standard_normal((tr["speakers"], self.cfg["model"]["spk_preemb_dim"]),
                                          dtype=np.float32)
        self.spk_ft = g.standard_normal(self.cfg["vocoder"]["spk_ft_size"], dtype=np.float32)
        ps = self.cfg["assumed"]["pitch_stats"]
        self.pitch_stats = (float(g.uniform(*ps["mean_hz"])), float(g.uniform(*ps["std_hz"])))
        shutil.rmtree(self.out, ignore_errors=True)
        self.run.phase("weights")
        if self.run.control:
            return
        from arttts_tpu_torch.infer import pipeline

        self.pipeline = pipeline
        self.pcfg = harness.program_config(self.cfg)
        self.model = harness.program_model(self.cfg, seeds.clone_state(self.state))
        self.vocoder = harness.program_vocoder(self.cfg, seeds.clone_state(self.voc_state))
        self.run.phase("program")
        # the chunk's shapes: its batches' buckets at one solver step, and the
        # vocoder's one window shape on two tracks
        self.run_chunk(-1, self.chunk(0), n_timesteps=1, vocode=2)
        shutil.rmtree(self.out, ignore_errors=True)

    def chunk_seed(self, c: int) -> int:
        return seeds.derive(self.run.seed, "noise", c)

    def run_chunk(self, c: int, items, n_timesteps=None, vocode=None):
        d = self.out / f"chunk{c}"
        with torch.profiler.record_function("portbench.acoustic"):
            paths = self.pipeline.run_acoustic_inference_batched(
                self.pcfg, self.model, Items(items, c), str(d / "art"),
                batch_size=self.tr["batch_size"],
                n_timesteps=n_timesteps or self.tr["n_timesteps"], seed=self.chunk_seed(c),
                solver=self.tr["solver"], device=self.dev)
        t = time.perf_counter()
        with torch.profiler.record_function("portbench.vocode"):
            wavs = self.pipeline.run_sparc_vocoder(
                self.vocoder, paths[:vocode], self.spk_ft, str(d / "wav"), self.pitch_stats,
                sample_rate=self.cfg["audio"]["sample_rate"], device=self.dev)
        return paths, wavs, time.perf_counter() - t

    # ---- window
    def window(self, tracer) -> Window:
        if self.run.control:
            return self.control_window()
        records, slice_records, vocode_s = [], [], 0.0
        t_start = time.perf_counter()
        deadline = t_start + self.run.seconds
        c = 0
        while time.perf_counter() < deadline:
            tracer.unit(c)
            items = self.chunk(c)
            paths, wavs, v_s = self.run_chunk(c, items)
            if tracer.before_slice:
                vocode_s += v_s
            # the pipeline saves in its own (length) order; files carry the item's id
            art = {Path(p).stem: p for p in paths}
            wav = {Path(w).stem: w for w in wavs}
            ids = Items(items, c).manifest
            recs = [{"chunk": c, "item": k, "tokens": it["x"].shape[0],
                     "frames": int(np.ceil(it["durations"]).sum()),
                     "art": art.get(ids[k][0]), "wav": wav.get(ids[k][0]),
                     "before_slice": tracer.before_slice}
                    for k, it in enumerate(items)]
            records += recs
            if tracer.tracing:
                slice_records += recs
            c += 1
        tracer.finish()
        window_s = time.perf_counter() - t_start
        failed = sum(r["wav"] is None or not Path(r["wav"]).exists() for r in records)
        return Window(records, window_s, len(records), failed, slice_records, vocode_s)

    def end_to_end(self, w: Window) -> dict:
        return {"audio_s_per_s": sum(r["frames"] for r in w.records) / self.rate / w.window_s}

    def free_program(self):
        for name in ("model", "vocoder"):
            if hasattr(self, name):
                delattr(self, name)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ---- the reference
    def reference(self):
        if not hasattr(self, "_ref"):
            model, voc = harness.reference_models(self.cfg)
            self._ref = (harness.reference_on(model, self.state),
                         harness.reference_on(voc, self.voc_state))
        return self._ref

    def reference_chunk_items(self, c: int, picks, tf32=False):
        """The reference's (dec (L, 14), input map (L,), wav) of chunk c's
        items `picks`: the port's batching plan worked out again, the
        chunk's noise drawn batch by batch in the same order."""
        from portbench.reference.tts import aligned_item, batch_plan
        from portbench.reference.vocoders import vocode_windows

        model, voc = self.reference()
        items = self.chunk(c)
        plan = batch_plan([it["x"].shape[0] for it in items],
                          [it["durations"] for it in items], self.tr["batch_size"])
        g = torch.Generator(device=self.dev).manual_seed(self.chunk_seed(c))
        sp = self.cfg["sparc"]
        reorder = sp["reorder"]
        out = {}
        mu_p, std_p = self.pitch_stats
        spk_ft = torch.as_tensor(self.spk_ft, device=self.dev)[None]
        with harness.tf32_mode(tf32), torch.no_grad():
            for idx, t_x, frames in plan:
                noise = torch.randn((len(idx), frames, self.cfg["model"]["n_feats"]),
                                    generator=g, device=self.dev)
                for j, i in enumerate(idx):
                    if i not in picks:
                        continue
                    it = items[i]
                    _, dec, attn = aligned_item(
                        model, torch.as_tensor(it["x"], device=self.dev),
                        torch.as_tensor(it["durations"], device=self.dev),
                        torch.as_tensor(it["spk"], device=self.dev), t_x, frames,
                        self.tr["n_timesteps"], noise[j])
                    feats = dec[:, reorder].cpu().numpy()
                    imap = attn.cpu().numpy().argmax(axis=0)
                    den = feats.copy()
                    den[:, 12] = den[:, 12] * std_p + mu_p

                    def apply(batch):
                        c_ = torch.as_tensor(batch, device=self.dev)
                        return voc(c_, spk_ft.expand(c_.shape[0], -1)).cpu().numpy()

                    wav = vocode_windows(apply, den.astype(np.float32), sp["chunk"],
                                         sp["halo"], sp["win_batch"])
                    out[i] = (feats, imap, np.clip(wav, -1.0, 1.0))
        return out

    def control_window(self) -> Window:
        n = self.tr["check"]["control_items"]
        out = self.reference_chunk_items(0, set(range(n)), tf32=True)
        records = [{"chunk": 0, "item": i, "control": out[i], "frames": len(out[i][1]),
                    "tokens": 0} for i in range(n)]
        return Window(records, 1.0, n, 0, [])

    def sample(self, records):
        k = min(self.tr["check"]["sample"], len(records))
        longest = max(records, key=lambda r: r["frames"])
        rest = [r for r in records if r is not longest]
        pick = seeds.rng(self.run.seed, "check").permutation(len(rest))[: k - 1]
        return [longest] + [rest[i] for i in sorted(pick)]

    def check(self, w: Window) -> dict:
        from scipy.io import wavfile

        chosen = w.records if self.run.control else self.sample(w.records)
        by_chunk = {}
        for r in chosen:
            by_chunk.setdefault(r["chunk"], set()).add(r["item"])
        refs = {c: self.reference_chunk_items(c, picks) for c, picks in by_chunk.items()}
        feat_err = wav_err = 0.0
        mismatched = 0
        for r in chosen:
            feats_r, imap_r, wav_r = refs[r["chunk"]][r["item"]]
            if self.run.control:
                feats, imap, wav = r["control"]
            else:
                art = np.load(r["art"])
                n = (art.shape[0] - 1) // 2
                feats, imap = art[n: 2 * n].T, art[2 * n].astype(np.int64)
                wav = wavfile.read(r["wav"])[1].astype(np.float32) / 32767.0
            if feats.shape != feats_r.shape or not np.array_equal(imap, imap_r) \
                    or wav.shape != wav_r.shape:
                mismatched += 1
                continue
            feat_err = max(feat_err, float(np.abs(feats - feats_r).max())
                           / max(float(np.abs(feats_r).max()), 1e-6))
            wav_err = max(wav_err, float(np.abs(wav - wav_r).max())
                          / max(float(np.abs(wav_r).max()), 1e-6))
        if not self.run.control:
            shutil.rmtree(self.out, ignore_errors=True)
        return {"feat_err": feat_err, "wav_err": wav_err, "length_mismatch": float(mismatched)}

    # ---- work
    def work(self, records):
        ops = k1 = k1_bytes = 0
        for r in records:
            a, b, c = self.run.work.utterance(r["tokens"], r["frames"], self.tr["n_timesteps"])
            ops, k1, k1_bytes = ops + a, k1 + b, k1_bytes + c
        return ops, k1, k1_bytes
