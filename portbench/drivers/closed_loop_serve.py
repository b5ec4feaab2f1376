"""Closed-loop serving: clients that each send a request, wait for its
waveform on the host, and send the next, through the port's request path
`infer/sampler.py:serve_text_to_wav` at B=1.

The traffic file gives the utterance durations (a distribution in seconds),
the request pool's size, the solver and its steps. The pool holds the
durations at the distribution's quantiles, the same set for every seed, in
rounds of one request from each length stratum, so that a window of whole
rounds serves the same mix whatever the seed; the seed draws the order, the
symbols and each request's noise. A symbol
lasts the configuration's `frames_per_symbol` frames (the duration
projection is set so), so a duration maps to a symbol count.

Correct: after the window, a sample of the finished requests drawn from the
seed, the longest among them, is served again by the plain reference on
the same symbols and the same noise; the waveforms are compared sample by
sample over their valid length, and the lengths and buckets exactly.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from portbench import harness, seeds
from portbench.harness import Window


class Driver:
    def __init__(self, run: harness.Run):
        self.run = run
        self.cfg = run.spec.config
        self.tr = run.spec.traffic
        self.dev = run.device
        self.fps = self.cfg["assumed"]["frames_per_symbol"]
        self.frame_rate = self.cfg["audio"]["sample_rate"] / self.cfg["audio"]["hop_length"]

    # ---- traffic
    def pool(self) -> List[dict]:
        secs = seeds.quantiles(self.tr["duration_s"], self.tr["pool"])
        n_vocab = self.cfg["model"]["encoder"]["n_vocab"]
        out = []
        order = seeds.in_rounds(secs, self.tr["strata"], self.run.seed, "pool")
        for j, s in enumerate(order):
            n = max(1, int(round(s * self.frame_rate / self.fps)))
            ids = seeds.rng(self.run.seed, "symbols", j).integers(0, n_vocab, n)
            out.append({"index": j, "symbols": ids.astype(np.int64), "seconds": float(s)})
        return out

    # ---- set-up
    def setup(self):
        self.state, self.voc_state = harness.seeded_weights(self.cfg, self.run.seed, self.dev)
        self.requests = self.pool()
        self.run.phase("weights")
        if self.run.control:
            return
        self.model = harness.program_model(self.cfg, seeds.clone_state(self.state))
        self.vocoder = harness.program_vocoder(self.cfg, seeds.clone_state(self.voc_state))
        from arttts_tpu_torch.infer import sampler

        self.sampler = sampler
        self.run.phase("program")
        # every frame bucket this pool reaches, once each, one solver step
        # (the shapes are those of every step; nothing else is warmed)
        seen = {}
        for r in self.requests:
            seen.setdefault(self.bucket_of(len(r["symbols"])), r)
        for r in seen.values():
            self.serve(r, n_timesteps=1)

    def bucket_of(self, n_symbols: int) -> int:
        from portbench.reference.tts import fix_len, frame_bucket

        return frame_bucket(min(fix_len(max(n_symbols * self.fps, 4)), 2048))

    def noise_generator(self, r):
        return seeds.generator(self.dev, self.run.seed, "noise", r["index"])

    def serve(self, r, n_timesteps=None):
        x = torch.as_tensor(r["symbols"])[None]
        xl = torch.tensor([x.shape[1]], dtype=torch.int32)
        with torch.profiler.record_function("portbench.request"):
            wav, y_len, bucket = self.sampler.serve_text_to_wav(
                self.model, self.vocoder, self.noise_generator(r), x, xl,
                n_timesteps=n_timesteps or self.tr["n_timesteps"], solver=self.tr["solver"],
                device=self.dev)
            n = int(y_len[0]) * self.cfg["audio"]["hop_length"]
            host = wav[0, :, 0].cpu().numpy()
        return host[:n], int(y_len[0]), int(bucket)

    # ---- window
    def window(self, tracer) -> Window:
        if self.run.control:
            return self.control_window()
        records, slice_records = [], []
        t_start = time.perf_counter()
        deadline = t_start + self.run.seconds
        i = 0
        while time.perf_counter() < deadline:
            tracer.unit(i)
            r = self.requests[i % len(self.requests)]
            t = time.perf_counter()
            wav, y_len, bucket = self.serve(r)
            lat = time.perf_counter() - t
            rec = {"index": r["index"], "latency_s": lat, "frames": y_len, "bucket": bucket,
                   "symbols": len(r["symbols"]), "wav": wav,
                   "before_slice": tracer.before_slice}
            records.append(rec)
            if tracer.tracing:
                slice_records.append(rec)
            i += 1
        tracer.finish()
        window_s = time.perf_counter() - t_start
        return Window(records, window_s, len(records), 0, slice_records)

    def control_window(self) -> Window:
        """The control: the reference in the program's place, in TF32, on
        the requests the check will sample (no timing)."""
        records = [{"index": r["index"], "latency_s": 0.0, "symbols": len(r["symbols"])}
                   for r in self.requests[: self.tr["check"]["control_requests"]]]
        for rec in records:
            wav, y_len, bucket = self.reference_serve(self.requests[rec["index"]], tf32=True)
            rec.update(wav=wav, frames=y_len, bucket=bucket)
        return Window(records, 1.0, len(records), 0, [])

    def end_to_end(self, w: Window) -> dict:
        lat = sorted(r["latency_s"] for r in w.records)
        audio = sum(r["frames"] for r in w.records) / self.frame_rate
        return {"request_p95_s": float(np.percentile(lat, 95)),
                "audio_s_per_s": audio / w.window_s}

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

    def reference_serve(self, r, tf32=False):
        from portbench.reference.tts import serve_request

        model, voc = self.reference()
        g = self.noise_generator(r)
        noise = lambda shape: torch.randn(shape, generator=g, device=self.dev)  # noqa: E731
        x = torch.as_tensor(r["symbols"], device=self.dev)[None]
        with harness.tf32_mode(tf32), torch.no_grad():
            dec, y_len, bucket = serve_request(model, x, self.tr["n_timesteps"], noise)
            wav = voc(dec)[0].cpu().numpy()
        return wav[: y_len * self.cfg["audio"]["hop_length"]], y_len, bucket

    def sample(self, records):
        """The requests the check compares: the longest finished one and
        others drawn from the seed, distinct pool entries."""
        by_index = {}
        for r in records:
            by_index.setdefault(r["index"], r)
        uniq = list(by_index.values())
        k = min(self.tr["check"]["sample"], len(uniq))
        longest = max(uniq, key=lambda r: r["frames"])
        rest = [r for r in uniq if r is not longest]
        pick = seeds.rng(self.run.seed, "check").permutation(len(rest))[: k - 1]
        return [longest] + [rest[i] for i in sorted(pick)]

    def check(self, w: Window) -> dict:
        wav_err, mismatched = 0.0, 0
        chosen = w.records if self.run.control else self.sample(w.records)
        for rec in chosen:
            ref, y_len, bucket = self.reference_serve(self.requests[rec["index"]])
            if (y_len, bucket) != (rec["frames"], rec["bucket"]) or len(ref) != len(rec["wav"]):
                mismatched += 1
                continue
            scale = max(float(np.abs(ref).max()), 1e-6)
            wav_err = max(wav_err, float(np.abs(rec["wav"] - ref).max()) / scale)
        return {"wav_err": wav_err, "length_mismatch": float(mismatched)}

    # ---- work, for the per-layer readers
    def work(self, records):
        ops = k1 = k1_bytes = 0
        for r in records:
            a, b, c = self.run.work.utterance(r["symbols"], r["frames"], self.tr["n_timesteps"])
            ops, k1, k1_bytes = ops + a, k1 + b, k1_bytes + c
        return ops, k1, k1_bytes
