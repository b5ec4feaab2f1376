"""Faults planted under the timed path, to show that the check catches
them (the tests and `calibrate` use them; a benchmark run never does).

- `state_unchanged`: every solver step returns its state as it was given
  (serving), or the optimizer leaves the parameters as they were
  (training);
- `half_batch`: the training loss sees the first half of the batch, its
  mean taken over those rows;
- `answer_altered`: one answer changed where it is produced: a sample of
  every request's waveform, or a value of every saved artifact.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

FAULTS = ("state_unchanged", "half_batch", "answer_altered")


@contextlib.contextmanager
def planted(name):
    if name is None:
        yield
        return
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}")
    from arttts_tpu_torch.infer import pipeline, sampler
    from arttts_tpu_torch.train import losses

    saved = []

    def patch(obj, attr, new):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, new)

    if name == "state_unchanged":
        patch(sampler, "reverse_diffusion",
              lambda model, z, mask, *a, **k: z * mask)
        patch(torch.optim.Adam, "step", lambda self, closure=None: None)
    elif name == "half_batch":
        loss = losses.grad_tts_loss

        def half(model, generator, x, x_lengths, y, y_lengths, spk=None, durations=None,
                 out_size=None, pinned=None, denominators=None):
            h = x.shape[0] // 2
            if pinned is not None:
                pinned = tuple(p[:h] for p in pinned)
            return loss(model, generator, x[:h], x_lengths[:h], y[:h], y_lengths[:h],
                        out_size=out_size, pinned=pinned)

        patch(losses, "grad_tts_loss", half)
    else:
        serve, acoustic = sampler.serve_text_to_wav, pipeline.run_acoustic_inference_batched
        def serve_altered(*a, **k):
            wav, y_len, bucket = serve(*a, **k)
            wav = wav.clone()
            wav[0, int(y_len[0]) * 128, 0] += 0.1
            return wav, y_len, bucket

        def acoustic_altered(*a, **k):
            paths = acoustic(*a, **k)
            for p in paths:
                art = np.load(p)
                n = (art.shape[0] - 1) // 2
                art[n, art.shape[1] // 2] += 0.1 * np.abs(art[n:2 * n]).max()
                np.save(p, art)
            return paths

        patch(sampler, "serve_text_to_wav", serve_altered)
        patch(pipeline, "run_acoustic_inference_batched", acoustic_altered)
    try:
        yield
    finally:
        for obj, attr, old in reversed(saved):
            setattr(obj, attr, old)
