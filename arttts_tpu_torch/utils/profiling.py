"""Profiling and tracing on `torch.profiler` (port of
`arttts_tpu/utils/profiling.py`).

The reference has no profiling at all (SURVEY.md §5.1). Here `trace`
captures a Chrome trace of any code region (`*.trace.json.gz` under
`log_dir`, which `utils/trace_analysis.py` reads), `annotate` names a
region in it, and `StepTimer` logs step-time percentiles without a device
sync on every step.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function, tensorboard_trace_handler

log = logging.getLogger("arttts_tpu_torch.profiling")


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture the enclosed region's host operations and, where a card is
    present, its device work, and write them as a gzipped Chrome trace
    (`{worker}.{timestamp}.pt.trace.json.gz`) under `log_dir`. Yields the
    `torch.profiler.profile`, whose `key_averages()` stay readable after:

        with trace("/tmp/torch-trace"):
            train_step(...)
    """
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir), use_gzip=True)) as prof:
        yield prof
    log.info("profiler trace written to %s", log_dir)


def annotate(name: str):
    """Named region that shows up in profiler timelines."""
    return record_function(name)


def _cuda_device(result) -> Optional[torch.device]:
    """The device of the first CUDA tensor in `result` (a tensor, or
    lists, tuples and dicts of them), None when it holds none."""
    if isinstance(result, torch.Tensor):
        return result.device if result.is_cuda else None
    if isinstance(result, dict):
        result = list(result.values())
    if isinstance(result, (list, tuple)):
        for item in result:
            device = _cuda_device(item)
            if device is not None:
                return device
    return None


class StepTimer:
    """Wall-clock step timing with periodic sync.

    Most steps are timed dispatch-to-dispatch (free); every `sync_every`
    steps the card that holds the result is synchronized, so the
    measurement window closes on real device time. A result on the CPU is
    never synchronized (its work is done when it returns). `syncs` counts
    the synchronizations.
    """

    def __init__(self, sync_every: int = 50):
        self.sync_every = sync_every
        self.times: List[float] = []
        self.syncs = 0
        self._t0: Optional[float] = None
        self._count = 0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result=None):
        self._count += 1
        if result is not None and self._count % self.sync_every == 0:
            device = _cuda_device(result)
            if device is not None:
                torch.cuda.synchronize(device)
                self.syncs += 1
        if self._t0 is not None:
            self.times.append(time.perf_counter() - self._t0)
            self._t0 = None

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        arr = np.asarray(self.times[1:] or self.times)  # drop the warm-up step
        return {
            "steps": len(arr),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
            "steps_per_s": float(1.0 / max(arr.mean(), 1e-12)),
        }
