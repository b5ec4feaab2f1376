"""Profiling and tracing on `torch.profiler` (port of
`arttts_tpu/utils/profiling.py`).

The reference has no profiling at all (SURVEY.md §5.1). Here `trace`
captures a Chrome trace of any code region (`*.trace.json.gz` under
`log_dir`, which `utils/trace_analysis.py` reads), and `span` names a
region of the program in it.

Spans. The program opens a span at each of its layer boundaries (the
names are fixed, so that a trace can be read by them):

- request: `arttts.request` (`infer/sampler.py:serve_text_to_wav`) holds
  `arttts.encode` (the encoder pass and the host's bucket pick),
  `arttts.decode` and `arttts.vocode`;
- model step: `arttts.encode` (the encoder pass), `arttts.decode` (path,
  noise and solver loop; counts `frames_computed`, B x the frame bucket,
  and `frames_kept`, the summed output lengths),
  `arttts.eval` (one score evaluation, whatever the solver or the score
  network's route), `arttts.vocode` (a vocoder pass over a whole track);
- pipeline: `arttts.pipeline.acoustic` holds one `arttts.pipeline.batch`
  a batch, each holding its `arttts.decode` and `arttts.pipeline.save`
  (the artifact writes); `arttts.pipeline.vocode` holds one
  `arttts.pipeline.track` an artifact, each holding `arttts.pipeline.load`
  (read and denormalise), `arttts.vocode` and `arttts.pipeline.write`;
- trainer step: `arttts.train.step` holds `arttts.train.loss` (the forward
  with the alignment), `arttts.train.backward`, `arttts.train.clip` and
  `arttts.train.optimizer`, in that order.

A span records only while a `torch.profiler` session records (`trace`, or
any `torch.profiler.profile` the caller runs); otherwise it costs one check
of the profiler's flag. While one records, a span enters
`torch.profiler.record_function(name)`, so it shows in the Chrome trace as
a `user_annotation` on the kernels' clock; the tree of spans, their times
and the device's work inside them are read from that trace. A span that
carries counts (`arttts.decode`) also keeps its name and counts in a
bounded store in memory (`spans()`), which holds every such span recorded
since the process started or the store was last emptied (`clear_spans()`,
or entering `trace`). A count given as a tensor is kept as the tensor
(recording never waits for the device) and summed to an int when the store
is read.
"""

from __future__ import annotations

import collections
import contextlib
import logging
from typing import Deque, Dict, List

import torch
from torch.profiler import ProfilerActivity, profile, record_function, tensorboard_trace_handler

log = logging.getLogger("arttts_tpu_torch.profiling")

STORE_LIMIT = 1 << 17  # records kept; the oldest go first

_recording = torch._C._autograd._profiler_enabled
_store: Deque[dict] = collections.deque(maxlen=STORE_LIMIT)


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture the enclosed region's host operations and, where a card is
    present, its device work, and write them as a gzipped Chrome trace
    (`{worker}.{timestamp}.pt.trace.json.gz`) under `log_dir`. Empties the
    span store first, so that `spans()` after holds this region's spans.
    Yields the `torch.profiler.profile`, whose `key_averages()` stay
    readable after:

        with trace("/tmp/torch-trace"):
            train_step(...)
    """
    clear_spans()
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir), use_gzip=True)) as prof:
        yield prof
    log.info("profiler trace written to %s", log_dir)


class _Off:
    """The span while no profiler records: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def count(self, **counts):
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("name", "counts", "_annotation")

    def __init__(self, name: str, counts: dict):
        self.name, self.counts = name, counts

    def __enter__(self):
        self._annotation = record_function(self.name)
        self._annotation.__enter__()
        return self

    def __exit__(self, *exc):
        self._annotation.__exit__(*exc)
        if self.counts and exc[0] is None:
            _store.append({"name": self.name, "counts": self.counts})
        return False

    def count(self, **counts):
        """Add counts known only inside the span."""
        self.counts.update(counts)


def span(name: str, **counts):
    """A named region of the program (a context manager): recorded as
    the module note says while a profiler records, nothing otherwise.
    `counts` (ints or tensors) are kept with it; `count(**more)` on the
    entered span adds more."""
    if not _recording():
        return _OFF
    return _Span(name, counts)


def _plain(value):
    if isinstance(value, torch.Tensor):
        return int(value.sum().item())
    return value


def spans() -> List[Dict]:
    """The stored spans (those that carry counts) in the order they
    closed, as plain records (`name`, `counts`; tensor counts summed to
    ints)."""
    return [{"name": rec["name"], "counts": {k: _plain(v) for k, v in rec["counts"].items()}}
            for rec in list(_store)]


def clear_spans():
    """Empty the span store."""
    _store.clear()

