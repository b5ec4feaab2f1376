"""Post-processing of the `torch.profiler` Chrome traces that
`utils/profiling.trace` writes (port of `arttts_tpu/utils/trace_analysis.py`).

A trace (`*.trace.json.gz`) is parsed into per-kernel device-time tables
and a device-busy figure, for whole-program accounting of the card: the
profiler times every kernel that executes, the hand-written ones
included.

Device work is chosen by the event's category, never by its process: the
complete ('X') events whose `cat` is `kernel`, `gpu_memcpy` or
`gpu_memset` count. Host events (`cpu_op`, `cuda_runtime`,
`user_annotation`, ...) and `gpu_user_annotation`, the device-side span
of a `record_function` region (an umbrella over the kernels inside it,
idle gaps included), do not.
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import re
from typing import Dict, List, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _written_ns(path: str) -> int:
    """When a trace was written, in ns since the epoch: the `time_ns` that
    `tensorboard_trace_handler` puts in its file name
    (`{host}_{pid}.{time_ns}.pt.trace.json.gz`), else the file's mtime."""
    m = re.search(r"\.(\d+)\.pt\.trace\.json\.gz$", path)
    return int(m.group(1)) if m else os.stat(path).st_mtime_ns


def _latest_trace_file(trace_dir: str) -> str:
    """The newest `*.trace.json.gz` under `trace_dir` by `_written_ns`
    (path order is host and pid order, not time order)."""
    files = glob.glob(
        os.path.join(trace_dir, "**", "*.trace.json.gz"), recursive=True
    )
    if not files:
        raise FileNotFoundError(f"no *.trace.json.gz under {trace_dir}")
    return max(files, key=_written_ns)


def load_device_events(trace_dir: str) -> List[dict]:
    """All complete ('X') device events of the latest trace under
    `trace_dir` (categories `DEVICE_CATEGORIES`), each a dict with
    name/ts/dur (microseconds), pid (the card) and tid (the stream)."""
    with gzip.open(_latest_trace_file(trace_dir)) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]


def device_busy_seconds(trace_dir: str) -> float:
    """Union of device event intervals (seconds): wall time the card spent
    executing anything. Kernels that overlap on two streams count once."""
    spans = sorted(
        (e["ts"], e["ts"] + e["dur"]) for e in load_device_events(trace_dir)
    )
    busy = 0.0
    cur_s = cur_e = None
    for s, t in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e6


def leaf_op_table(trace_dir: str) -> List[Tuple[str, float, int]]:
    """Per-kernel (name, total_ms, count) of the device events, sorted by
    total time descending. Every event is a leaf: the kernels, copies and
    memsets of a CUDA stream run one after another and never nest, so the
    JAX module's search for parent ops (a TPU `while` over its body) has
    nothing to find here."""
    agg: Dict[str, List[float]] = collections.defaultdict(lambda: [0.0, 0])
    for e in load_device_events(trace_dir):
        a = agg[e["name"]]
        a[0] += e["dur"] / 1e3
        a[1] += 1
    return sorted(
        ((k, v[0], v[1]) for k, v in agg.items()), key=lambda r: -r[1]
    )


def grouped_report(
    trace_dir: str, groups: Dict[str, Tuple[str, ...]] | None = None
) -> Dict[str, float]:
    """Bucket device time (ms) by substring groups, e.g.
    {"K1": ("conv3x3_kernel",), "copy": ("Memcpy",)}; ungrouped time
    lands in "other". Values rounded to 3 places."""
    table = leaf_op_table(trace_dir)
    groups = groups or {}
    out = {k: 0.0 for k in groups}
    out["other"] = 0.0
    for name, ms, _ in table:
        for key, subs in groups.items():
            if any(s in name for s in subs):
                out[key] += ms
                break
        else:
            out["other"] += ms
    return {k: round(v, 3) for k, v in out.items()}
