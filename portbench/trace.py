"""Reading the profiler's Chrome trace of a run's profiled slice.

Device work is chosen by the event's category: the complete ('X') events
whose `cat` is `kernel`, `gpu_memcpy` or `gpu_memset`. The busy time is the
union of their intervals (two streams' overlapping kernels count once);
the per-kernel table sums each name's durations. This arithmetic is a copy
of the port's `utils/trace_analysis.py` (`device_busy_seconds`,
`leaf_op_table`), kept here so the yardstick stays fixed when the program
changes. Idle gaps are labelled by what the host was doing when the card
went idle: the benchmark's own annotation around its call into the program,
and the innermost host operation under way.
"""

from __future__ import annotations

import collections
import json
import re
from typing import Dict, List, Optional, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "python_function", "cuda_runtime",
                   "cuda_driver")


def load_events(path: str) -> List[dict]:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def device_events(events: List[dict]) -> List[dict]:
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]


def busy_intervals(dev: List[dict]) -> List[Tuple[float, float]]:
    """The union of the device events' intervals (microseconds), merged."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in dev)
    merged: List[List[float]] = []
    for s, t in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return [(s, t) for s, t in merged]


def busy_seconds(dev: List[dict]) -> float:
    return sum(t - s for s, t in busy_intervals(dev)) / 1e6


def kernel_table(dev: List[dict]) -> List[Tuple[str, float, int]]:
    """(name, seconds, count) by device event name, most time first."""
    agg: Dict[str, List[float]] = collections.defaultdict(lambda: [0.0, 0])
    for e in dev:
        a = agg[e["name"]]
        a[0] += e["dur"] / 1e6
        a[1] += 1
    return sorted(((k, v[0], v[1]) for k, v in agg.items()), key=lambda r: -r[1])


def family_seconds(dev: List[dict], names: List[str]) -> float:
    """Device seconds of the events whose name holds one of `names` as an
    identifier (a kernel's templated or mangled name included)."""
    pat = re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(map(re.escape, names)) + r")(?![A-Za-z0-9_])")
    return sum(e["dur"] for e in dev if pat.search(e["name"])) / 1e6


def _label(host: List[dict], ts: float) -> str:
    """The benchmark's annotation around `ts` and the innermost host
    operation under way then (or that the host was between operations)."""
    outer, inner = None, None
    for e in host:
        if e["ts"] <= ts <= e["ts"] + e.get("dur", 0):
            if e.get("cat") == "user_annotation" and e["name"].startswith("portbench."):
                if outer is None or e["dur"] < outer["dur"]:
                    outer = e
            elif inner is None or e["dur"] < inner["dur"]:
                inner = e
    where = outer["name"] if outer else "outside the benchmark's calls"
    return f"{where}: {inner['name'] if inner else 'host between operations'}"


def idle_gaps(events: List[dict], start_us: float, end_us: float,
              top: int = 10) -> List[Tuple[str, float]]:
    """The longest stretches of [start_us, end_us] with no device work,
    each labelled by what the host was doing as the card went idle."""
    dev = [e for e in device_events(events) if e["ts"] < end_us and e["ts"] + e["dur"] > start_us]
    busy = busy_intervals(dev)
    gaps, cursor = [], start_us
    for s, t in busy:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, t)
    if end_us > cursor:
        gaps.append((cursor, end_us))
    gaps.sort(key=lambda g: g[0] - g[1])
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATEGORIES]
    return [(_label(host, s), (t - s) / 1e6) for s, t in gaps[:top]]


class TraceSlice:
    """One profiled slice: its device events and the host clock's bounds of
    the slice (microseconds on the trace's clock, from the benchmark's
    annotation `portbench.slice`)."""

    def __init__(self, path: str, wall_s: float):
        self.events = load_events(path)
        span: Optional[dict] = next(
            (e for e in self.events if e.get("ph") == "X" and e.get("name") == "portbench.slice"
             and e.get("cat") == "user_annotation"), None)
        dev = device_events(self.events)
        if span is not None:
            self.start_us, self.end_us = span["ts"], span["ts"] + span["dur"]
        elif dev:  # a trace of the device alone: the slice is the host's wall
            self.start_us = min(e["ts"] for e in dev)
            self.end_us = max(max(e["ts"] + e["dur"] for e in dev),
                              self.start_us + wall_s * 1e6)
        else:
            self.start_us = self.end_us = 0.0
        self.dev = [e for e in dev if e["ts"] >= self.start_us and e["ts"] < self.end_us]
        self.wall_s = wall_s

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    @property
    def busy_s(self) -> float:
        return busy_seconds(self.dev)

    def breakdown(self, top: int = 10) -> dict:
        return {"device_ops": [[n, s] for n, s, _ in kernel_table(self.dev)[:top]],
                "idle_gaps": [[n, s] for n, s in idle_gaps(self.events, self.start_us,
                                                            self.end_us, top)]}
