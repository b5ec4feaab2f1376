"""Reading the program's spans: the `arttts.*` annotations that the port
opens at its layer boundaries (`arttts_tpu_torch/utils/profiling.py:span`)
as they appear in the profiled slice's Chrome trace, and the records the
port keeps of them in memory (`profiling.spans()`), with their counts.

The arithmetic the per-layer readers share:
- `idle_inside`: the seconds inside a set of intervals (their union) in
  which no device work ran; device work counts as busy whichever span
  launched it;
- `self_seconds`: each span name's own time, less the spans opened inside
  it on the same thread;
- `stored`: the port's records of its spans that carry counts. A span
  records only while a profiler records, and a run profiles its slice
  alone, so the store holds the slice's spans.

Each reader returns None where the run gives it nothing to read: another
kind of traffic, no profiled slice, or a program that opens no spans.

    python3 -m portbench.spans --workload v2.serve --seed 7 --seconds 51

runs the cell once with its profiled slice (as `portbench.run --trace 1`,
whose result line it prints first) and prints one JSON object more: by
span name, the count, seconds, self seconds and the device's idle seconds
inside the span's own time; and the idle seconds outside every program span.
"""

from __future__ import annotations

import collections
import json
from typing import Dict, Iterable, List, Optional, Tuple

from portbench.trace import busy_intervals, device_events

PREFIX = "arttts."
Interval = Tuple[float, float]


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """The intervals merged, sorted (`busy_intervals`' merge)."""
    return busy_intervals([{"ts": s, "dur": t - s} for s, t in intervals])


def length(intervals: List[Interval]) -> float:
    return sum(t - s for s, t in intervals)


def overlap(a: List[Interval], b: List[Interval]) -> float:
    """The length common to two merged, sorted interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def subtract(a: List[Interval], b: List[Interval]) -> List[Interval]:
    """The parts of merged list `a` outside merged list `b`."""
    out, j = [], 0
    for s, t in a:
        cur = s
        while j < len(b) and b[j][1] <= cur:
            j += 1
        k = j
        while k < len(b) and b[k][0] < t:
            if b[k][0] > cur:
                out.append((cur, b[k][0]))
            cur = max(cur, b[k][1])
            k += 1
        if cur < t:
            out.append((cur, t))
    return out


def idle_inside(intervals: Iterable[Interval], busy: List[Interval]) -> float:
    """Microseconds of the intervals' union in which the merged `busy`
    intervals leave the device idle."""
    u = union(intervals)
    return length(u) - overlap(u, busy)


def annotations(events: List[dict], start_us: float, end_us: float,
                name: Optional[str] = None) -> List[dict]:
    """The host's `arttts.*` annotations (or those named `name`) that
    start within [start_us, end_us)."""
    return [e for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and (e["name"] == name if name else e["name"].startswith(PREFIX))
            and start_us <= e["ts"] < end_us]


def intervals_of(spans: List[dict]) -> List[Interval]:
    return [(e["ts"], e["ts"] + e["dur"]) for e in spans]


def self_intervals(spans: List[dict]) -> Dict[int, List[Interval]]:
    """Each span's own time (by its index in `spans`): its interval less
    those of the spans opened inside it on the same thread."""
    children: Dict[int, List[Interval]] = collections.defaultdict(list)
    by_thread = collections.defaultdict(list)
    for i, e in enumerate(spans):
        by_thread[(e.get("pid"), e.get("tid"))].append(i)
    for idx in by_thread.values():
        stack: List[int] = []
        for i in sorted(idx, key=lambda i: (spans[i]["ts"], -spans[i]["dur"])):
            e = spans[i]
            while stack and spans[stack[-1]]["ts"] + spans[stack[-1]]["dur"] <= e["ts"]:
                stack.pop()
            if stack:
                children[stack[-1]].append((e["ts"], e["ts"] + e["dur"]))
            stack.append(i)
    return {i: subtract([(e["ts"], e["ts"] + e["dur"])], union(children[i]))
            for i, e in enumerate(spans)}


def self_seconds(spans: List[dict]) -> Dict[str, float]:
    """Self time by span name, in seconds."""
    out: Dict[str, float] = collections.defaultdict(float)
    for i, own in self_intervals(spans).items():
        out[spans[i]["name"]] += length(own) / 1e6
    return dict(out)


def breakdown(events: List[dict], start_us: float, end_us: float) -> dict:
    """By span name within [start_us, end_us): count, seconds, self
    seconds, and the device's idle seconds inside the span's own time;
    and the idle seconds of the slice outside every program span."""
    spans = annotations(events, start_us, end_us)
    dev = [e for e in device_events(events) if e["ts"] < end_us and e["ts"] + e["dur"] > start_us]
    busy = busy_intervals(dev)
    own = self_intervals(spans)
    table: Dict[str, dict] = {}
    for i, e in enumerate(spans):
        row = table.setdefault(e["name"], {"count": 0, "s": 0.0, "self_s": 0.0, "idle_s": 0.0})
        row["count"] += 1
        row["s"] += e["dur"] / 1e6
        row["self_s"] += length(own[i]) / 1e6
        row["idle_s"] += (length(own[i]) - overlap(own[i], busy)) / 1e6
    slice_idle = idle_inside([(start_us, end_us)], busy) / 1e6
    inside = idle_inside(intervals_of(spans), busy) / 1e6
    return {"spans": table, "slice_s": (end_us - start_us) / 1e6, "idle_s": slice_idle,
            "idle_outside_spans_s": slice_idle - inside}


# ------------------------------------------------------------ the port's store
def stored(name: str) -> Optional[List[dict]]:
    """The port's records of its spans named `name` (see the module note),
    or None for a program that keeps no store."""
    try:
        from arttts_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    return [r for r in read() if r["name"] == name] if callable(read) else None


# ------------------------------------------------------------ the readers
def pad_pct(ctx, mode: str) -> Optional[float]:
    """100 x the share of the frames the decodes of the slice computed
    that their outputs did not keep (padding to the frame bucket)."""
    if ctx.mode != mode or ctx.trace is None:
        return None
    decodes = stored("arttts.decode")
    if not decodes:
        return None
    computed = sum(r["counts"]["frames_computed"] for r in decodes)
    kept = sum(r["counts"]["frames_kept"] for r in decodes)
    return 100.0 * (1.0 - kept / computed) if computed > 0 else None


def idle_pct_inside(ctx, mode: str, name: str) -> Optional[float]:
    """100 x the device's idle seconds inside the slice's `name` spans
    over the seconds of their union."""
    if ctx.mode != mode or ctx.trace is None:
        return None
    spans = intervals_of(annotations(ctx.trace.events, ctx.trace.start_us, ctx.trace.end_us,
                                     name))
    total = length(union(spans))
    if total <= 0:
        return None
    return 100.0 * idle_inside(spans, busy_intervals(ctx.trace.dev)) / total


def share_of(ctx, mode: str, parts: Tuple[str, ...], whole: str) -> Optional[float]:
    """100 x the summed durations of the slice's `parts` spans over those
    of its `whole` spans."""
    if ctx.mode != mode or ctx.trace is None:
        return None
    t = ctx.trace
    whole_us = sum(e["dur"] for e in annotations(t.events, t.start_us, t.end_us, whole))
    if whole_us <= 0:
        return None
    part_us = sum(e["dur"] for p in parts for e in annotations(t.events, t.start_us, t.end_us, p))
    return 100.0 * part_us / whole_us


# ------------------------------------------------------------ one traced run, by span
def main(argv=None) -> int:
    import argparse

    from portbench import run
    from portbench.trace import TraceSlice

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", "1"])
    if rc:
        return rc
    from portbench.harness import TRACE_DIR

    path = TRACE_DIR / f"trace-{args.workload}.json"
    ts = TraceSlice(str(path), 0.0)
    print(json.dumps(breakdown(ts.events, ts.start_us, ts.end_us)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
