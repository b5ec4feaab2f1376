"""Arithmetic shared by the per-layer metrics' readers (`metrics/*.py`).

Each returns None where the run gives it nothing to read: another kind of
traffic, no profiled slice, or no device time of the kernel. A share is a
share of what was measured; nothing is clipped to 100.
"""

from __future__ import annotations

from typing import Optional

from portbench.trace import family_seconds
from portbench.work import least_seconds, peaks


def kernel_roofline(ctx, family: str, mode: str) -> Optional[float]:
    """100 x the family's least time (its useful operations over the
    precision's dense peak, or its bytes over HBM's rate, the larger) over
    its device time, in the profiled slice."""
    if ctx.mode != mode or ctx.trace is None:
        return None
    seconds = family_seconds(ctx.trace.dev, ctx.kernel_names(family))
    if seconds <= 0:
        return None
    _, ops, nbytes = ctx.driver.work(ctx.window.slice_records)
    if ops <= 0:
        return None
    return 100.0 * least_seconds(ops, nbytes, ctx.precision) / seconds


def untraced(ctx):
    """The window's records and seconds before the profiled slice (the
    profiler slows the host from its start on), or the whole window's."""
    w = ctx.window
    if w.seconds_before_slice is None:
        return w.records, w.window_s
    return [r for r in w.records if r["before_slice"]], w.seconds_before_slice


def mfu(ctx, mode: str) -> Optional[float]:
    """100 x the useful operations completed in the window's units before
    the profiled slice over their seconds times the precision's dense peak."""
    records, seconds = untraced(ctx)
    if ctx.mode != mode or not records or seconds <= 0:
        return None
    ops = ctx.driver.work(records)[0]
    return 100.0 * ops / (seconds * peaks()["dense_flops_per_s"][ctx.precision])


def idle_pct(ctx, mode: str) -> Optional[float]:
    """100 x the share of the profiled slice in which no device work ran."""
    if ctx.mode != mode or ctx.trace is None or not ctx.trace.dev or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def host_share(ctx, mode: str, attr: str) -> Optional[float]:
    """100 x the seconds of the units before the profiled slice spent inside
    one of the benchmark's host spans (the driver sums them as `attr`)."""
    records, seconds = untraced(ctx)
    if ctx.mode != mode or not records or seconds <= 0:
        return None
    return 100.0 * getattr(ctx.window, attr) / seconds
