"""Statistics, the reduction of a profiler trace, and the spans the traced
run records around calls into the port.

Spans are recorded from the benchmark's side: each wraps a module
attribute that the port looks up at call time, for the traced run only,
and restores it afterwards.
"""
from __future__ import annotations

import bisect
import time
from contextlib import contextmanager


def percentile(values, p: float) -> float:
    """The ``p``-th percentile, interpolated linearly between the two
    nearest ranks (numpy's default ``linear`` method)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    at = (len(xs) - 1) * p / 100.0
    lo = int(at)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (at - lo)


def union_seconds(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals (any unit)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def reduce_profile(kernels, host, top: int = 10) -> dict:
    """Busy time, the largest device operations and the longest idle gaps.

    ``kernels``: ``(name, start_us, end_us)`` of every device operation;
    ``host``: ``(name, start_us, end_us)`` of host ranges and ops.  Busy
    time is the union of the kernels' intervals, taken between the first
    kernel's start and the last one's end.  Each idle gap between kernels
    is named by the innermost host op that covers its middle, found among
    the 2000 that started last before it (host Python when none does);
    gaps are summed by name."""
    if not kernels:
        return {"busy_s": 0.0, "span_s": 0.0, "device_ops": [],
                "idle_gaps": []}
    by_name: dict[str, float] = {}
    for name, s, e in kernels:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    ivs = sorted((s, e) for _, s, e in kernels)
    busy = union_seconds(ivs) / 1e6
    span = (max(e for _, e in ivs) - ivs[0][0]) / 1e6
    gaps, reach = [], ivs[0][1]
    for s, e in ivs[1:]:
        if s > reach:
            gaps.append((reach, s))
        reach = max(reach, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    host = sorted(host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    named: dict[str, float] = {}
    for s, e in gaps[:500]:
        mid = (s + e) / 2
        at = bisect.bisect_right(starts, mid)
        name = "host python"
        for h in reversed(host[max(0, at - 2000):at]):
            if h[2] >= mid:      # the latest-starting cover is the innermost
                name = h[0]
                break
        named[name] = named.get(name, 0.0) + (e - s) / 1e6
    rest = sum(e - s for s, e in gaps[500:]) / 1e6
    if rest:
        named["(shorter gaps)"] = named.get("(shorter gaps)", 0.0) + rest
    return {"busy_s": busy, "span_s": span,
            "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
            "idle_gaps": sorted(named.items(), key=lambda kv: -kv[1])[:top]}


def profile_events(prof, ranges=()) -> tuple[list, list, dict]:
    """``(kernels, host, range_device_us)`` of a ``torch.profiler`` run:
    every device operation, every host op and range, and the device time
    of the kernels that each named user range (and its children)
    launched."""
    from torch.autograd import DeviceType
    kernels, host, range_us = [], [], {r: [] for r in ranges}
    for ev in prof.events():
        tr = ev.time_range
        if ev.device_type == DeviceType.CPU:
            host.append((ev.name, tr.start, tr.end))
            if ev.name in range_us:
                range_us[ev.name].append((tr.start, tr.end,
                                          ev.device_time_total))
        elif ev.name not in range_us and not getattr(
                ev, "is_user_annotation", False):
            kernels.append((ev.name, tr.start, tr.end))
    return kernels, host, range_us


class Patches:
    """Module attributes replaced for the traced run and put back on
    ``close``."""

    def __init__(self):
        self._saved = []

    def set(self, obj, attr: str, value) -> None:
        self._saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    def close(self) -> None:
        while self._saved:
            obj, attr, old = self._saved.pop()
            setattr(obj, attr, old)


def synced_span(fn, record: list, sync, name: str):
    """``fn`` timed on the host clock between two synchronisations, inside
    a profiler range ``name``; each call appends its milliseconds."""
    from torch.profiler import record_function

    def wrapped(*args, **kw):
        sync()
        t0 = time.perf_counter()
        with record_function(name):
            out = fn(*args, **kw)
            sync()
        record.append((time.perf_counter() - t0) * 1e3)
        return out

    return wrapped


def ranged(fn, name: str):
    """``fn`` inside a profiler range ``name``."""
    from torch.profiler import record_function

    def wrapped(*args, **kw):
        with record_function(name):
            return fn(*args, **kw)

    return wrapped


def event_timed_flash(fn, rec: dict):
    """``flash_attention`` with CUDA events around each call while
    ``rec["on"]``; appends ``(start, end, bhq, bhkv, sq, skv, d, causal,
    dtype)`` to ``rec["flash"]``."""
    import torch

    def wrapped(q, k, v, causal=True):
        if not rec["on"] or q.device.type != "cuda":
            return fn(q, k, v, causal)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = fn(q, k, v, causal)
        e.record()
        rec["flash"].append((s, e, q.shape[0], k.shape[0], q.shape[1],
                             k.shape[1], q.shape[2], bool(causal),
                             str(q.dtype).split(".")[-1]))
        return out

    return wrapped


@contextmanager
def no_tf32():
    import torch
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
