"""The port's recorder: spans and counters inside its serving and training
paths, off by default.

    from repro_torch import tracing
    tracing.enable()
    ...                          # serve or train
    rec = tracing.drain()        # {"spans": [...], "counters": {...}}
    tracing.disable()

A span records its name, an id, the id of the span open around it
(``parent``, None at the top), a request id (``rid``; the spans of one
request share it) and its start and end on the host clock
(``perf_counter_ns``).  While on, each span sits inside
``torch.profiler.record_function(name)``, so a profiled slice puts it on
the kernels' timeline.  A span opened with ``device=True`` also records an
event on the current CUDA stream at open and at close, without
synchronising; ``drain()`` synchronises once and places each event on the
host clock through the anchor pair (host clock, event) that ``enable()``
records, as ``device_start_ns`` and ``device_end_ns``.  Without a CUDA
device a ``device=True`` span's device times are its host times.

``count(name, value)`` adds ``value`` under the key ``(name, the innermost
open span's name)`` (None outside every span), so one counter splits by
phase.  A tensor value is summed on its device and read once, in
``drain()``.

Off, a site costs one bool check: ``span()`` returns one shared null
context and ``count()`` returns at once.  A site that would compute a
tensor for a counter guards it with ``if tracing.on:``.  Spans and
counters stay in memory until ``drain()``, which empties them and leaves
``on`` as it was.
"""
from __future__ import annotations

import contextlib
import itertools
import time

import torch

on = False                # read at every site: the one check when off

_NULL = contextlib.nullcontext()
_spans: list[dict] = []   # closed spans, in the order they closed
_open: list[dict] = []    # the open spans, innermost last
_counters: dict = {}      # (name, innermost span name) -> int or tensor
_ids = itertools.count()
_anchor = None            # (host ns, CUDA event) of enable(); None: no card


def enable() -> None:
    """Turn the recorder on.  With a CUDA device it synchronises once and
    records the anchor that ``drain()`` places device times by."""
    global on, _anchor
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        _anchor = (time.perf_counter_ns(), ev)
    else:
        _anchor = None
    on = True


def disable() -> None:
    """Turn the recorder off; what it holds stays until ``drain()``."""
    global on
    on = False


class _Span:
    __slots__ = ("rec", "rf")

    def __init__(self, name: str, rid, device: bool):
        self.rec = {"name": name, "id": next(_ids),
                    "parent": _open[-1]["id"] if _open else None,
                    "rid": rid, "device": device}

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.rec["name"])
        self.rf.__enter__()
        if self.rec["device"] and _anchor is not None:
            self.rec["_ev0"] = _event()
        _open.append(self.rec)
        self.rec["start_ns"] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.rec["end_ns"] = time.perf_counter_ns()
        if "_ev0" in self.rec:
            self.rec["_ev1"] = _event()
        _open.pop()
        self.rf.__exit__(*exc)
        _spans.append(self.rec)
        return False


def _event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def span(name: str, rid=None, device: bool = False):
    """A context manager: a span ``name`` while on, the shared null
    context while off.  ``device=True`` times it on the card too."""
    if not on:
        return _NULL
    return _Span(name, rid, device)


def count(name: str, value) -> None:
    """Add ``value`` (a number, or a tensor summed on its device) under
    ``(name, innermost open span's name)``; nothing while off."""
    if not on:
        return
    key = (name, _open[-1]["name"] if _open else None)
    if isinstance(value, torch.Tensor):
        value = value.detach().sum()
    _counters[key] = _counters.get(key, 0) + value


def drain() -> dict:
    """``{"spans": [...], "counters": {...}}`` of everything recorded since
    the last drain, spans ordered by their host start; empties the
    recorder and leaves ``on`` as it was.  Synchronises once where a span
    timed the card."""
    spans = sorted(_spans, key=lambda s: s["start_ns"])
    counters = dict(_counters)
    _spans.clear()
    _counters.clear()
    if any("_ev0" in s for s in spans):
        torch.cuda.synchronize()
    for s in spans:
        if "_ev0" in s:
            host_ns, ev = _anchor
            for key, at in (("device_start_ns", "_ev0"),
                            ("device_end_ns", "_ev1")):
                s[key] = host_ns + round(ev.elapsed_time(s.pop(at)) * 1e6)
        elif s["device"]:
            s["device_start_ns"] = s["start_ns"]
            s["device_end_ns"] = s["end_ns"]
    for k, v in counters.items():
        if isinstance(v, torch.Tensor):
            counters[k] = v.item()
    return {"spans": spans, "counters": counters}
