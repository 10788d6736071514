"""The profiler hook and the program's own spans and counters.

`device_trace` wraps `torch.profiler`. Its counterpart in
`butterfly_tpu/utils/profiling.py` swallows every profiler error; this one
raises them.

Spans and counters mark where the program's time goes: the solver's steps
and the operator applies beneath them. They are off by default and cost
one check of a module-level switch then; `tracing(True)` turns them on for
the process. On, each span keeps its name, its start and end on the host
clock (`time.perf_counter_ns`), its parent span and its request (the
enclosing root span, one solve), and while `torch.profiler` records it is
also an annotation `bf.<name>` in the trace, on the kernels' clock.
`device_gaps` pairs CUDA events around the card's idle stretches a solve
leaves. `snapshot()` reads it all, `reset()` clears it. The record lives in
the process and is written by one thread.

The reference's instrumentation is wall clock only (bfToc through the
examples, src/timer.c).
"""

from __future__ import annotations

import collections
import contextlib
import os
import time

import torch

__all__ = ["device_trace", "tracing", "span", "count", "device_gaps",
           "snapshot", "reset", "SpanRecord"]

PREFIX = "bf."

# one span: host-clock start and end (ns), index of its parent in the
# record (None at the top) and of its request's root span
SpanRecord = collections.namedtuple(
    "SpanRecord", "name start_ns end_ns parent request")

_on = False
_spans: list = []      # SpanRecord's fields as lists, in start order
_open: list = []       # indices of the open spans, innermost last
_counters: dict = {}
_gaps: dict = {}       # name -> [pairs, seconds]
_free_events: dict = {}  # device -> CUDA events read and free for reuse


@contextlib.contextmanager
def device_trace(log_dir: str):
    """`torch.profiler` over the block: CPU activity, and CUDA activity
    where there is a card. Yields the profiler (read `key_averages()`
    after the block); on exit writes the Chrome trace
    `log_dir/trace.json`. Errors of the profiler propagate."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def tracing(enabled: bool) -> bool:
    """Turn the spans, counters and gaps on or off; returns the previous
    setting."""
    global _on
    was, _on = _on, bool(enabled)
    return was


_NO_SPAN = contextlib.nullcontext()


class _Span:
    __slots__ = ("rec", "owner", "annotation")

    def __init__(self, name: str, root: bool):
        parent = _open[-1] if _open else None
        self.owner = _spans
        idx = len(_spans)
        request = idx if root or parent is None else _spans[parent][4]
        self.annotation = None
        if torch.autograd._profiler_enabled():
            self.annotation = torch.profiler.record_function(PREFIX + name)
            self.annotation.__enter__()
        _open.append(idx)
        self.rec = [name, time.perf_counter_ns(), None, parent, request]
        _spans.append(self.rec)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.rec[2] = time.perf_counter_ns()
        if self.owner is _spans:    # else reset() dropped it
            _open.pop()             # spans nest: this one is innermost
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        return False


def span(name: str, root: bool = False):
    """A context that records `name` while tracing is on, and a shared
    no-op otherwise. A `root` span opens a request: the spans inside it
    carry its index."""
    if not _on:
        return _NO_SPAN
    return _Span(name, root)


def count(name: str, k: int = 1) -> None:
    """Add `k` to the counter `name` while tracing is on."""
    if _on:
        _counters[name] = _counters.get(name, 0) + k


class _NoGaps:
    __slots__ = ()

    def start(self):
        pass

    def stop(self):
        pass

    def flush(self):
        pass


_NO_GAPS = _NoGaps()


class _Gaps:
    """CUDA events in pairs on the device's current stream: `start` where
    the card runs out of work, `stop` where the host hands it more. A
    `start` not yet stopped is replaced by the next. `flush` reads the
    pairs (the caller has synchronised) into the record under the name,
    and keeps their events for reuse: creating one costs the host more
    than recording it."""

    def __init__(self, name: str, device: torch.device):
        self.name = name
        self.stream = torch.cuda.current_stream(device)
        self.free = _free_events.setdefault(device, [])
        self.pending = None
        self.pairs: list = []

    def _record(self):
        ev = (self.free.pop() if self.free
              else torch.cuda.Event(enable_timing=True))
        ev.record(self.stream)
        return ev

    def start(self):
        if self.pending is not None:
            self.free.append(self.pending)
        self.pending = self._record()

    def stop(self):
        if self.pending is not None:
            self.pairs.append((self.pending, self._record()))
            self.pending = None

    def flush(self):
        ms = sum(a.elapsed_time(b) for a, b in self.pairs)
        rec = _gaps.setdefault(self.name, [0, 0.0])
        rec[0] += len(self.pairs)
        rec[1] += ms * 1e-3
        self.free.extend(ev for pair in self.pairs for ev in pair)
        if self.pending is not None:
            self.free.append(self.pending)
        self.pairs, self.pending = [], None


def device_gaps(name: str, device: torch.device):
    """Event pairs timing the card's idle stretches, recorded under `name`
    while tracing is on and `device` is a card; a shared no-op
    otherwise."""
    device = torch.device(device)
    if not _on or device.type != "cuda":
        return _NO_GAPS
    return _Gaps(name, device)


def snapshot() -> dict:
    """The record so far. `spans`: per name, the closed spans' `calls`,
    `total_s` (host time) and `self_s` (less the time of their child
    spans); `counters`; `gaps`: per name, the event `pairs` and their
    `total_s` on the card's clock; `records`: every SpanRecord in start
    order."""
    recs = [SpanRecord(*r) for r in _spans]
    spans: dict = {}
    child_ns = [0] * len(recs)
    for r in recs:
        if r.end_ns is not None and r.parent is not None:
            child_ns[r.parent] += r.end_ns - r.start_ns
    for i, r in enumerate(recs):
        if r.end_ns is None:
            continue
        s = spans.setdefault(r.name, {"calls": 0, "total_s": 0.0,
                                      "self_s": 0.0})
        dur = r.end_ns - r.start_ns
        s["calls"] += 1
        s["total_s"] += dur * 1e-9
        s["self_s"] += (dur - child_ns[i]) * 1e-9
    return {"spans": spans, "counters": dict(_counters),
            "gaps": {k: {"pairs": p, "total_s": s}
                     for k, (p, s) in _gaps.items()},
            "records": recs}


def reset() -> None:
    """Clear the record (the switch keeps its setting). Spans still open
    are dropped with it."""
    global _spans, _open
    _spans, _open = [], []
    _counters.clear()
    _gaps.clear()
