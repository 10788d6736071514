"""The traced sub-window: `torch.profiler` over a few requests, read from
its Chrome trace.

- `busy_s`: the union of the device's activity (kernels, copies, memsets)
  inside the window; `window_s`: the window's length by the host clock (a
  `portbench.traced_window` annotation around the requests and the final
  synchronise).
- `device_ops`: device time by kernel name, as the profiler prints it.
- `idle_gaps`: the device's idle time inside the window, by what the host
  was doing: the innermost host event (torch op, CUDA runtime call or
  annotation) over the gap's start, or "host python" where none is.
- `spans`: for each program call the run names (`System.spans`: the
  plan's apply, the corrector's), its calls in the window and the device
  time of everything launched inside them: each call is wrapped in a
  `portbench.span.<name>` annotation, and a kernel, copy or memset counts
  where the host call that launched it (matched by the profiler's
  correlation id) lies inside one.

The trace is written to a fixed file of the checkout
(`build/portbench/trace_<cell>.json`) and read back.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
from pathlib import Path

import torch

WINDOW = "portbench.traced_window"
REQUEST = "portbench.request"
SPAN = "portbench.span."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", *LAUNCH_CATS, "user_annotation")


@dataclasses.dataclass
class Trace:
    busy_s: float
    window_s: float
    device_ops: list   # [[name, seconds]], most time first
    idle_gaps: list    # [[host activity, seconds]], most time first
    spans: dict = dataclasses.field(default_factory=dict)
    # {name: {"calls": n, "device_s": seconds}}


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _top(d: dict, k: int = 10) -> list:
    return [[n, s] for n, s in sorted(d.items(), key=lambda x: -x[1])[:k]]


def summarize(events: list) -> Trace:
    """Reduce Chrome-trace events (`ph` "X", times in microseconds)."""
    spans = [e for e in events if e.get("ph") == "X"]
    win = [e for e in spans if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if len(win) != 1:
        raise RuntimeError(f"expected one {WINDOW} span, found {len(win)}")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, ops = [], {}
    for e in spans:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        a, b = max(a, w0), min(b, w1)
        if b > a:
            dev.append((a, b))
            ops[e["name"]] = ops.get(e["name"], 0.0) + (b - a) * 1e-6
    busy = _union(dev)
    host = sorted((e for e in spans if e.get("cat") in HOST_CATS
                   and e.get("name") != WINDOW),
                  key=lambda e: (float(e["ts"]), -float(e["dur"])))
    gaps, t = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > t:
            gaps.append((t, a - t))
        t = max(t, b)
    by_host: dict = {}
    for name, dt in zip(_host_at(host, [g[0] for g in gaps]), gaps):
        by_host[name] = by_host.get(name, 0.0) + dt[1] * 1e-6
    return Trace(sum(b - a for a, b in busy) * 1e-6, (w1 - w0) * 1e-6,
                 _top(ops), _top(by_host), _span_device_time(spans))


def _corr(e):
    return (e.get("args") or {}).get("correlation")


def _span_device_time(spans: list) -> dict:
    """{name: {"calls", "device_s"}} of the `SPAN` annotations: the device
    events whose launching host call starts inside one of them."""
    marks: dict = {}
    for e in spans:
        if (e.get("cat") == "user_annotation"
                and e.get("name", "").startswith(SPAN)):
            marks.setdefault(e["name"][len(SPAN):], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    for iv in marks.values():
        iv.sort()
    launched = {_corr(e): float(e["ts"]) for e in spans
                if e.get("cat") in LAUNCH_CATS and _corr(e) is not None}
    out = {name: {"calls": len(iv), "device_s": 0.0}
           for name, iv in marks.items()}
    for e in spans:
        t = launched.get(_corr(e)) if e.get("cat") in DEVICE_CATS else None
        if t is None:
            continue
        for name, iv in marks.items():
            k = bisect.bisect_right(iv, (t, float("inf"))) - 1
            if k >= 0 and iv[k][0] <= t <= iv[k][1]:
                out[name]["device_s"] += float(e["dur"]) * 1e-6
    return out


def _host_at(host: list, times: list) -> list:
    """For each time (ascending), the innermost host event open at it:
    one sweep with a stack of nested events."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(host) and float(host[i]["ts"]) <= t:
            e = host[i]
            while stack and stack[-1][0] <= float(e["ts"]):
                stack.pop()
            stack.append((float(e["ts"]) + float(e["dur"]), e["name"]))
            i += 1
        while stack and stack[-1][0] <= t:
            stack.pop()
        name = stack[-1][1] if stack else REQUEST
        out.append("host python" if name == REQUEST else name)
    return out


@contextlib.contextmanager
def _annotated(spans: dict):
    """Wrap each `(obj, attr)` of `spans` in a `SPAN + name` annotation
    for the duration (an attribute of the instance, removed after)."""
    saved = []
    for name, (obj, attr) in spans.items():
        saved.append((obj, attr, vars(obj).get(attr)))
        fn = getattr(obj, attr)

        def wrapped(*a, _fn=fn, _label=SPAN + name, **kw):
            with torch.profiler.record_function(_label):
                return _fn(*a, **kw)

        setattr(obj, attr, wrapped)
    try:
        yield
    finally:
        for obj, attr, old in saved:
            if old is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, old)


def traced(request, count: int, path: Path, spans: dict = None) -> Trace:
    """Run `request(i)` for i < count under the profiler, with the program
    calls of `spans` annotated; return the summary of its trace."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    path.parent.mkdir(parents=True, exist_ok=True)
    with _annotated(spans or {}), \
            torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            for i in range(count):
                with torch.profiler.record_function(REQUEST):
                    request(i)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return summarize(events)
