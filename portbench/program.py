"""The program's own spans in a traced run: two sub-windows after the
traced window, each of the traffic's `trace_requests` requests, with the
program's tracing on (`butterfly_tpu_torch.utils.profiling`):

(a) without the profiler: each span's calls, host time and self time,
    the program's counters and its CUDA-event gaps, and the time a
    request, against the measured window's first requests (the same
    inputs, tracing off);
(b) under `torch.profiler`, written to
    `build/portbench/trace_<cell>_program.json`: the device's idle time
    inside the window split by the innermost `bf.<span>` annotation open
    at each instant of a gap, `outside` where none is, after a check of
    the trace's two clocks (`clock_check`).

`windows(run)` runs both once, on a card and where the program has the
spans (else it returns None, and so do the readers), and keeps the result
in `run.state["program"]`. It also writes the result to
`build/portbench/program_<cell>.json` and prints it to standard error as
one line, `program {...}`, before the checks' lines.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from portbench import trace

PREFIX = "bf."
OUTSIDE = "outside"
# the solver's round trip: the host's steps between two applies
ROUND_TRIP = ("gmres.read", "gmres.givens", "gmres.update",
              "gmres.residual")


def _profiling():
    """The program's tracing module, or None where it has none."""
    from butterfly_tpu_torch.utils import profiling

    return profiling if hasattr(profiling, "tracing") else None


def windows(run):
    """The two sub-windows' result (see the module's doc), run on the
    first call of a run; None off the card or without the spans."""
    if "program" in run.state:
        return run.state["program"]
    run.state["program"] = None
    prof = _profiling()
    if prof is None or not run.on_card or run.traced is None:
        return None
    driver = run.bench.module("drivers", run.cell.traffic["driver"])
    count = int(run.cell.traffic["trace_requests"])
    out = run.bench.root / "build" / "portbench"
    path = out / f"trace_{run.cell.name}_program.json"
    was = prof.tracing(True)
    try:
        prof.reset()
        lat = []
        for i in range(count):
            t0 = time.perf_counter()
            driver.request(run, i)
            run.sync()
            lat.append(time.perf_counter() - t0)
        snap = prof.snapshot()
        prof.reset()
        trace.traced(lambda i: driver.request(run, i), count, path)
    finally:
        prof.tracing(was)
        prof.reset()
    with open(path) as f:
        split = idle_split(json.load(f)["traceEvents"])
    parts = split.pop("parts")
    block = {"requests": count, "ms_per_request": 1e3 * sum(lat) / count,
             **_window_ms(run, count),
             "spans": [[n, s] for n, s in sorted(
                 snap["spans"].items(),
                 key=lambda x: -x[1]["self_s"])[:10]],
             "counters": trace._top(snap["counters"]),
             "gaps": snap["gaps"], **split,
             "idle_split": trace._top(parts),
             "round_trip_idle_pct": round_trip_share(parts)}
    run.state["program"] = block
    (out / f"program_{run.cell.name}.json").write_text(json.dumps(block))
    print("program " + json.dumps(block), file=sys.stderr, flush=True)
    return block


def _window_ms(run, count: int) -> dict:
    """The measured window's ms a request, over all of it and over its
    first `count` requests (where the driver keeps latencies)."""
    out = {}
    if run.window_s and run.state.get("attempted"):
        out["window_ms_per_request"] = (1e3 * run.window_s
                                        / run.state["attempted"])
    lat = run.state.get("latencies") or []
    if len(lat) >= count:
        out["window_ms_first"] = 1e3 * sum(lat[:count]) / count
    return out


def _window(spans: list) -> tuple:
    win = [e for e in spans if e.get("name") == trace.WINDOW
           and e.get("cat") == "user_annotation"]
    if len(win) != 1:
        raise RuntimeError(f"expected one {trace.WINDOW} span, found "
                           f"{len(win)}")
    w0 = float(win[0]["ts"])
    return w0, w0 + float(win[0]["dur"])


def _pieces(marks: list, w0: float, w1: float) -> list:
    """[(a, b, name)] covering [w0, w1] in order: the innermost mark
    (the open one that started last) over each piece, OUTSIDE where none
    is open. `marks` are (start, end, name), clipped to the window."""
    pts = []
    for k, (a, b, _) in enumerate(marks):
        a, b = max(a, w0), min(b, w1)
        if b > a:
            pts += [(a, 1, k), (b, 0, k)]
    pts.sort()          # at one instant: ends first, then outer starts
    out, open_, t = [], [], w0
    for at, start, k in pts:
        if at > t:
            out.append((t, at, marks[open_[-1]][2] if open_ else OUTSIDE))
            t = at
        if start:
            open_.append(k)
        else:
            open_.remove(k)
    if w1 > t:
        out.append((t, w1, OUTSIDE))
    return out


def idle_split(events: list) -> dict:
    """The device's idle time inside the traced window (microsecond
    Chrome-trace events), split by the innermost `bf.*` annotation open
    at each instant. `parts`: {span name or OUTSIDE: seconds}, summing to
    `idle_s`; `busy_s` and `window_s` as `trace.summarize` reads them, on
    the device clock as `clock_check` leaves it; `clock`, its reading."""
    spans = [e for e in events if e.get("ph") == "X"]
    w0, w1 = _window(spans)
    clock = clock_check(spans)
    to_host = clock.pop("to_host")
    dev = []
    for e in spans:
        if e.get("cat") in trace.DEVICE_CATS:
            a = float(e["ts"])
            a, b = to_host(a), to_host(a + float(e["dur"]))
            a, b = max(a, w0), min(b, w1)
            if b > a:
                dev.append((a, b))
    busy = trace._union(dev)
    gaps, t = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    marks = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"][len(PREFIX):]) for e in spans
                    if e.get("cat") == "user_annotation"
                    and e.get("name", "").startswith(PREFIX)),
                   key=lambda m: (m[0], -m[1]))
    pieces = _pieces(marks, w0, w1)
    parts: dict = {}
    i = 0
    for g0, g1 in gaps:
        while pieces[i][1] <= g0:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < g1:
            a, b, name = pieces[j]
            parts[name] = parts.get(name, 0.0) + (min(b, g1)
                                                  - max(a, g0)) * 1e-6
            j += 1
    return {"parts": parts,
            "idle_s": sum(b - a for a, b in gaps) * 1e-6,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "window_s": (w1 - w0) * 1e-6, "clock": clock}


# A launch into an idle card starts its work this long (us) after the host
# call begins: the least lead seen on the H100 in profiler sessions whose
# clocks agree (4.0-17.6 us a tenth of the window).
LAUNCH_LEAD_US = 5.0
# Above this drift (us a us) between the clocks, or with a device event
# more than LAUNCH_LEAD_US ahead of its launch (a lead of -0.3 us has been
# seen in a session whose clocks agree), the device events are mapped onto
# the host clock.
MAX_DRIFT = 1e-4
BUCKETS = 20


def clock_check(spans: list) -> dict:
    """Whether the trace's device clock agrees with its host clock: the
    lead of each device event's start over the start of the host call
    that launched it (correlation ids), its least value in each twentieth
    of the trace, and the line through those (`drift`, us a us). A
    profiler session has been seen to drift by 0.21% to 2.3% (device
    events up to 21.6 ms ahead of their launches at the window's end):
    then `to_host` maps device times onto the host clock so that the
    line's leads read `LAUNCH_LEAD_US`; else it leaves them."""
    launch = {trace._corr(e): float(e["ts"]) for e in spans
              if e.get("cat") in trace.LAUNCH_CATS
              and trace._corr(e) is not None}
    pts = sorted((float(e["ts"]), float(e["ts"]) - launch[trace._corr(e)])
                 for e in spans if e.get("cat") in trace.DEVICE_CATS
                 and trace._corr(e) in launch)
    out = {"min_lead_us": min((p[1] for p in pts), default=None),
           "drift": None, "realigned": False, "to_host": lambda t: t}
    if len(pts) < 2 * BUCKETS or pts[-1][0] <= pts[0][0]:
        return out
    t0, span_us = pts[0][0], pts[-1][0] - pts[0][0]
    low: dict = {}
    for t, lead in pts:
        k = min(int(BUCKETS * (t - t0) / span_us), BUCKETS - 1)
        if k not in low or lead < low[k][1]:
            low[k] = (t - t0, lead)
    drift, at0 = np.polyfit(*zip(*low.values()), 1)
    out["drift"] = float(drift)
    if abs(drift) > MAX_DRIFT or out["min_lead_us"] < -LAUNCH_LEAD_US:
        out["realigned"] = True
        out["to_host"] = (lambda t: t - (drift * (t - t0) + at0
                                         - LAUNCH_LEAD_US))
    return out


def round_trip_share(parts: dict) -> float | None:
    """The share (%) of the split's idle time under the solver's round
    trip (`ROUND_TRIP`)."""
    idle = sum(parts.values())
    if idle <= 0:
        return None
    return 100.0 * sum(parts.get(n, 0.0) for n in ROUND_TRIP) / idle


def per_iteration_us(run, name: str) -> float | None:
    """Microseconds of self time of span `name` a `gmres.iters`, in
    sub-window (a)."""
    block = windows(run)
    if not block:
        return None
    iters = dict(block["counters"]).get("gmres.iters")
    stats = dict(block["spans"]).get(name)
    if not iters or not stats:
        return None
    return 1e6 * stats["self_s"] / iters
