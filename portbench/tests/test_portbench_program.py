"""The program's spans in a traced run (`portbench/program.py`): the idle
split by the innermost `bf.*` span at each instant, the four readers that
read the sub-windows, their entries in BENCHMARK.json, and both
sub-windows on a tiny cell on the CPU."""

from __future__ import annotations

import dataclasses
import json
import time

import pytest
import torch

from portbench import harness, program, trace

READERS = ("gmres_givens_us", "gmres_wait_us", "gmres_gap_us",
           "round_trip_idle_pct")


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _bf(name, ts, dur):
    return _ev("user_annotation", program.PREFIX + name, ts, dur)


def test_a_gap_splits_by_the_span_open_at_each_instant():
    events = [
        _ev("user_annotation", trace.WINDOW, 0, 100),
        _bf("gmres.solve", 0, 100),
        _bf("gmres.apply", 0, 22),
        _bf("plan.apply", 1, 20),
        _ev("kernel", "k2", 5, 15),             # busy [5, 20]
        _bf("gmres.orth", 22, 8),
        _ev("kernel", "dot", 24, 6),            # busy [24, 30]
        _bf("gmres.read", 30, 40),
        _ev("gpu_memcpy", "DtoH", 31, 1),       # busy [31, 32]
        _bf("gmres.givens", 70, 10),
        _bf("gmres.apply", 80, 15),
        _ev("kernel", "k2", 90, 15),            # busy [90, 100]
    ]
    split = program.idle_split(events)
    us = {k: pytest.approx(v * 1e-6) for k, v in {
        # [0, 1] under gmres.apply, [1, 5] and [20, 21] under plan.apply,
        # [21, 22] gmres.apply, [22, 24] gmres.orth, then one gap from 32 to
        # 90 across read (32-70), givens (70-80) and the next apply (80-90)
        "gmres.apply": 1 + 1 + 10, "plan.apply": 4 + 1, "gmres.orth": 2,
        "gmres.read": 1 + 38, "gmres.givens": 10}.items()}
    assert split["parts"] == us
    assert split["idle_s"] == pytest.approx(68e-6)
    assert sum(split["parts"].values()) == pytest.approx(split["idle_s"])
    assert split["busy_s"] == pytest.approx(32e-6)
    assert split["window_s"] == pytest.approx(100e-6)
    # the same window as the benchmark's own summary reads it
    t = trace.summarize(events)
    assert t.busy_s == pytest.approx(split["busy_s"])
    assert program.round_trip_share(split["parts"]) == pytest.approx(
        100 * 49 / 68)


def test_idle_outside_every_span_and_past_the_window():
    events = [
        _ev("user_annotation", trace.WINDOW, 10, 50),
        _bf("gmres.read", 0, 20),           # open as the window starts
        _ev("kernel", "k", 25, 5),
        _bf("gmres.update", 40, 30),        # still open as it ends
        _bf("gmres.givens", 45, 0),         # zero length: nothing
    ]
    split = program.idle_split(events)
    assert split["parts"] == {"gmres.read": pytest.approx(10e-6),
                              "outside": pytest.approx(15e-6),
                              "gmres.update": pytest.approx(20e-6)}
    assert split["idle_s"] == pytest.approx(45e-6)
    assert split["clock"]["min_lead_us"] is None   # no correlation ids
    assert program.round_trip_share({}) is None


def test_the_clock_check_reads_a_device_event_before_its_launch():
    events = [
        _ev("user_annotation", trace.WINDOW, 0, 100),
        _ev("cuda_runtime", "cudaLaunchKernel", 10, 2, corr=1),
        _ev("kernel", "k2", 16, 20, corr=1),            # 6 us after
        _ev("cuda_driver", "cuLaunchKernel", 40, 2, corr=2),
        _ev("kernel", "k2", 45, 20, corr=2),            # 5 us after
        _ev("gpu_memcpy", "DtoH", 70, 1, corr=9),       # no launch seen
    ]
    assert program.idle_split(events)["clock"] == {
        "min_lead_us": 5.0, "drift": None, "realigned": False}
    events[4]["ts"] = 37                                # 3 us before
    # too few events to fit a line: read, not realigned
    assert program.idle_split(events)["clock"]["min_lead_us"] == -3
    # enough events over a solve's length: a lead of -1 us is the clocks'
    # jitter, -6 us is not
    base = _iterations(step=20000)
    for ahead, realigned in ((1, False), (6, True)):
        events = json.loads(json.dumps(base))
        events[5]["ts"] -= 5 + ahead                    # the first kernel
        clock = program.idle_split(events)["clock"]
        assert clock["min_lead_us"] == pytest.approx(-ahead)
        assert clock["realigned"] is realigned


def _iterations(n=60, skew=None, step=100):
    """n solver iterations `step` us apart on the host clock: the apply's
    launch at step i (its kernel 5 us later, 40 us long), the read from
    step i + 20 for step - 50 us, then the Givens step for 30 us; the card
    idles from step i + 45 to the next kernel. `skew` maps the true
    device times to the ones the trace reports."""
    skew = skew or (lambda t: t)
    ev = [_ev("user_annotation", trace.WINDOW, 0, step * n)]
    for k in range(n):
        t = step * k
        ev += [_bf("gmres.apply", t, 20),
               _bf("gmres.read", t + 20, step - 50),
               _bf("gmres.givens", t + step - 30, 30),
               _ev("cuda_runtime", "cudaLaunchKernel", t, 3, corr=k)]
        a, b = skew(t + 5), skew(t + 45)
        ev.append(_ev("kernel", "k2", a, b - a, corr=k))
    return ev


def test_a_drifting_device_clock_is_mapped_onto_the_host_clock():
    true = program.idle_split(_iterations())
    assert true["clock"]["realigned"] is False
    assert true["clock"]["drift"] == pytest.approx(0, abs=1e-9)
    # 59 gaps of 25 us under the read, 30 under the Givens step and 5
    # under the next apply, one of 5 us before the first kernel and one
    # of 55 after the last
    assert true["parts"] == {"gmres.read": pytest.approx(1500e-6),
                             "gmres.givens": pytest.approx(1800e-6),
                             "gmres.apply": pytest.approx(300e-6)}
    assert program.round_trip_share(true["parts"]) == pytest.approx(
        100 * 3300 / 3600)
    # the device clock 2% slow and 300 us behind, as a broken profiler
    # session reads it: every kernel ahead of its launch
    skewed = program.idle_split(
        _iterations(skew=lambda t: 0.98 * t - 300))
    clock = skewed["clock"]
    assert clock["realigned"] is True and clock["min_lead_us"] < -300
    assert clock["drift"] == pytest.approx(1 - 1 / 0.98, rel=1e-6)
    assert skewed["parts"] == {k: pytest.approx(v, rel=1e-6)
                               for k, v in true["parts"].items()}
    assert skewed["busy_s"] == pytest.approx(true["busy_s"], rel=1e-6)
    # the map takes the first kernel back to 5 us after its launch
    to_host = program.clock_check(_iterations(
        skew=lambda t: 0.98 * t - 300))["to_host"]
    assert to_host(0.98 * 5 - 300) == pytest.approx(5.0)


def _block(**kw):
    b = {"counters": [["gmres.iters", 50]],
         "spans": [["gmres.givens", {"calls": 50, "total_s": 6e-3,
                                     "self_s": 5e-3}],
                   ["gmres.read", {"calls": 50, "total_s": 0.05,
                                   "self_s": 0.05}]],
         "gaps": {"gmres.gap": {"pairs": 40, "total_s": 8e-3}},
         "busy_s": 0.5, "round_trip_idle_pct": 42.0}
    b.update(kw)
    return b


@dataclasses.dataclass
class FakeRun:
    state: dict


def _reader(name):
    return harness.Bench().module("metrics", name).read


def test_readers_read_the_block():
    run = FakeRun({"program": _block()})
    assert _reader("gmres_givens_us")(run) == pytest.approx(100.0)
    assert _reader("gmres_wait_us")(run) == pytest.approx(1000.0)
    assert _reader("gmres_gap_us")(run) == pytest.approx(200.0)
    assert _reader("round_trip_idle_pct")(run) == 42.0


@pytest.mark.parametrize("block", [
    None,
    _block(counters=[], gaps={}, busy_s=0.0),
    _block(spans=[], gaps={"gmres.gap": {"pairs": 0, "total_s": 0.0}},
           busy_s=0.0),
], ids=["no-sub-windows", "no-counter-no-gaps", "no-spans-no-pairs"])
def test_each_reader_reads_none_without_its_data(block):
    run = FakeRun({"program": block})
    for name in READERS:
        assert _reader(name)(run) is None, name


def test_the_manifest_lists_the_four_readers():
    manifest = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in manifest["per_layer"]}
    for name in READERS:
        m = entries[name]
        assert m["workloads"] == ["bie_solve"] and m["moves"] == "solve_ms"
        assert m["better"] == "lower"
        assert m["layer"] == entries["gmres_iters"]["layer"]
        harness.Bench().find("metrics", f"{name}.py")
    assert entries["round_trip_idle_pct"]["source"] == "device_trace"
    # appended after the metrics the benchmark had: their readers run
    # first, on the traced window, before the sub-windows
    names = [m["name"] for m in manifest["per_layer"]]
    assert names[-4:] == list(READERS)


class CardlessRun(harness.Run):
    """A CPU run that lets the sub-windows run as on a card."""

    on_card = True

    def sync(self) -> None:
        pass


def test_sub_windows_on_a_tiny_cell(tiny):
    cell = tiny.cell("bie_solve")
    run = CardlessRun(tiny, cell, 2**31 + 11, 0.0, True,
                      torch.device("cpu"), time.perf_counter())
    driver = tiny.module("drivers", cell.traffic["driver"])
    driver.prepare(run)
    count = int(cell.traffic["trace_requests"])
    # a measured window of count + 2 solves of 50 ms each, as the driver
    # keeps it
    run.window_s = 0.05 * (count + 2)
    run.state.update(attempted=count + 2, latencies=[0.05] * (count + 2))
    run.traced = object()
    block = program.windows(run)
    assert program.windows(run) is block
    iters = dict(block["counters"])["gmres.iters"]
    assert iters == sum(driver.request(run, i)[1] for i in range(count))
    spans = dict(block["spans"])
    assert spans["gmres.solve"]["calls"] == count
    assert spans["gmres.givens"]["calls"] == iters
    assert block["gaps"] == {}                  # no CUDA events on a CPU
    assert sum(s for _, s in block["idle_split"]) == pytest.approx(
        block["idle_s"])
    assert block["ms_per_request"] > 0
    assert block["window_ms_first"] == pytest.approx(50.0)
    assert block["window_ms_per_request"] == pytest.approx(50.0)
    for name in READERS:
        value = _reader(name)(run)
        assert (value is None) == (name in ("gmres_gap_us",
                                            "round_trip_idle_pct")), name
    out = tiny.root / "build" / "portbench"
    assert json.loads((out / "program_bie_solve.json").read_text()) == \
        json.loads(json.dumps(block))
    assert (out / "trace_bie_solve_program.json").is_file()

