"""The port's spans and counters (`utils/profiling.py`) on the CPU: off by
default and silent; on, the GMRES loop's spans nest under one
`gmres.solve` a solve, one of each step an iteration, with self times
that add up; under `torch.profiler` they are `bf.*` annotations in the
Chrome trace, nested and ordered as in the record; the operator applies
beneath the solver (`plan.apply`, `kr.apply`) are recorded on a small BIE
system; a solve's results do not depend on the switch."""

import json

import numpy as np
import pytest
import torch

from butterfly_tpu_torch.examples import helm2_bie
from butterfly_tpu_torch.ops.linalg import solve_gmres_plan
from butterfly_tpu_torch.utils import profiling

STEPS = ("gmres.apply", "gmres.orth", "gmres.read", "gmres.givens")


@pytest.fixture(autouse=True)
def _clean():
    """Each test starts with tracing off and an empty record, and leaves
    them so."""
    was = profiling.tracing(False)
    profiling.reset()
    yield
    profiling.tracing(was)
    profiling.reset()


def _dense_problem(n=48, seed=0):
    rng = np.random.default_rng(seed)
    A = (np.eye(n) * 4 + (rng.standard_normal((n, n))
                          + 1j * rng.standard_normal((n, n))) / np.sqrt(n))
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    At = torch.as_tensor(A, dtype=torch.complex64)
    return (lambda v: At @ v), torch.as_tensor(b, dtype=torch.complex64)


def _solve(apply_fn, b, **kw):
    return solve_gmres_plan(apply_fn, b, tol=1e-5, restart=40, max_iter=40,
                            device="cpu", **kw)


def test_off_by_default_records_nothing(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function called with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    profiling.tracing(False)
    apply_fn, b = _dense_problem()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        res = _solve(apply_fn, b)
    assert res.converged and res.num_iter > 0
    snap = profiling.snapshot()
    assert snap == {"spans": {}, "counters": {}, "gaps": {}, "records": []}
    assert profiling.span("gmres.solve") is profiling.span("plan.apply")


def test_solve_spans_nest_one_step_each_iteration():
    apply_fn, b = _dense_problem()
    profiling.tracing(True)
    res = _solve(apply_fn, b)
    snap = profiling.snapshot()
    recs = snap["records"]
    roots = [i for i, r in enumerate(recs) if r.name == "gmres.solve"]
    assert len(roots) == 1 and recs[roots[0]].parent is None
    root = roots[0]
    assert all(r.request == root for r in recs)
    kids = [r for r in recs if r.parent == root]
    for name in STEPS:
        assert sum(r.name == name for r in kids) == res.num_iter
        assert snap["spans"][name]["calls"] == res.num_iter
    # one cycle: its first residual, the update, the final residual
    assert [r.name for r in kids if r.name not in STEPS] == [
        "gmres.residual", "gmres.update", "gmres.residual"]
    # each iteration's steps in order
    steps = [r.name for r in kids if r.name in STEPS]
    assert steps == list(STEPS) * res.num_iter
    assert snap["counters"] == {"gmres.iters": res.num_iter}
    assert snap["gaps"] == {}       # no card: no event pairs
    # self time is the duration less the children's
    for i, r in enumerate(recs):
        assert r.start_ns <= r.end_ns
        child = sum(c.end_ns - c.start_ns for c in recs if c.parent == i)
        if r.parent is not None:
            p = recs[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
        if r.name == "gmres.solve":
            s = snap["spans"]["gmres.solve"]
            assert s["total_s"] == pytest.approx((r.end_ns - r.start_ns)
                                                 * 1e-9)
            assert s["self_s"] == pytest.approx((r.end_ns - r.start_ns
                                                 - child) * 1e-9)
    total = sum(s["total_s"] for n, s in snap["spans"].items()
                if n != "gmres.solve")
    assert snap["spans"]["gmres.solve"]["self_s"] == pytest.approx(
        snap["spans"]["gmres.solve"]["total_s"] - total)


def test_annotations_in_the_chrome_trace_follow_the_record(tmp_path):
    apply_fn, b = _dense_problem(n=32, seed=1)
    profiling.tracing(True)
    with profiling.device_trace(str(tmp_path)):
        _solve(apply_fn, b)
    recs = profiling.snapshot()["records"]
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    ann = sorted((e for e in events if e.get("ph") == "X"
                  and e.get("cat") == "user_annotation"
                  and e["name"].startswith(profiling.PREFIX)),
                 key=lambda e: (float(e["ts"]), -float(e["dur"])))
    assert [e["name"] for e in ann] == [profiling.PREFIX + r.name
                                        for r in recs]

    # the annotations nest as the spans do: each one's innermost enclosing
    # annotation is its parent's
    def parent(k):
        a0 = float(ann[k]["ts"])
        a1 = a0 + float(ann[k]["dur"])
        inside = [j for j in range(k) if float(ann[j]["ts"]) <= a0
                  and a1 <= float(ann[j]["ts"]) + float(ann[j]["dur"])]
        return inside[-1] if inside else None

    assert [parent(k) for k in range(len(ann))] == [r.parent for r in recs]


@pytest.fixture(scope="module")
def bie():
    """helm2_bie's card system at n=256, k=10, on the CPU (one torch
    thread, as `test_torch_bie.py` runs it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield helm2_bie.setup(256, 10.0, device="cpu")
    finally:
        torch.set_num_threads(n)


def test_plan_and_corrector_applies_are_recorded(bie):
    card = bie.card
    b = card.to_card_complex(bie.rhs)
    profiling.tracing(True)
    res = solve_gmres_plan(card.sys_apply_complex, b, tol=1e-5,
                           restart=100, max_iter=100, device="cpu")
    snap = profiling.snapshot()
    recs = snap["records"]
    # one plan and one corrector apply per system apply: each iteration's
    # and the two true residuals'
    applies = res.num_iter + 2
    assert res.converged
    # no CUDA graph off the card: no replay or capture is counted
    assert snap["counters"] == {"gmres.iters": res.num_iter}
    assert snap["spans"]["plan.apply"]["calls"] == applies
    assert snap["spans"]["kr.apply"]["calls"] == applies
    for r in recs:
        if r.name in ("plan.apply", "kr.apply"):
            assert recs[r.parent].name in ("gmres.apply", "gmres.residual")
    # the operator outside a solve: a span of its own request
    profiling.reset()
    card.plan.apply(torch.zeros((card.plan.n2, 1)))
    (r,) = profiling.snapshot()["records"]
    assert (r.name, r.parent, r.request) == ("plan.apply", None, 0)


def test_snapshot_reset_and_identical_results():
    apply_fn, b = _dense_problem(seed=2)
    off = _solve(apply_fn, b)
    profiling.tracing(True)
    on = _solve(apply_fn, b)
    assert on.num_iter == off.num_iter and on.residuals == off.residuals
    assert np.array_equal(on.x, off.x)
    profiling.count("extra", 3)
    profiling.count("extra")
    snap = profiling.snapshot()
    assert snap["counters"] == {"gmres.iters": on.num_iter, "extra": 4}
    assert set(snap["spans"]) == {"gmres.solve", "gmres.residual",
                                  "gmres.update", *STEPS}
    for s in snap["spans"].values():
        assert 0 <= s["self_s"] <= s["total_s"]
    # a span open across reset() is dropped, and leaves no trace behind
    with profiling.span("outer"):
        profiling.reset()
        with profiling.span("inner"):
            pass
    snap = profiling.snapshot()
    assert [r.name for r in snap["records"]] == ["inner"]
    assert snap["counters"] == {} and snap["gaps"] == {}
    profiling.reset()
    assert profiling.snapshot()["records"] == []
    assert profiling.tracing(False) is True
    profiling.count("extra")
    assert profiling.snapshot()["counters"] == {}


class _FakeEvent:
    """Stands in for `torch.cuda.Event`: `record` stamps a counter's next
    value as the event's time in ms."""

    made = 0
    clock = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _FakeEvent.made += 1
        self.t = None

    def record(self, stream=None):
        _FakeEvent.clock += 1
        self.t = _FakeEvent.clock

    def elapsed_time(self, end):
        return end.t - self.t


def test_event_pairs_close_within_a_cycle_and_are_reused(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(_FakeEvent, "made", 0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    monkeypatch.setattr(profiling, "_free_events", {})
    assert profiling.device_gaps("g", "cuda:0").start() is None  # off
    assert profiling.snapshot()["gaps"] == {}
    profiling.tracing(True)
    assert profiling.device_gaps("g", "cpu") is profiling.device_gaps(
        "h", torch.device("cpu"))
    g = profiling.device_gaps("g", "cuda:0")
    g.stop()                    # nothing open: no pair
    g.start()                   # t=1, replaced by the next start,
    g.start()                   # which records the same event at t=2
    g.stop()                    # t=3: a pair of 1 ms
    g.start()                   # t=4
    g.stop()                    # t=5
    g.start()                   # t=6, left open as the solve ends
    g.flush()
    assert profiling.snapshot()["gaps"] == {
        "g": {"pairs": 2, "total_s": pytest.approx(2e-3)}}
    assert _FakeEvent.made == 5
    # the next solve takes the five events read, and makes one more
    g = profiling.device_gaps("g", "cuda:0")
    for _ in range(3):
        g.start()
        g.stop()
    g.flush()
    assert _FakeEvent.made == 6
    assert profiling.snapshot()["gaps"]["g"]["pairs"] == 5
