"""The traced window's reduction: busy time, and the device time of the
program calls the run names, attributed through the profiler's
correlation ids."""

from __future__ import annotations

import pytest

from portbench import trace


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    _ev("user_annotation", trace.WINDOW, 0, 100),
    _ev("user_annotation", trace.SPAN + "plan", 10, 20),
    _ev("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=1),
    _ev("kernel", "k2", 15, 30, corr=1),          # runs past its span
    _ev("cuda_runtime", "cudaLaunchKernel", 50, 1, corr=2),
    _ev("kernel", "other", 52, 5, corr=2),        # launched outside
    _ev("user_annotation", trace.SPAN + "plan", 60, 10),
    _ev("cuda_driver", "cuLaunchKernel", 61, 1, corr=3),
    _ev("kernel", "k2", 62, 4, corr=3),
    _ev("user_annotation", trace.SPAN + "corrector", 80, 5),
    _ev("cuda_runtime", "cudaMemcpyAsync", 81, 1, corr=4),
    _ev("gpu_memcpy", "Memcpy DtoD", 82, 2, corr=4),
]


def test_span_device_time_follows_the_launch():
    t = trace.summarize(EVENTS)
    assert t.spans["plan"]["calls"] == 2
    assert t.spans["plan"]["device_s"] == pytest.approx(34e-6)
    assert t.spans["corrector"] == {"calls": 1,
                                    "device_s": pytest.approx(2e-6)}
    # busy: [15, 45] + [52, 57] + [62, 66] + [82, 84]
    assert t.busy_s == pytest.approx(41e-6)
    assert t.window_s == pytest.approx(100e-6)
    assert dict(t.device_ops)["k2"] == pytest.approx(34e-6)


def test_a_window_without_spans_reads_none():
    t = trace.summarize([e for e in EVENTS if not e["name"].startswith(
        trace.SPAN)])
    assert t.spans == {}


def test_annotation_is_removed_after_the_window():
    class Op:
        def apply(self, x):
            return 2 * x

    op = Op()
    with trace._annotated({"plan": (op, "apply")}):
        assert "apply" in vars(op) and op.apply(3) == 6
    assert "apply" not in vars(op) and op.apply(3) == 6
