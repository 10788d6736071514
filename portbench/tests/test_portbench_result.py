"""The last line's shape, the refusal without a card, and the check for
JAX in the process."""

from __future__ import annotations

import json
import subprocess
import sys
import types

import pytest

from portbench import harness
from portbench.tests.conftest import run_cell


@pytest.mark.parametrize("cell", ["bie_solve", "bie_apply"])
def test_result_shape(tiny, cell):
    out = run_cell(tiny, cell)
    assert list(out)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(out)
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    want = {m["name"] for m in tiny.cell(cell).end_to_end}
    assert set(out["metrics"]) == want
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        out["device"])
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(out)


def test_traced_result_shape(tiny):
    out = run_cell(tiny, "bie_solve", trace=True)
    # on the CPU the device readers find nothing and stay silent
    assert set(out["metrics"]) == {"gmres_iters", "host_fac_s"}
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(out)[-1] == "checks"


def test_no_card_no_result():
    proc = subprocess.run(
        [sys.executable, str(harness.ROOT / "portbench" / "run.py"),
         "--workload", "bie_solve", "--seed", "3", "--seconds", "1",
         "--trace", "0"],
        capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 2
    assert proc.stdout == ""
    assert "needs 1 CUDA device" in proc.stderr


def test_forbidden_modules_compare_whole_names(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "butterfly_tpu_torch_x",
                        types.ModuleType("butterfly_tpu_torch_x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "butterfly_tpu.ops",
                        types.ModuleType("butterfly_tpu.ops"))
    assert harness.forbidden_modules() == ["butterfly_tpu", "jax"]
