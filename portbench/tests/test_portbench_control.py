"""What decides `correct` fails where it must: the control (the reference
one precision below the program's) and runs with the timed path broken
underneath, each at a size the CPU holds; and the control at a cell's own
size on the card."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import control, harness
from portbench.tests.conftest import run_cell

CELLS = ["bie_solve", "bie_apply"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_its_limit(tiny, cell):
    nums = control.control_numbers(tiny.cell(cell), 2**31 + 99, "cpu")
    assert any(v > lim for v, lim in nums.values())


def _solve_fault(kind):
    from butterfly_tpu_torch.ops import linalg

    real = linalg.solve_gmres_plan
    calls = []

    def broken(op, b, **kw):
        res = real(op, b, **kw)
        calls.append(1)
        if kind == "state_unchanged":     # the initial guess handed back
            res.x = np.zeros_like(res.x)
        elif kind == "answer_altered" and len(calls) == 3:
            res.x = res.x * (1 + 1e-3)
        return res

    return linalg, "solve_gmres_plan", broken


def _apply_fault(kind):
    from butterfly_tpu_torch.fac.partition import PartitionPlan

    real = PartitionPlan.apply
    calls = []

    def broken(self, x):
        calls.append(1)
        if kind == "state_unchanged":
            return x.clone()
        y = real(self, x)
        if kind == "half_batch":          # half the columns left out
            y[:, x.shape[1] // 2:] = 0
        elif kind == "answer_altered" and len(calls) == 2:
            y[:, 5] *= 1.01
        return y

    return PartitionPlan, "apply", broken


@pytest.mark.parametrize("cell,kind", [
    ("bie_solve", "state_unchanged"), ("bie_solve", "answer_altered"),
    ("bie_apply", "state_unchanged"), ("bie_apply", "half_batch"),
    ("bie_apply", "answer_altered"),
])
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, cell, kind):
    target, name, broken = (_apply_fault(kind) if cell == "bie_apply"
                            else _solve_fault(kind))
    monkeypatch.setattr(target, name, broken)
    out = run_cell(tiny, cell)
    assert out["correct"] is False
    assert out["failed"] >= 1


@pytest.mark.card
@pytest.mark.parametrize("cell", ["bie_solve", "bie_apply"])
def test_control_fails_at_the_cells_size(card, cell):
    nums = control.control_numbers(harness.Bench().cell(cell), 2**31 + 5,
                                   card)
    assert any(v > lim for v, lim in nums.values())
    torch.cuda.empty_cache()
