"""Adapters from a configuration to the program under test.

`systems/<name>.py` (the configuration's `system` key) has
`build(config, device, needs) -> System`. It builds, through the
program's own entry points, only what the cell's driver `needs`
("plan" for block applies, "solve" for solves).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch


@dataclasses.dataclass
class System:
    """What a driver and the per-layer readers use of the program."""

    n: int
    perm: np.ndarray            # tree position -> original point index
    host_op: object             # the host factorization (tree order)
    plan: object                # the program's PartitionPlan
    corrector: object = None    # the KR corrector, where the system has one
    solve: Callable = None      # rhs (n,) host -> (density, iters, converged)
    timings: dict = dataclasses.field(default_factory=dict)

    @property
    def spans(self) -> dict:
        """The program calls whose device time a traced run reads:
        {name: (object, method name)}."""
        out = {"plan": (self.plan, "apply")}
        if self.corrector is not None:
            out["corrector"] = (self.corrector, "apply")
        return out


class Clock:
    """Seconds spent in named set-up steps, by the host clock."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.timings: dict = {}

    def __call__(self, name: str, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timings[name] = time.perf_counter() - t0
        return out


def gmres_solver(op, perm: np.ndarray, device, gmres: dict):
    """A user's solve: the right-hand side as a host array in the original
    point order, handed to the card in tree order, solved by the program's
    `solve_gmres_plan` (complex64 basis on the card) with the
    configuration's settings, the density returned to the host in the
    original order."""
    from butterfly_tpu_torch.ops.linalg import solve_gmres_plan

    perm = np.asarray(perm)
    n = perm.shape[0]

    def solve(rhs: np.ndarray):
        b = torch.from_numpy(np.asarray(rhs, np.complex64)[perm]).to(device)
        res = solve_gmres_plan(op, b, tol=float(gmres["tol"]),
                               restart=int(gmres["restart"]),
                               max_iter=int(gmres["max_iter"]))
        out = np.empty(n, np.complex128)
        out[perm] = res.x
        return out, int(res.num_iter), bool(res.converged)

    return solve
