"""A closed loop of block applies of the partition plan: one user applying
the compressed kernel matrix to many fields at once.

A request is `PartitionPlan.apply` on one block of `cols` float32 columns
in the plan's interleaved real layout, tree order (row 2i = Re, 2i+1 = Im
of point perm[i]), from a pool of `pool` blocks made on the card from the
seed and cycled in a seeded order; it ends when the output block is
complete on the card (one synchronise a request).

End to end: `apply_cols_per_s`, all columns applied over the window.
Checked: the outputs of a seeded sample of requests (each kept with
probability `check_share`, and always the first and the last), every
column against the reference's float64 K x in the original point order
(`column_err_max` against the cell's limit `column_err`).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import traffic
from portbench.reference import bie


def prepare(run) -> None:
    cfg, tr = run.cell.config, run.cell.traffic
    run.system = run.bench.module("systems", cfg["system"]).build(
        cfg, run.device, {"plan"})
    run.mark("system_built")
    run.state["perm"] = run.system.perm
    run.state["pool"] = traffic.block_pool(2 * run.system.n, tr, run.seed,
                                           run.device)
    run.state["order"] = traffic.order(run.seed, len(run.state["pool"]))
    run.mark("pool_made")
    request(run, 0)  # warm-up: the cell's one shape


def request(run, i: int) -> torch.Tensor:
    pool, order = run.state["pool"], run.state["order"]
    y = run.system.plan.apply(pool[order[i % len(order)]])
    run.sync()
    return y


def window(run) -> None:
    order = run.state["order"]
    share = float(run.cell.traffic["check_share"])
    keep_rng = traffic.rng(run.seed, "keep")
    kept = []
    t0 = time.perf_counter()
    t_end = t0
    i = 0
    last = None
    while time.perf_counter() - t0 < run.seconds:
        y = request(run, i)
        t_end = time.perf_counter()
        j = int(order[i % len(order)])
        if i == 0 or keep_rng.random() < share:
            kept.append((j, y))
            last = None
        else:
            last = (j, y)
        i += 1
    if last is not None:
        kept.append(last)
    run.window_s = t_end - t0
    run.state.update(attempted=i, kept=kept)


def end_to_end(run) -> dict:
    cols = int(run.cell.traffic["cols"])
    return {"apply_cols_per_s": cols * run.state["attempted"]
            / run.window_s}


def release(run) -> None:
    run.state.pop("order", None)


def original_order(block: torch.Tensor, perm: np.ndarray) -> torch.Tensor:
    """(2n, r) interleaved real in tree order -> (n, r) complex128 in the
    original point order."""
    z = torch.complex(block[0::2].double(), block[1::2].double())
    out = torch.empty_like(z)
    out[torch.as_tensor(perm, device=z.device)] = z
    return out


def check(run):
    st = run.state
    prob = bie.Problem(run.cell.config, run.device)
    limit = float(run.cell.workload["limits"]["column_err"])
    worst, failed = 0.0, 0
    for j in sorted({j for j, _ in st["kept"]}):
        X = original_order(st["pool"][j], st["perm"])
        want = prob.matmul(prob.kernel_rows, X)
        for jj, y in st["kept"]:
            if jj != j:
                continue
            err = bie.column_errors(original_order(y, st["perm"]), want)
            worst = max(worst, float(err.max()))
            failed += int(err.max() > limit)
    return {"column_err_max": (worst, limit)}, failed
