"""A closed loop of single right-hand-side solves: one user sweeping over
right-hand sides, each sent once the previous density is back.

A request hands the program a right-hand side from the pool (a host array
in the original point order, the pool cycled in a seeded order) and ends
when the density is back on the host. The window starts solves until
`--seconds` have passed and closes when the last one ends.

End to end: `solve_ms`, the window over the solves completed in it;
`solve_ms_p95`, the 95th percentile of their host-clock latencies.
Checked: every density of the window, by its residual in the reference's
float64 system (`residual_max` against the cell's limit `residual`); a
solve that did not converge by the program's own test, or whose residual
is over the limit, counts as failed.
"""

from __future__ import annotations

import time

import numpy as np

from portbench import traffic
from portbench.reference import bie


def prepare(run) -> None:
    cfg, tr = run.cell.config, run.cell.traffic
    run.system = run.bench.module("systems", cfg["system"]).build(
        cfg, run.device, {"solve"})
    run.mark("system_built")
    run.state["pool"] = traffic.rhs_pool(cfg, tr, run.seed)
    run.state["order"] = traffic.order(run.seed, len(run.state["pool"]))
    run.mark("pool_made")
    request(run, 0)  # warm-up: the cell's one shape


def request(run, i: int):
    pool, order = run.state["pool"], run.state["order"]
    return run.system.solve(pool[order[i % len(order)]])


def window(run) -> None:
    order = run.state["order"]
    lat, iters, conv, idx, dens = [], [], [], [], []
    t0 = time.perf_counter()
    t_end = t0
    i = 0
    while time.perf_counter() - t0 < run.seconds:
        ts = time.perf_counter()
        sigma, it, ok = request(run, i)
        t_end = time.perf_counter()
        lat.append(t_end - ts)
        iters.append(it)
        conv.append(ok)
        idx.append(int(order[i % len(order)]))
        dens.append(sigma)
        i += 1
    run.window_s = t_end - t0
    run.state.update(attempted=i, latencies=lat, iters=iters,
                     converged=conv, pool_index=idx, densities=dens)


def end_to_end(run) -> dict:
    lat = run.state["latencies"]
    return {"solve_ms": 1e3 * run.window_s / len(lat),
            "solve_ms_p95": 1e3 * float(np.percentile(lat, 95))}


def release(run) -> None:
    run.state.pop("order", None)


def check(run):
    st = run.state
    prob = bie.Problem(run.cell.config, run.device)
    B = np.stack([st["pool"][j] for j in st["pool_index"]], 1)
    S = np.stack(st["densities"], 1)
    res = bie.solve_residuals(prob, B, S)
    limit = float(run.cell.workload["limits"]["residual"])
    failed = int(np.sum((res > limit) | ~np.asarray(st["converged"])))
    st["residuals"] = res
    return {"residual_max": (float(res.max()), limit)}, failed
