"""The control of `correct`: the reference put in the program's place, one
precision below the program's (TF32 operands for IEEE float32), on a
cell's own inputs at its own size, read by the same comparison as a run.

  python3 -m portbench.control --workload <cell> --seeds 1 2 3

prints one JSON line per seed with the number that decides the cell's
`correct` and its limit. Solve cells: the dense system solved with TF32
operands for every right-hand side of the pool (`residual_max`). Block
applies: K x with TF32 operands for every block of the pool
(`column_err_max`). The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from portbench import harness, traffic
from portbench.reference import bie


def control_numbers(cell: harness.Cell, seed: int, device) -> dict:
    prob = bie.Problem(cell.config, device)
    tr = cell.traffic
    if tr["driver"] == "solve_loop":
        B = traffic.rhs_pool(cell.config, tr, seed).T
        S = bie.control_solve(prob, torch.as_tensor(B))
        res = bie.solve_residuals(prob, B, S)
        return {"residual_max": (float(res.max()),
                                 float(cell.workload["limits"]["residual"]))}
    if tr["driver"] == "block_apply":
        worst = 0.0
        for blk in traffic.block_pool(2 * prob.n, tr, seed, device):
            X = torch.complex(blk[0::2].double(), blk[1::2].double())
            err = bie.apply_errors(prob, X, bie.control_apply(prob, X))
            worst = max(worst, float(err.max()))
        limit = float(cell.workload["limits"]["column_err"])
        return {"column_err_max": (worst, limit)}
    raise ValueError(f"no control for driver {tr['driver']!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.Bench().cell(args.workload)
    for seed in args.seeds:
        nums = control_numbers(cell, seed, "cuda:0")
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "numbers": {k: {"value": v, "limit": lim}
                                      for k, (v, lim) in nums.items()},
                          "fails": any(v > lim for v, lim in nums.values())}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
