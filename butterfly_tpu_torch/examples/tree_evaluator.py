"""Fast Hankel evaluation with the adaptive piecewise-Chebyshev EvalTree.

Twin of the JAX package's `examples/tree_evaluator.py` (reference:
examples/tree_evaluator/test_hankel_evaluator.c and simple_evaluator.py):
build EvalTrees for J0/Y0 (the real/imaginary parts of H0), compare
accuracy and speed against direct special-function evaluation over a dense
argument sweep, and print the leaf statistics the reference's plot script
visualizes (make_hankel_evaluator_plots.py). Host NumPy, as there.

Usage:
  python -m butterfly_tpu_torch.examples.tree_evaluator [--a 0.5]
      [--b 500] [--tol 1e-12]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import scipy.special as ss

from butterfly_tpu_torch.ops.eval_tree import EvalTree


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--a", type=float, default=0.5)
    ap.add_argument("--b", type=float, default=500.0)
    ap.add_argument("--tol", type=float, default=1e-12)
    ap.add_argument("--order", type=int, default=16)
    ap.add_argument("--n", type=int, default=200_000)
    args = ap.parse_args(argv)

    funcs = {"J0": lambda x: ss.jv(0, x), "Y0": lambda x: ss.yv(0, x)}
    rng = np.random.default_rng(0)
    x = rng.uniform(args.a, args.b, args.n)

    out = {}
    for name, f in funcs.items():
        t0 = time.perf_counter()
        tree = EvalTree(f, args.a, args.b, tol=args.tol, order=args.order)
        t_build = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = tree(x)
        t_tree = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = f(x)
        t_direct = time.perf_counter() - t0
        err = float(np.abs(got - want).max())
        print(f"{name}: {tree.num_leaves} leaves (order {args.order}) "
              f"built in {t_build*1e3:.1f} ms")
        print(f"  eval {args.n} pts: tree {t_tree*1e3:.1f} ms vs direct "
              f"{t_direct*1e3:.1f} ms (x{t_direct/max(t_tree,1e-12):.1f}), "
              f"max abs err {err:.2e}")
        out[name] = {"leaves": tree.num_leaves, "max_abs_err": err}
    return out


if __name__ == "__main__":
    main()
