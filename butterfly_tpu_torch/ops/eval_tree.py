"""Adaptive piecewise-Chebyshev scalar function evaluation.

Replacement for the reference's EvalTree (src/eval_tree.c:18-73; test
examples/tree_evaluator/test_hankel_evaluator.c): subdivide [a, b] in a
k-ary tree until a fixed-order Chebyshev fit meets the tolerance on every
leaf, then evaluate by binary search + Clenshaw. The classic use is fast
Hankel-function evaluation at many arguments.

Port counterpart of `butterfly_tpu/ops/eval_tree.py`, copied: host NumPy,
as in the JAX package.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from butterfly_tpu_torch.ops.cheb import ChebFit
from butterfly_tpu_torch.utils.errors import InvalidArgumentsError, check

__all__ = ["EvalTree"]


class EvalTree:
    """Piecewise-Chebyshev approximation of f on [a, b]."""

    def __init__(
        self,
        f: Callable[[np.ndarray], np.ndarray],
        a: float,
        b: float,
        tol: float = 1e-12,
        order: int = 16,
        arity: int = 2,
        max_depth: int = 40,
    ):
        check(b > a, "empty interval", InvalidArgumentsError)
        self.f, self.order, self.tol = f, order, tol
        edges: list[float] = []
        fits: list[ChebFit] = []

        def build(lo: float, hi: float, depth: int) -> None:
            fit = ChebFit(f, lo, hi, order)
            if fit.max_error(f, 4 * order) <= tol or depth >= max_depth:
                edges.append(lo)
                fits.append(fit)
                return
            step = (hi - lo) / arity
            for q in range(arity):
                build(lo + q * step, lo + (q + 1) * step, depth + 1)

        build(float(a), float(b), 0)
        edges.append(float(b))
        self.edges = np.asarray(edges)
        self.fits = fits

    @property
    def num_leaves(self) -> int:
        return len(self.fits)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        check(
            bool(np.all((x >= self.edges[0]) & (x <= self.edges[-1]))),
            "evaluation point outside the tree's interval",
            InvalidArgumentsError,
        )
        leaf = np.clip(
            np.searchsorted(self.edges, x, side="right") - 1, 0, self.num_leaves - 1
        )
        out = np.empty_like(x)
        for k in np.unique(leaf):
            sel = leaf == k
            out[sel] = self.fits[k](x[sel])
        return out
