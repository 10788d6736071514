"""Device apply of a hierarchical-LU factorization.

Port counterpart of `butterfly_tpu/fac/device_solve.py`. The reference's
fast-direct-solver SOLVE walks the recursive node tree on the host, one
BLAS call per block (fast_direct_solver.py:752-762). The factorization
(fac/solver.py) stays host float64, since factorization is setup time, but
the AMORTIZED path (many right-hand sides through one factorization) runs
the substitution's products on the card:

- leaf `_DenseLU` nodes become explicit inverses (computed once from the
  stored LU, host float64, shipped as float32) applied as IEEE-float32
  `torch.matmul`; an explicit inverse of a well-conditioned block of at
  most base_size rows is benign;
- each node's compressed off-diagonal operators A21/A12 (middle-out
  butterfly Products or Dense, fac/middle_out.py) are packed once into
  `StagePlan`s (ops/packed.py) on the card;
- the recursion is walked in Python at solve time: the node tree is
  static. (The JAX package unrolls it into one jitted program.)

These are plain products: the JAX package too computes them outside any
Pallas kernel. Float32 caps a single pass near 1e-6; `solve_refined` wraps
the device solve in mixed-precision iterative refinement (host-f64
residual, device-f32 correction), reaching f64-level residuals in 2-3
passes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.linalg as sla
import torch

from butterfly_tpu_torch.fac.solver import FastDirectSolver, _DenseLU
from butterfly_tpu_torch.ops.butterfly import _f32_precision
from butterfly_tpu_torch.ops.packed import StagePlan, pack
from butterfly_tpu_torch.utils.device import resolve_device
from butterfly_tpu_torch.utils.errors import InvalidArgumentsError, check

__all__ = ["DeviceSolver"]


@dataclasses.dataclass
class _Leaf:
    inv: torch.Tensor  # (n, n) float32 inverse of the leaf block


@dataclasses.dataclass
class _Node:
    m: int
    a21: StagePlan
    a12: StagePlan
    lu1: "_Leaf | _Node"
    lu2: "_Leaf | _Node"


def _tensor_bytes(obj) -> int:
    """Bytes of every tensor in a nest of tuples and lists."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (tuple, list)):
        return sum(_tensor_bytes(o) for o in obj)
    return 0


class DeviceSolver:
    """The substitution of a real `FastDirectSolver` on `device` (default:
    the card), in float32."""

    def __init__(self, fds: FastDirectSolver, block_align: int = 32,
                 device=None):
        device = resolve_device(device)
        self.device = device
        self.shape = fds.shape

        def build(node):
            if isinstance(node, _DenseLU):
                n = node._lu[0].shape[0]
                inv = sla.lu_solve(node._lu, np.eye(n))
                check(not np.iscomplexobj(inv),
                      "DeviceSolver is real-only for now (embed complex "
                      "systems first)", InvalidArgumentsError)
                return _Leaf(torch.as_tensor(inv, dtype=torch.float32,
                                             device=device))
            # solver nodes may hold _SampledOp wrappers (thin build-time
            # cache around the stored LinOp): pack the stored operator
            op21 = getattr(node.A21, "op", node.A21)
            op12 = getattr(node.A12, "op", node.A12)
            return _Node(
                node.m,
                pack(op21, dtype=np.float32, block_align=block_align,
                     device=device),
                pack(op12, dtype=np.float32, block_align=block_align,
                     device=device),
                build(node.lu1), build(node.lu2))

        self._root = build(fds._root)

    def _solve(self, node, b: torch.Tensor) -> torch.Tensor:
        if isinstance(node, _Leaf):
            return node.inv @ b
        m = node.m
        x1t = self._solve(node.lu1, b[:m])
        x2 = self._solve(node.lu2, b[m:] - node.a21(x1t))
        x1 = x1t - self._solve(node.lu1, node.a12(x2))
        return torch.cat([x1, x2])

    def solve(self, b) -> torch.Tensor:
        """One float32 device substitution pass: (n,) or (n, r), a tensor
        or numpy; returns a float32 tensor on the solver's device."""
        b = torch.as_tensor(b).to(self.device, torch.float32)
        was_vec = b.ndim == 1
        with _f32_precision("highest"):
            x = self._solve(self._root, b[:, None] if was_vec else b)
        return x[:, 0] if was_vec else x

    def solve_refined(self, b, matmat, iters: int = 2) -> np.ndarray:
        """Mixed-precision refinement: device-f32 solves, host-f64
        residuals through `matmat` (the ORIGINAL operator's apply).
        Returns a host f64 solution with f64-grade residual."""
        b = np.asarray(b, np.float64)

        def dev_solve(r):
            return self.solve(r.astype(np.float32)).double().cpu().numpy()

        x = dev_solve(b)
        for _ in range(iters):
            x = x + dev_solve(b - matmat(x))
        return x

    def nbytes(self) -> int:
        """Bytes the solver holds on its device: leaf inverses, and each
        stage plan's weights and index tables."""
        def rec(node):
            if isinstance(node, _Leaf):
                return _tensor_bytes(node.inv)
            return (_tensor_bytes(node.a21._params)
                    + _tensor_bytes(node.a12._params)
                    + rec(node.lu1) + rec(node.lu2))

        return rec(self._root)
