"""Dense boundary-integral operators and systems in float64, built in
blocks of rows, and the comparisons that decide `correct`.

`Problem` holds one configuration's discretization: the boundary, the
wavenumber and the layer potential. Its rows are assembled from the
kernel on demand, so that a large system (n = 16384: 4.3 GB in complex128) is
never held whole:

- `kernel_rows(r0, r1)`: the kernel matrix K, zero on its diagonal (the
  trapezoid rule drops the singular point);
- `system_rows(r0, r1)`: the second-kind system 0.5 I + (K + C) W, C the
  Kapur-Rokhlin correction where the configuration has a `kr_order`, W the
  quadrature weights.

Kernels (x the target, y the source, r = |x - y|, n the unit normals):
S(x, y) = (i/4) H0(kr); D(x, y) = (i/4) k H1(kr) n_y.(x - y) / r;
S'(x, y) = (i/4) k H1(kr) n_x.(x - y) / r; the combined field
alpha S + beta D.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import geometry
from portbench.reference.hankel import hankel1
from portbench.reference.kr import KR_WEIGHTS

# complex128 entries of one block of rows (256 MB)
BLOCK_ENTRIES = 1 << 24


def kernel(layer: dict, k: float, x, y, nx=None, ny=None) -> torch.Tensor:
    """(len(x), len(y)) complex128 kernel matrix; zero where x == y.
    `layer`: {"pot": "single" | "double" | "sprime" | "combined", and for
    "combined" "alpha_per_k" and "beta" as [re, im]}."""
    d = x[:, None, :] - y[None, :, :]
    r = torch.sqrt((d * d).sum(-1))
    zero = r == 0
    safe = torch.where(zero, torch.ones_like(r), r)
    pot = layer["pot"]
    out = None
    if pot in ("single", "combined"):
        s = 0.25j * hankel1(0, k * safe)
        out = s if pot == "single" else complex(*layer["alpha_per_k"]) * k * s
    if pot in ("double", "combined"):
        dn = (d * ny[None, :, :]).sum(-1) / safe
        dl = 0.25j * k * hankel1(1, k * safe) * dn
        out = dl if out is None else out + complex(*layer["beta"]) * dl
    if pot == "sprime":
        dn = (d * nx[:, None, :]).sum(-1) / safe
        out = 0.25j * k * hankel1(1, k * safe) * dn
    if out is None:
        raise ValueError(f"unknown layer potential {pot!r}")
    return torch.where(zero, torch.zeros_like(out), out)


class Problem:
    """One configuration's discretized boundary-integral problem on
    `device`, all in float64 / complex128."""

    def __init__(self, config: dict, device="cpu"):
        self.config = config
        self.device = torch.device(device)
        self.boundary = geometry.ellipse(config["ellipse"], int(config["n"]))
        self.n = self.boundary.n
        self.k = float(config["k"])
        self.layer = config["layer"]
        self.kr_order = config.get("kr_order")

        def t(a):
            return torch.as_tensor(a, dtype=torch.float64, device=self.device)

        self.x, self.nrm, self.w = (t(self.boundary.points),
                                    t(self.boundary.normals),
                                    t(self.boundary.weights))

    def block_rows(self) -> int:
        return max(1, BLOCK_ENTRIES // self.n)

    def kernel_rows(self, r0: int, r1: int) -> torch.Tensor:
        return kernel(self.layer, self.k, self.x[r0:r1], self.x,
                      self.nrm[r0:r1], self.nrm)

    def system_rows(self, r0: int, r1: int) -> torch.Tensor:
        K = self.kernel_rows(r0, r1)
        m = r1 - r0
        rows = torch.arange(r0, r1, device=self.device)
        if self.kr_order:
            # K[i, j] * gamma_p at j = i +- (p + 1) mod n, from the
            # uncorrected entries (accumulated where two neighbours meet)
            corr = torch.zeros_like(K)
            local = rows - r0
            for p, g in enumerate(KR_WEIGHTS[int(self.kr_order)]):
                for j in ((rows + p + 1) % self.n, (rows - p - 1) % self.n):
                    corr.index_put_((local, j), g * K[local, j],
                                    accumulate=True)
            K = K + corr
        A = K * self.w[None, :]
        A[torch.arange(m, device=self.device), rows] += 0.5
        return A

    def matmul(self, rows_fn, S: torch.Tensor) -> torch.Tensor:
        """rows_fn's whole matrix times S (n, r), block of rows by block."""
        S = torch.as_tensor(S).to(self.device, torch.complex128)
        out = torch.empty((self.n, S.shape[1]), dtype=torch.complex128,
                          device=self.device)
        step = self.block_rows()
        for r0 in range(0, self.n, step):
            r1 = min(self.n, r0 + step)
            out[r0:r1] = rows_fn(r0, r1) @ S
        return out

    def dense(self, rows_fn) -> torch.Tensor:
        """rows_fn's whole matrix (for the small systems and the control)."""
        step = self.block_rows()
        return torch.cat([rows_fn(r0, min(self.n, r0 + step))
                          for r0 in range(0, self.n, step)])


def column_norms(Z: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(Z, dim=0)


def solve_residuals(prob: Problem, B, S) -> np.ndarray:
    """Per column ||b - A s|| / ||b|| in float64: B the right-hand sides
    and S the densities, (n, m) complex in the original point order."""
    B = torch.as_tensor(B).to(prob.device, torch.complex128)
    R = B - prob.matmul(prob.system_rows, S)
    return (column_norms(R) / column_norms(B)).cpu().numpy()


def column_errors(Y, want) -> np.ndarray:
    """Per column ||y - want|| / ||want|| in float64."""
    Y = torch.as_tensor(Y).to(want.device, torch.complex128)
    return (column_norms(Y - want) / column_norms(want)).cpu().numpy()


def apply_errors(prob: Problem, X, Y) -> np.ndarray:
    """Per column ||y - K x|| / ||K x|| in float64: X the operands and Y
    the results, (n, r) complex in the original point order."""
    return column_errors(Y, prob.matmul(prob.kernel_rows,
                                        torch.as_tensor(X)))


# ---- the control: the reference one precision below the program's -------


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 (or complex64) rounded to TF32's 10 mantissa bits, to
    nearest even: what the tensor cores read of a float32 operand."""
    if t.is_complex():
        return torch.view_as_complex(round_tf32(torch.view_as_real(t)))
    bits = t.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def control_solve(prob: Problem, B) -> torch.Tensor:
    """The densities of the dense system solved with its operands in TF32
    (complex64 arithmetic on TF32-rounded entries)."""
    A = round_tf32(prob.dense(prob.system_rows).to(torch.complex64))
    B = round_tf32(torch.as_tensor(B).to(prob.device, torch.complex64))
    return torch.linalg.solve(A, B).to(torch.complex128)


def control_apply(prob: Problem, X) -> torch.Tensor:
    """K X with both operands in TF32, accumulated in float32."""
    K = round_tf32(prob.dense(prob.kernel_rows).to(torch.complex64))
    X = round_tf32(torch.as_tensor(X).to(prob.device, torch.complex64))
    return (K @ X).to(torch.complex128)
