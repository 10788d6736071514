"""Hierarchical-LU fast direct solver, with its substitution on the card.

Twin of the JAX package's `examples/fast_direct_solver.py` (reference
prototype: examples/fast_direct_solver/fast_direct_solver.py): factorize a
tree-ordered system once on the host (float64), then amortize many solves.
Two modes:

- default: the quadtree-ordered Helmholtz BIE system (dense input, moderate
  n), solved on the host: accuracy against the system.
- --operator: OPERATOR-FIRST at large n, where the matrix never exists
  densely. A = alpha*I + Toeplitz(Gaussian kernel) is reachable only
  through an FFT matvec and analytic small blocks; the solver compresses
  off-diagonals and reflectors by randomized multilevel butterfly sampling
  and keeps Schur complements lazy. Gates: host residual <= 1e-8, and the
  peak RSS growth under the dense-A footprint (the o(N^2)-memory
  demonstration; it holds only at large n). With --device, the
  factorization is packed onto the card (`DeviceSolver`), a batch of 64
  right-hand sides is timed with CUDA events, and the refined solution is
  held to a residual of 1e-8.

Usage:
  python -m butterfly_tpu_torch.examples.fast_direct_solver [--n 2048] [--k 25]
  python -m butterfly_tpu_torch.examples.fast_direct_solver --operator --device --n 16384
"""

from __future__ import annotations

import argparse
import resource
import time

import numpy as np
import torch

from butterfly_tpu_torch.fac.device_solve import DeviceSolver
from butterfly_tpu_torch.fac.solver import FastDirectSolver
from butterfly_tpu_torch.geom import Ellipse
from butterfly_tpu_torch.ops.helm2 import Helm2, LayerPot
from butterfly_tpu_torch.trees import Quadtree
from butterfly_tpu_torch.utils.device import resolve_device
from butterfly_tpu_torch.utils.errors import check
from butterfly_tpu_torch.utils.timer import device_time

# right-hand sides in the timed device batch
BATCH = 64


def run_bie(n: int = 2048, k: float = 25.0, base: int = 256) -> dict:
    """Factorize the Helmholtz BIE system and solve it on the host."""
    X, T, N, w = Ellipse(1.0, 0.6, (0.0, 0.0), 0.2).sample_linspaced(n)
    helm = Helm2(k=k, layer_pot=LayerPot.PV_NORMAL_DERIV_SINGLE)
    tree = Quadtree(X, leaf_size=32, normals=N)
    P = tree.perm
    A = (helm.kernel_matrix(X, X, None, N) * w[None, :] + 0.5 * np.eye(n))
    A = A[np.ix_(P, P)]

    t0 = time.perf_counter()
    fds = FastDirectSolver(A, base_size=base, tol=1e-12, rank=64)
    out = {"fac_s": time.perf_counter() - t0, "storage_mb": fds.nbytes() / 1e6,
           "dense_mb": A.nbytes / 1e6}
    print(f"factorized in {out['fac_s']:.1f}s; storage "
          f"{out['storage_mb']:.1f} MB vs dense {out['dense_mb']:.1f} MB")

    rng = np.random.default_rng(0)
    b = rng.standard_normal(n) + 0j
    t0 = time.perf_counter()
    x = fds.solve(b)
    out["first_solve_ms"] = 1e3 * (time.perf_counter() - t0)
    out["residual"] = float(np.linalg.norm(A @ x - b) / np.linalg.norm(b))
    print(f"first solve {out['first_solve_ms']:.1f} ms, residual "
          f"{out['residual']:.2e}")
    t0 = time.perf_counter()
    for _ in range(20):
        fds.solve(b)
    out["amortized_solve_ms"] = 1e3 * (time.perf_counter() - t0) / 20
    print(f"amortized solve: {out['amortized_solve_ms']:.1f} ms")
    return out


class ToeplitzKernelAccess:
    """A = alpha*I + K, K[i,j] = g(i - j + delta): rectangular Toeplitz with
    FFT matvec and analytic blocks — block access without ever forming A.
    `sub` returns a DIRECT sub-Toeplitz (shifted diagonal), so deep
    recursion levels apply at their own size rather than zero-embedding up
    to the top operator."""

    def __init__(self, m: int, n: int | None = None, alpha: float = 1.0,
                 sigma: float | None = None, delta: int = 0, _g=None):
        n = m if n is None else n
        self.m, self.n = m, n
        self.alpha = alpha
        self.delta = delta
        self.shape = (m, n)
        if _g is not None:
            self._g, self._sigma = _g, sigma
        else:
            if sigma is None:
                sigma = m / 16  # globally smooth: block ranks stay moderate
            self._sigma = sigma
            self._g = lambda d: np.exp(-(d / sigma) ** 2)
        # first column g(i + delta), i in [0, m); first row g(delta - j)
        L = m + n
        c = np.zeros(L)
        c[:m] = self._g(np.arange(m) + delta)
        c[m + 1 :] = self._g(delta - np.arange(n - 1, 0, -1))
        self._fc = np.fft.rfft(c)

    def matmat(self, X):
        X = np.asarray(X, dtype=np.float64)
        was1 = X.ndim == 1
        if was1:
            X = X[:, None]
        L = self.m + self.n
        Xp = np.zeros((L, X.shape[1]))
        Xp[: self.n] = X
        Y = np.fft.irfft(np.fft.rfft(Xp, axis=0) * self._fc[:, None], axis=0,
                         n=L)
        out = Y[: self.m]
        if self.alpha and self.delta == 0 and self.m == self.n:
            out = out + self.alpha * X
        elif self.alpha:
            # diagonal hits where i == j - delta within range
            jd = np.arange(self.n) + self.delta
            ok = (jd >= 0) & (jd < self.m)
            out[jd[ok]] += self.alpha * X[np.arange(self.n)[ok]]
        return out[:, 0] if was1 else out

    def rmatmat(self, X):
        # K^T is Toeplitz with g'(d) = g(-d): reuse via a flipped access
        if not hasattr(self, "_adj"):
            g = self._g
            self._adj = ToeplitzKernelAccess(
                self.n, self.m, alpha=self.alpha, sigma=self._sigma,
                delta=-self.delta, _g=lambda d: g(-d),
            )
        return self._adj.matmat(X)

    def block(self, i0, i1, j0, j1):
        i = np.arange(i0, i1)[:, None]
        j = np.arange(j0, j1)[None, :]
        B = self._g((i - j) + self.delta)
        if self.alpha:
            mask = (i - j) + self.delta == 0
            B = B + self.alpha * mask
        return B

    def sub(self, i0, i1, j0, j1):
        return ToeplitzKernelAccess(
            i1 - i0, j1 - j0, alpha=self.alpha, sigma=self._sigma,
            delta=self.delta + (i0 - j0), _g=self._g,
        )

    @property
    def dtype(self):
        return np.float64


def factor_operator(n: int, base: int = 256):
    """The operator-first factorization of the Toeplitz system on the
    host: (access, solver, seconds)."""
    acc = ToeplitzKernelAccess(n)
    t0 = time.perf_counter()
    fds = FastDirectSolver(acc, base_size=max(base, 512), tol=1e-9, rank=48)
    return acc, fds, time.perf_counter() - t0


def run_device(acc, fds: FastDirectSolver, rng: np.random.Generator,
               device=None) -> dict:
    """The amortized device path: pack the node operators once on `device`
    (default: the card), solve a batch of 64 right-hand sides (timed with
    CUDA events on the card), and refine one solution to an f64-grade
    residual (gate 1e-8). Returns the numbers, with the batch's relative
    difference from the host solve."""
    device = resolve_device(device)
    n = fds.shape[0]
    t0 = time.perf_counter()
    ds = DeviceSolver(fds, device=device)
    out = {"pack_s": time.perf_counter() - t0, "device_mb": ds.nbytes() / 1e6}
    print(f"device pack: {out['pack_s']:.1f}s, {out['device_mb']:.1f} MB")
    Bm = rng.standard_normal((n, BATCH)).astype(np.float32)
    Bt = torch.from_numpy(Bm).to(device)
    xb = ds.solve(Bt).double().cpu().numpy()
    xh = fds.solve(Bm.astype(np.float64))
    out["rel_vs_host"] = float(np.linalg.norm(xb - xh) / np.linalg.norm(xh))
    out["ms_per_rhs"] = (1e3 * device_time(lambda: ds.solve(Bt), warmup=1,
                                           iters=10) / BATCH
                         if device.type == "cuda" else None)
    b = rng.standard_normal(n)
    xr = ds.solve_refined(b, matmat=acc.matmat, iters=2)
    out["refined_residual"] = float(np.linalg.norm(acc.matmat(xr) - b)
                                    / np.linalg.norm(b))
    print(f"device amortized solve {out['ms_per_rhs']} ms/rhs (batch "
          f"{BATCH}), vs host {out['rel_vs_host']:.2e}, refined residual "
          f"{out['refined_residual']:.2e}")
    check(out["refined_residual"] < 1e-8, "device refined residual gate")
    return out


def run_operator(n: int, base: int = 256, on_card: bool = False) -> dict:
    """Operator-first mode: factorize, gate the host residual and the peak
    RSS growth, then (on_card=True) the device path on the card."""
    dense_mb = n * n * 8 / 1e6
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024  # MB
    acc, fds, t_fac = factor_operator(n, base)
    rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    print(f"operator-first factorization n={n}: {t_fac:.1f}s, storage "
          f"{fds.nbytes()/1e6:.1f} MB, max dense block "
          f"{fds.max_dense_block_entries*8/1e6:.1f} MB")
    print(f"peak RSS {rss1:.0f} MB (baseline {rss0:.0f} MB) vs dense A "
          f"{dense_mb:.0f} MB")

    rng = np.random.default_rng(0)
    b = rng.standard_normal(n)
    t0 = time.perf_counter()
    x = fds.solve(b)
    t_solve = time.perf_counter() - t0
    res = np.linalg.norm(acc.matmat(x) - b) / np.linalg.norm(b)
    print(f"solve {1e3*t_solve:.1f} ms, residual {res:.2e}")
    check(res < 1e-8, "residual gate")
    check(rss1 - rss0 < dense_mb, "memory gate: must stay under dense-A")
    out = {"fac_s": t_fac, "residual": float(res)}
    if on_card:
        out.update(run_device(acc, fds, rng))
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--k", type=float, default=25.0)
    ap.add_argument("--base", type=int, default=256)
    ap.add_argument("--operator", action="store_true")
    ap.add_argument("--device", action="store_true",
                    help="also run the DeviceSolver amortized path (card)")
    args = ap.parse_args()
    if args.operator:
        run_operator(args.n, args.base, args.device)
    else:
        run_bie(args.n, args.k, args.base)


if __name__ == "__main__":
    main()
