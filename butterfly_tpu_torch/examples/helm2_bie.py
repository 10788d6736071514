"""2-D Helmholtz BIE on an ellipse, solved on the host and on the card.

Twin of the JAX package's `examples/helm2_bie.py` (the reference's
flagship example, examples/simple/helm2_bie.c), with the same arguments.
It keeps the JAX script's host path: the second-kind S' integral equation
0.5 sigma + (S' + C) W sigma = f on an ellipse, C the Kapur-Rokhlin
correction, W the quadrature weights; the dense system with
`kr_correction(...).materialize()`; the butterfly system
`Sum([Product([Sum([A_bf, corr]), Diag(w[perm])]), Scaled(0.5, I)])`
from `make_multilevel` in tree order; its MVP rel error, the dense LU
solve, host `solve_gmres` and the field errors against the exact
interior-source solution. It prints the JAX script's lines for them.

Then it solves on the card through the library's card system
(`models/bie.py`: `card_system`, `CardBie`): the S' operator compiled into
the two-pass cell program (`partition_apply_plan`, kernel K2), the
tree-permuted accumulate corrector on the card (`KrAccumCorrector`, torch
ops), and GMRES in a complex64 basis on the card (tol 3e-7, max_iter 400,
no restarts) on sys(v) = 0.5 v + plan(v w) + corr(v w), as the JAX
script's host GMRES runs a complex one.
It prints the same lines for that solve and one JSON row: `n, k, mvp_rel`
(the card system against the dense float64 system, in tree order),
`gmres_tol, gmres_iters, gmres_s, ms_per_iter, k2_launches` (over the
solve), `f32_residual_floor` (the card system's residual at the dense-LU
density) with its two sources `floor_from_plan` and `floor_from_corrector`,
`density_rel_vs_dense_lu, field_rel_err, plan_s, windows, weights_mb,
apply_ms_r1` (K2's two passes at one column) and the host figures beside
them.

Usage:
  python -m butterfly_tpu_torch.examples.helm2_bie [--n 2048] [--k 40]
      [--kr-order 6] [--tol 1e-10] [--device cpu]

The card path runs on the card unless `--device cpu` is passed; times on
the CPU are None (not measured). `run` = `solve(setup(...))`;
`chip_smoke.py` calls the two halves itself to check K2 on the plan in
between.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from butterfly_tpu_torch.fac import helm2 as fac_helm2
from butterfly_tpu_torch.geom import Ellipse
from butterfly_tpu_torch.models.bie import (
    CardBie,
    card_system,
    card_timings,
    gmres_row,
    rel,
)
from butterfly_tpu_torch.ops.helm2 import Helm2, LayerPot
from butterfly_tpu_torch.ops.linalg import solve_gmres
from butterfly_tpu_torch.ops.linop import Diag, Identity, Product, Scaled, Sum
from butterfly_tpu_torch.ops.quadrature import kr_correction
from butterfly_tpu_torch.trees import Quadtree
from butterfly_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class Helm2Bie:
    """The host half of one run: its row so far, the problem, the dense
    system and its LU density, the host butterfly system (tree order) and
    the card system."""

    rec: dict
    X: np.ndarray
    w: np.ndarray
    targets: np.ndarray
    u_exact: np.ndarray
    helm_s: Helm2
    rhs: np.ndarray
    A_dense: np.ndarray
    sigma_dense: np.ndarray
    sys_bf: object
    card: CardBie

    def field_rel_err(self, sigma: np.ndarray) -> float:
        u = self.helm_s.kernel_matrix(self.X, self.targets) @ (self.w * sigma)
        return rel(u, self.u_exact)


def setup(n: int = 2048, k: float = 40.0, kr_order: int = 6,
          tol: float = 1e-10, device=None) -> Helm2Bie:
    """The JAX script's host path, then the card system on `device`."""
    device = resolve_device(device)
    X, T, N, w = Ellipse(1.0, 0.6, (0.0, 0.0), 0.1).sample_linspaced(n)
    helm_sp = Helm2(k=k, layer_pot=LayerPot.PV_NORMAL_DERIV_SINGLE)
    helm_s = Helm2(k=k, layer_pot=LayerPot.SINGLE)
    x_src = np.array([[0.1, -0.05]])
    theta = np.linspace(0, 2 * np.pi, 25)[:-1]
    targets = np.stack([3 * np.cos(theta), 2.5 * np.sin(theta)], 1)
    rhs = helm_sp.kernel_matrix(x_src, X, None, N)[:, 0]
    rec = {"n": n, "k": k}

    def kernel_ij(i, j):
        return helm_sp.kernel_matrix(X[j:j + 1], X[i:i + 1], None,
                                     N[i:i + 1])[0, 0]

    t0 = time.time()
    tree = Quadtree(X, leaf_size=32, normals=N)
    print(f"built quadtree [{time.time()-t0:.2f}s]")

    t0 = time.time()
    A_dense = helm_sp.kernel_matrix(X, X, None, N)
    A_dense += kr_correction(kr_order, n, kernel_ij).materialize()
    A_dense = A_dense * w[None, :] + 0.5 * np.eye(n)
    print(f"assembled dense system matrix [{time.time()-t0:.2f}s]")

    t0 = time.time()
    perm = tree.perm
    A_bf = fac_helm2.make_multilevel(helm_sp, tree, tree)
    corr = kr_correction(kr_order, n, kernel_ij, perm=perm)
    sys_bf = Sum([
        Product([Sum([A_bf, corr]), Diag(w[perm])]),
        Scaled(0.5, Identity(n, dtype=np.complex128)),
    ])
    rec["host_fac_s"] = time.time() - t0
    print(f"assembled butterfly system [{rec['host_fac_s']:.2f}s] "
          f"({sys_bf.nbytes()/1e6:.1f} MB vs {A_dense.nbytes/1e6:.1f} MB "
          "dense)")

    x = np.random.default_rng(0).standard_normal(n) + 0j
    rec["host_mvp_rel"] = rel(sys_bf.matvec(x[perm]), (A_dense @ x)[perm])
    print(f"MVP rel l2 error: {rec['host_mvp_rel']:.3e}")

    t0 = time.time()
    sigma_dense = np.linalg.solve(A_dense, rhs)
    print(f"dense LU solve [{time.time()-t0:.2f}s]")

    t0 = time.time()
    res = solve_gmres(sys_bf, rhs[perm], tol=tol, max_iter=400)
    sigma_bf = np.empty_like(res.x)
    sigma_bf[perm] = res.x
    rec["host_gmres_s"] = time.time() - t0
    rec["host_gmres_iters"] = int(res.num_iter)
    rec["host_gmres_converged"] = bool(res.converged)
    print(f"BF GMRES solve: {res.num_iter} iterations "
          f"[{rec['host_gmres_s']:.2f}s] converged={res.converged}")

    u_exact = helm_s.kernel_matrix(x_src, targets)[:, 0]
    prob = Helm2Bie(rec, X, w, targets, u_exact, helm_s, rhs, A_dense,
                    sigma_dense, sys_bf, None)
    for name, sigma in [("dense", sigma_dense), ("butterfly", sigma_bf)]:
        err = prob.field_rel_err(sigma)
        rec[f"host_{name}_field_rel_err"] = err
        print(f"{name} field rel l2 error vs exact: {err:.3e}")

    prob.card = card_system(A_bf, perm, w, kernel_ij, kr_order,
                            device=device)
    rec.update(prob.card.rec)
    print(f"card system: partition plan [{rec['plan_s']:.2f}s] "
          f"({rec['weights_mb']:.1f} MB, windows {rec['windows']}), "
          f"accumulate corrector [{rec['corr_s']:.2f}s]")
    return prob


def solve(prob: Helm2Bie) -> dict:
    """The card half: the system's MVP against the dense system, its
    timings, the float32 residual floor at the dense-LU density
    (`CardBie.residual_floor`), the GMRES solve on the card and its
    errors; returns the row."""
    card, rec, n = prob.card, prob.rec, prob.A_dense.shape[0]
    x = np.random.default_rng(0).standard_normal(n) + 0j
    got = card.from_card(card.sys_apply(card.to_card(x)))
    want = prob.A_dense @ x
    rec["mvp_rel"] = rel(got[card.perm], want[card.perm])
    print(f"card MVP rel l2 error: {rec['mvp_rel']:.3e}")
    card_timings(card, rec)
    rec.update(card.residual_floor(prob.sigma_dense, prob.rhs))

    # tol: helm2_scale's (a float32 basis floors near 1e-7); the JAX
    # script's max_iter, run without restarts as its host GMRES runs
    # (GMRES(80) on the interleaved real embedding stalled from k=100 on in
    # the scattering k-sweep)
    tol = 3e-7
    sigma, res, secs, launches = card.solve(prob.rhs, tol, restart=400,
                                            max_iter=400)
    gmres_row(rec, res, secs, launches, tol)
    print(f"card GMRES solve: {res.num_iter} iterations [{secs:.2f}s] "
          f"converged={res.converged}")
    rec["density_rel_vs_dense_lu"] = rel(sigma, prob.sigma_dense)
    rec["field_rel_err"] = prob.field_rel_err(sigma)
    print(f"card field rel l2 error vs exact: {rec['field_rel_err']:.3e} "
          f"(density vs dense LU {rec['density_rel_vs_dense_lu']:.3e})")
    dev = card.device
    rec["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else str(dev))
    return rec


def run(n: int = 2048, k: float = 40.0, kr_order: int = 6,
        tol: float = 1e-10, device=None) -> dict:
    return solve(setup(n, k, kr_order, tol, device=device))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--k", type=float, default=40.0)
    ap.add_argument("--kr-order", type=int, default=6)
    ap.add_argument("--tol", type=float, default=1e-10)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain passes")
    args = ap.parse_args(argv)
    rec = run(args.n, args.k, args.kr_order, args.tol, device=args.device)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
