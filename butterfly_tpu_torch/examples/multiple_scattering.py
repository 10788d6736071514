"""Multiple scattering: the Helmholtz S' BIE on several ellipse
scatterers, solved on the host and on the card.

Twin of the JAX package's `examples/multiple_scattering.py` (the
reference's examples/multiple_scattering), with the same arguments: scatterer
ellipses at Poisson-disk centers drawn from `default_rng(--seed)` in the JAX
order, a combined boundary discretization, the butterfly-compressed S'
system with per-boundary Kapur-Rokhlin corrections (order 6, periodic
wraparound per boundary), host GMRES and the field error at four exterior
targets against the exact solution of one interior source per scatterer.

Then the same system is solved on the card as in `helm2_bie`, through
the library's card system (`models/bie.py`): the S' operator through
`partition_apply_plan` (kernel K2), the block accumulate corrector on the
card, GMRES in a complex64 basis (tol 3e-7, max_iter 400, no restarts, as
the host GMRES runs).
The card system's MVP is checked against the dense float64 system (kernel
matrix plus the materialized correction) in tree order, and its density
against that system's LU solve. It prints the JAX script's lines, its
`sweep row:` line with the card's solve time as t_solve, and one JSON
row.

`--sweep` runs the reference's k-grid instead, k in logspace(0, 3, 13)
with the same scatterers: 512 points a boundary up to k ~ 178, then
64 * ceil(2.4 k / 64), which keeps at least 20 points a wavelength on the
0.12 semi-axis (2432 a boundary at k = 1000); one JSON row per k.

Usage:
  python -m butterfly_tpu_torch.examples.multiple_scattering [--k 25]
      [--num 3] [--per-boundary 512] [--tol 1e-10] [--seed 5]
      [--device cpu] [--sweep]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time

import numpy as np
import torch

from butterfly_tpu_torch.fac import helm2 as fac_helm2
from butterfly_tpu_torch.geom import Ellipse, sample_poisson_disk
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
from butterfly_tpu_torch.ops.quadrature import kr_block_correction
from butterfly_tpu_torch.trees import Quadtree
from butterfly_tpu_torch.utils.device import resolve_device

TARGETS = np.array([[3.0, 3.0], [-2.5, 3.2], [3.1, -2.6], [-2.8, -2.9]])
KR_ORDER = 6


def sweep_per_boundary(k: float) -> int:
    """Points a boundary for the k-sweep: 512, or 64 * ceil(2.4 k / 64)
    where that is more (at least 20 points a wavelength)."""
    return max(512, 64 * math.ceil(2.4 * k / 64))


def geometry(num: int, per_boundary: int, seed: int):
    """Scatterer centers and the stacked boundary: (centers, X, N, W,
    offsets), drawn from default_rng(seed) in the JAX script's order."""
    rng = np.random.default_rng(seed)
    centers = sample_poisson_disk((0, 0), (1, 1), 0.45, rng=rng)[:num]
    X, N, W, offsets = [], [], [], [0]
    for c in centers:
        a, b = 0.12, 0.08 + 0.02 * rng.random()
        e = Ellipse(a, b, tuple(c), rng.random() * np.pi)
        Xe, _, Ne, we = e.sample_linspaced(per_boundary)
        X.append(Xe)
        N.append(Ne)
        W.append(we)
        offsets.append(offsets[-1] + per_boundary)
    return (centers, np.concatenate(X), np.concatenate(N), np.concatenate(W),
            offsets)


@dataclasses.dataclass
class HostSystem:
    """The JAX script's host problem at one wavenumber."""

    centers: np.ndarray
    X: np.ndarray
    N: np.ndarray
    W: np.ndarray
    offsets: list
    helm_sp: Helm2
    helm_s: Helm2
    rhs: np.ndarray
    perm: np.ndarray
    A_bf: object
    sys_op: object
    t_fac: float

    def kernel_ij(self, i, j):
        return self.helm_sp.kernel_matrix(self.X[j:j + 1], self.X[i:i + 1],
                                          None, self.N[i:i + 1])[0, 0]

    def field_err(self, sigma: np.ndarray) -> float:
        """Field rel error at the four targets for a density in original
        order."""
        u = self.helm_s.kernel_matrix(self.X, TARGETS) @ (self.W * sigma)
        u_exact = self.helm_s.kernel_matrix(self.centers, TARGETS).sum(axis=1)
        return rel(u, u_exact)


def host_system(k: float, num: int, per_boundary: int,
                seed: int) -> HostSystem:
    """Geometry, right-hand side and the butterfly system in tree order,
    as the JAX script builds them (its printed lines included)."""
    t0 = time.time()
    centers, X, N, W, offsets = geometry(num, per_boundary, seed)
    n = len(X)
    print(f"{len(centers)} scatterers, n = {n} boundary points, "
          f"k = {k} [{time.time()-t0:.2f}s]")

    helm_sp = Helm2(k=k, layer_pot=LayerPot.PV_NORMAL_DERIV_SINGLE)
    helm_s = Helm2(k=k, layer_pot=LayerPot.SINGLE)
    # exact solution: interior point sources, one per scatterer
    rhs = helm_sp.kernel_matrix(centers, X, None, N).sum(axis=1)

    t0 = time.time()
    tree = Quadtree(X, leaf_size=32, normals=N)
    perm = tree.perm
    A_bf = fac_helm2.make_multilevel(helm_sp, tree, tree)
    t_fac = time.time() - t0
    print(f"butterfly system built [{t_fac:.2f}s]")

    hs = HostSystem(centers, X, N, W, offsets, helm_sp, helm_s, rhs, perm,
                    A_bf, None, t_fac)
    corr = kr_block_correction(KR_ORDER, n, offsets, hs.kernel_ij, perm=perm)
    hs.sys_op = Sum([
        Product([Sum([A_bf, corr]), Diag(W[perm])]),
        Scaled(0.5, Identity(n, dtype=np.complex128)),
    ])
    return hs


@dataclasses.dataclass
class Scattering:
    """One wavenumber after setup: the host system, the card system and
    the row so far."""

    hs: HostSystem
    card: CardBie
    rec: dict


def setup(k: float = 25.0, num: int = 3, per_boundary: int = 512,
          tol: float = 1e-10, seed: int = 5, device=None) -> Scattering:
    """The JAX script's host build and solve, then the card system on
    `device` (default: the card)."""
    device = resolve_device(device)
    hs = host_system(k, num, per_boundary, seed)
    perm = hs.perm

    t0 = time.time()
    res = solve_gmres(hs.sys_op, hs.rhs[perm], tol=tol, max_iter=400)
    t_host = time.time() - t0
    print(f"GMRES: {res.num_iter} iterations, converged={res.converged} "
          f"[{t_host:.2f}s]")

    sigma = np.empty_like(res.x)
    sigma[perm] = res.x
    err_host = hs.field_err(sigma)
    print(f"field rel l2 error at {len(TARGETS)} targets: {err_host:.3e}")

    card = card_system(hs.A_bf, perm, hs.W, hs.kernel_ij, KR_ORDER,
                       offsets=hs.offsets, device=device)
    rec = {"k": k, "n": len(hs.X), "num": len(hs.centers),
           "per_boundary": per_boundary, "t_fac": hs.t_fac,
           "host_gmres_iters": int(res.num_iter),
           "host_gmres_converged": bool(res.converged),
           "host_t_solve": t_host, "host_field_rel_err": err_host}
    rec.update(card.rec)
    print(f"card system: partition plan [{rec['plan_s']:.2f}s] "
          f"({rec['weights_mb']:.1f} MB, windows {rec['windows']}), "
          f"accumulate corrector [{rec['corr_s']:.2f}s]")
    return Scattering(hs, card, rec)


def solve(sc: Scattering) -> dict:
    """The card half: the system's MVP against the dense float64 system
    (kernel matrix plus the materialized correction, tree order), its
    timings, the float32 residual floor at the dense-LU density
    (`CardBie.residual_floor`), GMRES on the card, the density against the
    dense LU and the field error. Returns the row."""
    hs, card, rec = sc.hs, sc.card, sc.rec
    n, perm = len(hs.X), hs.perm
    S = hs.helm_sp.kernel_matrix(hs.X, hs.X, None, hs.N)
    S += kr_block_correction(KR_ORDER, n, hs.offsets,
                             hs.kernel_ij).materialize()
    S *= hs.W[None, :]
    S[np.diag_indices(n)] += 0.5
    x = np.random.default_rng(0).standard_normal(n) + 0j
    want = S @ x
    t0 = time.time()
    sigma_dense = np.linalg.solve(S, hs.rhs)
    rec["dense_lu_s"] = time.time() - t0
    del S
    got = card.from_card(card.sys_apply(card.to_card(x)))
    rec["mvp_rel"] = rel(got[perm], want[perm])
    print(f"card MVP rel l2 error: {rec['mvp_rel']:.3e}")
    card_timings(card, rec)
    rec.update(card.residual_floor(sigma_dense, hs.rhs))

    # helm2_bie's settings: tol 3e-7, max_iter 400, no restarts
    tol = 3e-7
    sigma, res, t_solve, launches = card.solve(hs.rhs, tol, restart=400,
                                               max_iter=400)
    gmres_row(rec, res, t_solve, launches, tol)
    rec["density_rel_vs_dense_lu"] = rel(sigma, sigma_dense)
    print(f"card GMRES: {res.num_iter} iterations, "
          f"converged={res.converged} [{t_solve:.2f}s]")
    rec["field_rel_err"] = hs.field_err(sigma)
    print(f"card field rel l2 error at {len(TARGETS)} targets: "
          f"{rec['field_rel_err']:.3e}")
    k, pb = rec["k"], rec["per_boundary"]
    rec["ppw"] = 2 * np.pi / k / (2 * np.pi * 0.12 / pb)
    print(f"sweep row: k={k:g} n={n} ppw~{rec['ppw']:.0f} "
          f"t_fac={hs.t_fac:.2f}s t_solve={t_solve:.2f}s "
          f"err={rec['field_rel_err']:.3e}")
    dev = card.device
    rec["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else str(dev))
    return rec


def run(k: float = 25.0, num: int = 3, per_boundary: int = 512,
        tol: float = 1e-10, seed: int = 5, device=None) -> dict:
    """One wavenumber end to end; returns the JSON row."""
    return solve(setup(k, num, per_boundary, tol, seed, device=device))


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=float, default=25.0)
    ap.add_argument("--num", type=int, default=3, help="number of scatterers")
    ap.add_argument("--per-boundary", type=int, default=512)
    ap.add_argument("--tol", type=float, default=1e-10)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain passes")
    ap.add_argument("--sweep", action="store_true",
                    help="the reference's grid k = logspace(0, 3, 13)")
    args = ap.parse_args(argv)
    grid = ([(float(k), sweep_per_boundary(k)) for k in np.logspace(0, 3, 13)]
            if args.sweep else [(args.k, args.per_boundary)])
    rows = []
    for k, pb in grid:
        rows.append(run(k, args.num, pb, args.tol, args.seed,
                        device=args.device))
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
