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

Then it solves on the card (`CardBie`): the S' operator compiled into the
two-pass cell program (`partition_apply_plan`, kernel K2), the
tree-permuted accumulate corrector on the card (`KrAccumCorrector`, torch
ops), and `solve_gmres_plan` (tol 3e-7, the scale twin's: a float32
basis floors near 1e-7; max_iter 400 and no restarts, as the JAX script's
host GMRES) on sys(v) = 0.5 v + plan(v w) + corr(v w). The plan applies
the interleaved real embedding (row 2i = Re_i, 2i+1 = Im_i), which is
torch's complex layout: GMRES runs a complex64 basis on the card
(`sys_apply_complex`, a view of the same storage), as the JAX script's
host GMRES runs a complex one. `solve(..., basis="real")` runs the real
basis on the embedding instead (about twice the iterations).
It prints the same lines for that solve and one JSON row: `n, k, mvp_rel`
(the card system against the dense float64 system, in tree order),
`gmres_iters, gmres_s, ms_per_iter, k2_launches` (over the solve),
`f32_residual_floor` (the card system's residual at the dense-LU density)
with its two sources `floor_from_plan` and `floor_from_corrector`,
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
from butterfly_tpu_torch.fac.partition import (
    PartitionPlan,
    partition_apply_plan,
)
from butterfly_tpu_torch.geom import Ellipse
from butterfly_tpu_torch.ops.cellsp import K2
from butterfly_tpu_torch.ops.helm2 import Helm2, LayerPot
from butterfly_tpu_torch.ops.linalg import solve_gmres, solve_gmres_plan
from butterfly_tpu_torch.ops.linop import Diag, Identity, Product, Scaled, Sum
from butterfly_tpu_torch.ops.quadrature import (
    KrAccumCorrector,
    kr_accum_correction,
    kr_correction,
)
from butterfly_tpu_torch.trees import Quadtree
from butterfly_tpu_torch.utils.device import resolve_device
from butterfly_tpu_torch.utils.errors import InvalidArgumentsError, check
from butterfly_tpu_torch.utils.timer import device_time

# the card solve: helm2_scale's tolerance; the JAX script's max_iter, run
# without restarts as its host GMRES runs (GMRES(80) on the interleaved
# real embedding stalls from k=100 on in the scattering k-sweep)
GMRES_TOL, GMRES_MAX_ITER = 3e-7, 400


def rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@dataclasses.dataclass
class CardBie:
    """The BIE system 0.5 I + (K + C) W on a device, in tree order and the
    interleaved real embedding (row 2i = Re_i, 2i+1 = Im_i), which is the
    memory layout of a complex tensor: K compiled into a partition plan
    from the host operator `A_bf` (tree order), C the tree-permuted
    accumulate corrector, W the quadrature weights `w` (original order)."""

    plan: PartitionPlan
    corr: KrAccumCorrector
    wp2: torch.Tensor
    perm: np.ndarray
    A_bf: object
    w: np.ndarray
    rec: dict

    @property
    def device(self) -> torch.device:
        return self.plan.device

    def sys_apply(self, v: torch.Tensor) -> torch.Tensor:
        u = v * self.wp2
        return (0.5 * v + self.plan.apply(u[:, None])[:, 0]
                + self.corr.apply(u))

    def sys_apply_complex(self, z: torch.Tensor) -> torch.Tensor:
        """The system on a complex64 (n,) vector: `sys_apply` on its
        interleaved real view, the result viewed as complex again."""
        return torch.view_as_complex(
            self.sys_apply(torch.view_as_real(z).reshape(-1)).reshape(-1, 2))

    def to_card_complex(self, z: np.ndarray) -> torch.Tensor:
        """Complex (n,) in original order -> complex64 (n,) in tree order,
        on the device."""
        zp = np.asarray(z, np.complex64)[self.perm]
        return torch.from_numpy(zp).to(self.device)

    def to_card(self, z: np.ndarray) -> torch.Tensor:
        """Complex (n,) in original order -> interleaved float32 (2n,) in
        tree order, on the device: the real view of `to_card_complex`."""
        return torch.view_as_real(self.to_card_complex(z)).reshape(-1)

    def from_card(self, x) -> np.ndarray:
        """Interleaved real (2n,) or complex (n,) in tree order, a tensor
        or numpy -> complex128 (n,) in original order, on the host."""
        x = torch.as_tensor(x)
        if not x.is_complex():
            x = torch.view_as_complex(x.double().reshape(-1, 2))
        out = np.empty(x.shape[0], np.complex128)
        out[self.perm] = x.cpu().numpy()
        return out

    def residual_floor(self, sigma: np.ndarray, rhs: np.ndarray) -> dict:
        """`f32_residual_floor`: ||b - sys(sigma)|| / ||b|| for a density
        in original order, computed on the device as GMRES computes its
        true residual; at the dense-LU density no float32 solve reads a
        lower one. Beside it its two sources over ||b||, at the same
        density: `floor_from_plan`, the plan's float32 error against the
        host float64 operator, and `floor_from_corrector`, the corrector's
        complex64 error against its complex128 apply."""
        b2, x = self.to_card(rhs), self.to_card(sigma)
        r = b2 - self.sys_apply(x)
        u2, u = x * self.wp2, (self.w * sigma)[self.perm]
        got_plan = self.from_card(self.plan.apply(u2[:, None])[:, 0])
        got_corr = self.from_card(self.corr.apply(u2))
        bnorm = np.linalg.norm(rhs)
        return {
            "f32_residual_floor": float(torch.linalg.vector_norm(r)
                                        / torch.linalg.vector_norm(b2)),
            "floor_from_plan": float(np.linalg.norm(
                got_plan[self.perm] - self.A_bf.matvec(u)) / bnorm),
            "floor_from_corrector": float(np.linalg.norm(
                got_corr[self.perm] - self.corr.apply(u)) / bnorm)}

    def solve(self, rhs: np.ndarray, basis: str = "complex"):
        """GMRES on the device for a complex right-hand side in original
        order: a complex64 Krylov basis on `sys_apply_complex`, or with
        `basis="real"` a float32 one on the interleaved real embedding.
        Returns (sigma in original order, GMRES result, seconds, K2
        launches over the solve)."""
        check(basis in ("complex", "real"), f"basis {basis!r}",
              InvalidArgumentsError)
        if basis == "complex":
            b, op = self.to_card_complex(rhs), self.sys_apply_complex
        else:
            b, op = self.to_card(rhs), self.sys_apply
        launches = K2.launches
        t0 = time.perf_counter()
        res = solve_gmres_plan(op, b, tol=GMRES_TOL, restart=GMRES_MAX_ITER,
                               max_iter=GMRES_MAX_ITER)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        secs = time.perf_counter() - t0
        return self.from_card(res.x), res, secs, K2.launches - launches


def card_system(A_bf, perm: np.ndarray, w: np.ndarray, kernel_ij,
                order: int, offsets=None, device=None) -> CardBie:
    """Compile the factorized operator `A_bf` (tree order) into a partition
    plan on `device` (default: the card) and build the accumulate
    corrector of the boundaries `offsets` (one Python `kernel_ij` call per
    entry), permuted into tree order and copied to the device."""
    device = resolve_device(device)
    n = A_bf.shape[0]
    rec = {}
    t0 = time.perf_counter()
    plan = partition_apply_plan(A_bf, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    rec["plan_s"] = time.perf_counter() - t0
    rec["windows"] = plan.windows
    rec["weights_mb"] = plan.nbytes() / 1e6
    rec["lr_classes"] = plan._lr_meta
    t0 = time.perf_counter()
    corr = kr_accum_correction(order, n, kernel_ij, offsets=offsets,
                               perm=perm)
    rec["corr_s"] = time.perf_counter() - t0
    wp2 = torch.as_tensor(np.repeat(w[perm], 2), dtype=torch.float32,
                          device=device)
    return CardBie(plan, corr, wp2, np.asarray(perm), A_bf, np.asarray(w),
                   rec)


def card_timings(card: CardBie, rec: dict) -> None:
    """K2's two passes and the whole system at one column (GMRES's shape),
    medians of CUDA-event timings; None on the CPU."""
    on_card = card.device.type == "cuda"
    gen = torch.Generator(device=card.device).manual_seed(0)
    v = torch.randn((card.plan.n2,), generator=gen, device=card.device)
    rec["apply_ms_r1"] = (1e3 * device_time(
        lambda: card.plan.apply(v[:, None]), warmup=2, iters=20)
        if on_card else None)
    rec["sys_ms_r1"] = (1e3 * device_time(lambda: card.sys_apply(v),
                                          warmup=2, iters=20)
                        if on_card else None)


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


def gmres_row(rec: dict, res, secs: float, launches: int) -> None:
    """The card solve's entries of a row: iterations, times, the last
    Givens residual estimate and the true final residual."""
    rec.update(gmres_iters=int(res.num_iter), gmres_s=secs,
               ms_per_iter=1e3 * secs / max(res.num_iter, 1),
               gmres_givens_res=res.residuals[-2],
               gmres_rel_res=res.residuals[-1],
               gmres_converged=bool(res.converged), k2_launches=launches)


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

    sigma, res, secs, launches = card.solve(prob.rhs)
    gmres_row(rec, res, secs, launches)
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
