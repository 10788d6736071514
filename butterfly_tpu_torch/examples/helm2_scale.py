"""Large-N Helmholtz butterfly on the card: setup cost, apply, GMRES solve.

Twin of the JAX package's `examples/helm2_scale.py`. It factorizes the 2D
Helmholtz combined-field operator D - ikS on an ellipse (1, 0.7, rotated
0.3) at n points with points-per-wavelength held fixed (k grows with n),
compiles it into the two-pass cell program (`partition_apply_plan`, kernel
K2 on the card), checks the apply against a row-sampled dense oracle
(`utils/oracle.py`: no dense operator exists at these sizes), and solves
the second-kind BIE (I/2 + K W) sigma = f through the library's card system
without a corrector (`models/bie.py` `CardBie`: a complex64 Krylov basis
on the card over the plan's interleaved real embedding, which is torch's
complex layout; one Hessenberg column to the host per iteration), so the
solve takes about iterations x apply.

Usage:
  python -m butterfly_tpu_torch.examples.helm2_scale --sizes 16384

Each size prints one JSON row with the JAX script's keys, except
`mega_streamed_mb` (the port streams no weights from the host), plus
`apply_ms_r1` (the apply at one column, the shape GMRES runs),
`gmres_ms_per_iter`, `gmres_residuals` (the relative residual history,
the true final residual last), `gmres_k2_launches`, `windows` (where
the plan's low-rank windows came from: "device_f64" or "host_chains"),
`lr_classes` (each chunk's size class, members, rank, probe residual and
its escalation steps) and `setup_plan_peak_mb` (the plan's peak device
memory above what was allocated before it).
Times are means of a batch of calls between two CUDA events on the card;
where the plan lies on the CPU, they are None (not measured). `run_one` =
`measure(setup(...))`; `chip_smoke.py` calls the two halves itself to
check K2 on the plan in between.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from butterfly_tpu_torch.fac import helm2 as fac_helm2
from butterfly_tpu_torch.fac.partition import partition_apply_plan
from butterfly_tpu_torch.geom import Ellipse
from butterfly_tpu_torch.models.bie import CardBie
from butterfly_tpu_torch.ops.helm2 import Helm2, LayerPot
from butterfly_tpu_torch.trees import Quadtree
from butterfly_tpu_torch.utils.device import resolve_device
from butterfly_tpu_torch.utils.oracle import row_oracle_rel_err
from butterfly_tpu_torch.utils.timer import device_time


def log(*a):
    print(*a, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Helm2Scale:
    """One size's problem: the operator's kernel, the points and normals
    in tree order, the card system (the compiled plan, no corrector) and
    the row built so far."""

    helm: Helm2
    k: float
    Xp: np.ndarray
    Np: np.ndarray
    card: CardBie
    rec: dict

    def rhs_complex(self) -> np.ndarray:
        """Single-layer field of an interior source at (0.1, -0.05),
        complex128 in original order: the reference flagship's right-hand
        side (examples/simple/helm2_bie.c:162-175)."""
        x_src = np.array([[0.1, -0.05]])
        helm_s = Helm2(k=self.k, layer_pot=LayerPot.SINGLE)
        u = np.empty(len(self.Xp), np.complex128)
        u[self.card.perm] = helm_s.kernel_matrix(x_src, self.Xp)[:, 0]
        return u

    def rhs(self) -> torch.Tensor:
        """The right-hand side interleaved in tree order on the plan's
        device (`CardBie.to_card`)."""
        return self.card.to_card(self.rhs_complex())


@dataclasses.dataclass
class Helm2Fac:
    """One size's host factorization: the kernel, the ellipse's points,
    normals and quadrature weights (input order), the tree and the
    multilevel operator (tree order)."""

    helm: Helm2
    k: float
    X: np.ndarray
    Nrm: np.ndarray
    w: np.ndarray
    tree: Quadtree
    A: object
    rec: dict


def factorize(n: int, ppw: float, leaf: int) -> Helm2Fac:
    """The combined-field operator at n points, factorized on the host in
    float64."""
    ell = Ellipse(1.0, 0.7, (0.0, 0.0), 0.3)
    X, _, Nrm, w = ell.sample_linspaced(n)
    perimeter = float(np.sum(w))
    k = 2 * np.pi * n / (ppw * perimeter)
    # exterior-Dirichlet combined field D - i*k*S: resonance-free, so
    # GMRES converges at every wavenumber
    helm = Helm2(k=k, layer_pot=LayerPot.COMBINED_FIELD,
                 alpha=-1j * k, beta=1.0)
    rec = {"n": n, "k": round(k, 1), "ppw": ppw}
    log(f"n={n}: k={k:.1f} (ppw={ppw})")

    t0 = time.perf_counter()
    tree = Quadtree(X, leaf_size=leaf, normals=Nrm)
    A = fac_helm2.make_multilevel(helm, tree, tree)
    rec["setup_fac_s"] = time.perf_counter() - t0
    log(f"  fac setup: {rec['setup_fac_s']:.1f} s")
    return Helm2Fac(helm, k, X, Nrm, w, tree, A, rec)


def compile_plan(fac: Helm2Fac, device=None) -> Helm2Scale:
    """Compile the factorization into the partition plan on `device`
    (default: the card). On the card the row records the plan's peak
    device memory."""
    device = resolve_device(device)
    n = fac.A.shape[0]
    rec = dict(fac.rec)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    t0 = time.perf_counter()
    plan = partition_apply_plan(fac.A, device=device)
    if on_card:
        torch.cuda.synchronize(device)
    rec["setup_plan_s"] = time.perf_counter() - t0
    rec["setup_plan_peak_mb"] = (
        (torch.cuda.max_memory_allocated(device) - base) / 1e6 if on_card
        else None)
    rec["weights_mb"] = plan.nbytes() / 1e6
    rec["dense_mb"] = n * n * 16 / 1e6
    rec["compression_ratio"] = plan.nbytes() / (n * n * 16)
    rec["num_mega_blocks"] = plan.num_oversized
    rec["windows"] = plan.windows
    rec["lr_classes"] = plan._lr_meta
    log(f"  plan: {rec['setup_plan_s']:.1f} s, {rec['weights_mb']:.1f} MB "
        f"({rec['compression_ratio']:.4f} of dense c128), low-rank windows "
        f"{plan.windows}, peak {rec['setup_plan_peak_mb']} MB")
    perm = fac.tree.perm
    # the card system's record is the row
    card = CardBie(plan, None, perm, fac.A, fac.w, rec)
    return Helm2Scale(fac.helm, fac.k, fac.X[perm], fac.Nrm[perm], card, rec)


def setup(n: int, ppw: float, leaf: int, device=None) -> Helm2Scale:
    """Factorize on the host (float64) and compile the plan on `device`
    (default: the card)."""
    device = resolve_device(device)
    return compile_plan(factorize(n, ppw, leaf), device)


def measure(prob: Helm2Scale, queries: int = 64) -> dict:
    """Time the apply (on the card), check it against the 128-row oracle
    and solve the BIE; returns the finished row."""
    plan, rec, n = prob.card.plan, prob.rec, prob.card.plan.shape[0]
    dev = plan.device
    on_card = dev.type == "cuda"

    # ---- apply time at r = queries and at r = 1 (GMRES's shape) ---------
    gen = torch.Generator(device=dev).manual_seed(0)
    for key, r in (("apply_ms", queries), ("apply_ms_r1", 1)):
        x0 = torch.randn((plan.n2, r), generator=gen, device=dev)
        rec[key] = (1e3 * device_time(lambda: plan.apply(x0), warmup=2,
                                      iters=20) if on_card else None)
    rec["apply_tflops"] = (plan.flops_per_col() * queries / rec["apply_ms"]
                           / 1e9 if on_card else None)
    log(f"  apply r={queries}: {rec['apply_ms']} ms, r=1: "
        f"{rec['apply_ms_r1']} ms")

    # ---- accuracy vs the row-sampled dense oracle -----------------------
    rng = np.random.default_rng(0)
    zs = rng.standard_normal((n, 2)) + 1j * rng.standard_normal((n, 2))
    got = plan.apply_complex(zs)

    def exact_rows(rows):
        return prob.helm.kernel_matrix(prob.Xp, prob.Xp[rows], prob.Np,
                                       None) @ zs

    rel, _ = row_oracle_rel_err(got, exact_rows, n, num_rows=128)
    rec["rel_err_vs_dense"] = rel
    log(f"  rel err vs dense (128-row oracle): {rel:.3e}")

    # ---- GMRES on the second-kind BIE (complex basis) -------------------
    # the JAX script's settings (examples/helm2_scale.py:156-157)
    _, res, rec["gmres_s"], rec["gmres_k2_launches"] = prob.card.solve(
        prob.rhs_complex(), tol=3e-7, restart=80, max_iter=300)
    rec["gmres_iters"] = int(res.num_iter)
    rec["gmres_ms_per_iter"] = 1e3 * rec["gmres_s"] / max(res.num_iter, 1)
    rec["gmres_rel_res"] = res.residuals[-1]
    rec["gmres_residuals"] = res.residuals
    rec["gmres_converged"] = bool(res.converged)
    log(f"  GMRES: {res.num_iter} iters, rel res {res.residuals[-1]:.2e}, "
        f"{rec['gmres_s']:.2f} s")
    rec["device"] = torch.cuda.get_device_name(dev) if on_card else str(dev)
    return rec


def run_one(n: int, ppw: float, leaf: int, queries: int = 64,
            device=None) -> dict:
    """One size end to end on `device` (default: the card)."""
    return measure(setup(n, ppw, leaf, device=device), queries)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="+", default=[16384])
    ap.add_argument("--ppw", type=float, default=64.0)
    ap.add_argument("--leaf", type=int, default=64)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    rows = []
    for n in args.sizes:
        rows.append(run_one(n, args.ppw, args.leaf, queries=args.queries))
        print(json.dumps(rows[-1]), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
