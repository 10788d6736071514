"""A second-kind boundary integral equation on a device, and its GMRES solve.

The system is 0.5 I + (K + C) W: K a factorized operator (a `LinOp` in tree
order) compiled into a partition plan (`partition_apply_plan`, kernel K2),
C the tree-permuted Kapur-Rokhlin accumulate corrector (`KrAccumCorrector`)
and W the quadrature weights. A system may lack C: the combined-field
operator of `examples/helm2_scale.py` has none, and its system is
0.5 I + K W. The BIE twins (`examples/helm2_bie.py`,
`examples/multiple_scattering.py`, `examples/helm2_scale.py`) and the
benchmark's S' system build on it.

The system applies the interleaved real embedding (row 2i = Re_i,
2i+1 = Im_i), which is the memory layout of a complex tensor, so its
complex apply is a view of the same storage and GMRES runs a complex64
Krylov basis on it (`solve_gmres_plan`), as the JAX scripts' host GMRES
runs a complex one. The JAX package has no such module: its scripts build
the system inline.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from butterfly_tpu_torch.fac.partition import (
    PartitionPlan,
    partition_apply_plan,
)
from butterfly_tpu_torch.ops.cellsp import K2
from butterfly_tpu_torch.ops.linalg import solve_gmres_plan
from butterfly_tpu_torch.ops.quadrature import (
    KrAccumCorrector,
    kr_accum_correction,
)
from butterfly_tpu_torch.utils.device import resolve_device
from butterfly_tpu_torch.utils.timer import device_time

__all__ = ["CardBie", "card_system", "card_timings", "gmres_row", "rel"]


def rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@dataclasses.dataclass
class CardBie:
    """The BIE system 0.5 I + (K + C) W on a device, in tree order and the
    interleaved real embedding: K compiled into a partition plan from the
    host operator `A_bf` (tree order), C the tree-permuted accumulate
    corrector (None: the system is 0.5 I + K W), W the quadrature weights
    `w` (original order), interleaved on the plan's device as `wp2`."""

    plan: PartitionPlan
    corr: KrAccumCorrector | None
    perm: np.ndarray
    A_bf: object
    w: np.ndarray
    rec: dict
    wp2: torch.Tensor = dataclasses.field(init=False)

    def __post_init__(self):
        self.perm, self.w = np.asarray(self.perm), np.asarray(self.w)
        self.wp2 = torch.as_tensor(np.repeat(self.w[self.perm], 2),
                                   dtype=torch.float32, device=self.device)

    @property
    def device(self) -> torch.device:
        return self.plan.device

    def sys_apply(self, v: torch.Tensor) -> torch.Tensor:
        u = v * self.wp2
        y = 0.5 * v + self.plan.apply(u[:, None])[:, 0]
        return y if self.corr is None else y + self.corr.apply(u)

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
        """`f32_residual_floor` of a system with a corrector:
        ||b - sys(sigma)|| / ||b|| for a density in original order,
        computed on the device as GMRES computes its true residual; at the
        dense-LU density no float32 solve reads a lower one. Beside it its
        two sources over ||b||, at the same density: `floor_from_plan`,
        the plan's float32 error against the host float64 operator, and
        `floor_from_corrector`, the corrector's complex64 error against
        its complex128 apply."""
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

    def solve(self, rhs: np.ndarray, tol: float, restart: int,
              max_iter: int):
        """GMRES on the device for a complex right-hand side in original
        order: a complex64 Krylov basis on `sys_apply_complex`, with the
        caller's tolerance, restart length and iteration cap. Returns
        (sigma in original order, GMRES result, seconds, K2 launches over
        the solve)."""
        b = self.to_card_complex(rhs)
        launches = K2.launches
        t0 = time.perf_counter()
        res = solve_gmres_plan(self.sys_apply_complex, b, tol=tol,
                               restart=restart, max_iter=max_iter)
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
    return CardBie(plan, corr, perm, A_bf, w, rec)


def card_timings(card: CardBie, rec: dict) -> None:
    """K2's two passes and the whole system at one column (GMRES's shape),
    each the mean of a batch of calls between CUDA events; None on the
    CPU."""
    on_card = card.device.type == "cuda"
    gen = torch.Generator(device=card.device).manual_seed(0)
    v = torch.randn((card.plan.n2,), generator=gen, device=card.device)
    rec["apply_ms_r1"] = (1e3 * device_time(
        lambda: card.plan.apply(v[:, None]), warmup=2, iters=20)
        if on_card else None)
    rec["sys_ms_r1"] = (1e3 * device_time(lambda: card.sys_apply(v),
                                          warmup=2, iters=20)
                        if on_card else None)


def gmres_row(rec: dict, res, secs: float, launches: int,
              tol: float) -> None:
    """The card solve's entries of a row: the tolerance it was given, its
    iterations, times, the last Givens residual estimate and the true
    final residual."""
    rec.update(gmres_tol=tol, gmres_iters=int(res.num_iter), gmres_s=secs,
               ms_per_iter=1e3 * secs / max(res.num_iter, 1),
               gmres_givens_res=res.residuals[-2],
               gmres_rel_res=res.residuals[-1],
               gmres_converged=bool(res.converged), k2_launches=launches)
