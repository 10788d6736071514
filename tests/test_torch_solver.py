"""The port's fast direct solver (fac/middle_out.py, ops/hostpack.py,
fac/solver.py, fac/device_solve.py) against the JAX package's, and smoke
runs of the two example twins on the CPU.

Both packages get the same numpy systems and the same seeded numpy
generators, so the host factorizations draw the same sketches. The
`DeviceSolver`s get one factorization: the JAX package's, carried across
with `fast_direct_solver_from_numpy`. The port's runs on the CPU, the JAX
one through XLA on the CPU.
"""

import numpy as np
import pytest
import torch

from butterfly_tpu.fac.device_solve import DeviceSolver as JaxDeviceSolver
from butterfly_tpu.fac.middle_out import (
    sample_middle_out_butterfly as jax_middle_out,
)
from butterfly_tpu.fac.solver import FastDirectSolver as JaxFDS
from butterfly_tpu.geom import Ellipse
from butterfly_tpu.ops.helm2 import Helm2, LayerPot
from butterfly_tpu.ops.hostpack import HostPlan as JaxHostPlan
from butterfly_tpu.trees import Quadtree
from butterfly_tpu_torch.convert import fast_direct_solver_from_numpy
from butterfly_tpu_torch.examples import fast_direct_solver as fds_twin
from butterfly_tpu_torch.examples import helm2_scale
from butterfly_tpu_torch.fac.device_solve import DeviceSolver
from butterfly_tpu_torch.fac.middle_out import sample_middle_out_butterfly
from butterfly_tpu_torch.fac.solver import FastDirectSolver
from butterfly_tpu_torch.ops.hostpack import HostPlan


def _rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _low_rank_blocks(dtype):
    """tests/test_solver.py's operators: a 4 x 4 grid of rank-6 blocks
    (real), one rank-8 operator split in two (complex)."""
    rng = np.random.default_rng(7)
    if dtype == np.float64:
        R = np.block([[rng.standard_normal((64, 6))
                       @ rng.standard_normal((6, 64)) for _ in range(4)]
                      for _ in range(4)])
        return R, np.arange(5) * 64, 24
    R = ((rng.standard_normal((128, 8)) + 1j * rng.standard_normal((128, 8)))
         @ (rng.standard_normal((8, 128))
            + 1j * rng.standard_normal((8, 128))))
    return R, np.array([0, 64, 128]), 16


@pytest.mark.parametrize("dtype", [np.float64, np.complex128],
                         ids=["real", "complex"])
@pytest.mark.parametrize("deep", [True, False], ids=["deep", "one_level"])
def test_middle_out_and_hostpack_match_jax(dtype, deep):
    R, offs, rank = _low_rank_blocks(dtype)

    def sample(fn):
        return fn(lambda v: R @ v, lambda v: R.conj().T @ v, offs, offs,
                  rank=rank, dtype=dtype, rng=np.random.default_rng(42),
                  deep=deep)

    got, want = sample(sample_middle_out_butterfly), sample(jax_middle_out)
    Mg = got.materialize()
    np.testing.assert_allclose(Mg, want.materialize(), rtol=0, atol=1e-10)
    assert _rel(Mg, R) < 1e-8
    # the host-packed apply, both directions
    X = np.random.default_rng(1).standard_normal((R.shape[1], 5))
    hp, jhp = HostPlan(got, block_align=32), JaxHostPlan(want, block_align=32)
    assert hp.nbytes() == jhp.nbytes()
    np.testing.assert_allclose(hp.matmat(X), jhp.matmat(X), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(hp.matmat(X), Mg @ X, rtol=0, atol=1e-10)
    np.testing.assert_allclose(hp.rmatmat(X), Mg.conj().T @ X, rtol=0,
                               atol=1e-10)


def _helm_system():
    """tests/test_solver.py's second-kind BIE system in quadtree order."""
    n, k = 1024, 15.0
    X, T, N, w = Ellipse(1.0, 0.6, (0.0, 0.0), 0.2).sample_linspaced(n)
    helm = Helm2(k=k, layer_pot=LayerPot.PV_NORMAL_DERIV_SINGLE)
    tree = Quadtree(X, leaf_size=32, normals=N)
    P = tree.perm
    A = helm.kernel_matrix(X, X, None, N) * w[None, :] + 0.5 * np.eye(n)
    return A[np.ix_(P, P)]


def _spd_system():
    """tests/test_solver.py's covariance-style SPD system."""
    rng = np.random.default_rng(42)
    x = np.sort(rng.random(512))
    return np.exp(-((x[:, None] - x[None, :]) ** 2) / 0.1**2) \
        + 0.1 * np.eye(512)


@pytest.mark.parametrize("system,kw", [
    (_helm_system, dict(base_size=128, tol=1e-12)),
    (_spd_system, dict(base_size=64, tol=1e-13)),
], ids=["helm_bie", "spd"])
def test_fast_direct_solver_matches_jax(system, kw):
    A = system()
    n = A.shape[0]
    rng = np.random.default_rng(0)
    b = rng.standard_normal((n, 2)) + 1j * rng.standard_normal((n, 2))
    if not np.iscomplexobj(A):
        b = b.real
    got = FastDirectSolver(A, **kw)
    want = JaxFDS(A, **kw)
    xg, xw = got.solve(b), want.solve(b)
    assert _rel(xg, xw) < 1e-10
    assert _rel(A @ xg, b) < 1e-8
    assert got.nbytes() == want.nbytes() and got.nbytes() < A.nbytes
    # the carried factorization solves as the JAX one does
    np.testing.assert_allclose(fast_direct_solver_from_numpy(want).solve(b),
                               xw, rtol=0, atol=1e-12)


def test_device_solver_matches_jax_and_refines():
    """tests/test_solver.py's n=768 Gaussian system: one JAX factorization,
    both packages' DeviceSolvers."""
    rng = np.random.default_rng(3)
    n = 768
    x = np.sort(rng.uniform(0.0, 1.0, n))
    A = np.exp(-((x[:, None] - x[None, :]) ** 2) / 0.01) + 2.0 * np.eye(n)
    fds = JaxFDS(A, base_size=128, tol=1e-10, rank=48)
    b = rng.standard_normal((n, 3))
    want = np.asarray(JaxDeviceSolver(fds).solve(b.astype(np.float32)),
                      np.float64)
    ds = DeviceSolver(fast_direct_solver_from_numpy(fds), device="cpu")
    got = ds.solve(b.astype(np.float32))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert _rel(got.double().numpy(), want) < 1e-5
    assert _rel(got.double().numpy(), fds.solve(b)) < 5e-4
    assert ds.solve(b[:, 0]).shape == (n,)
    x_ref = ds.solve_refined(b, matmat=lambda X: A @ X, iters=3)
    assert _rel(A @ x_ref, b) < 1e-10


_SCALE_KEYS = {
    "n", "k", "ppw", "setup_fac_s", "setup_plan_s", "weights_mb",
    "dense_mb", "compression_ratio", "num_mega_blocks", "apply_ms",
    "apply_tflops", "rel_err_vs_dense", "gmres_s", "gmres_iters",
    "gmres_rel_res", "gmres_converged", "device"}


def test_helm2_scale_twin_on_cpu():
    """The scale twin's row at n=512: the JAX script's keys (without
    `mega_streamed_mb`) and its own; no device times on the CPU."""
    rec = helm2_scale.run_one(512, 64.0, 64, queries=4, device="cpu")
    assert _SCALE_KEYS <= set(rec)
    assert {"apply_ms_r1", "gmres_ms_per_iter", "gmres_residuals",
            "gmres_k2_launches"} <= set(rec)
    assert rec["gmres_converged"] and rec["gmres_rel_res"] < 3e-6
    assert 0 < rec["gmres_iters"] < 300
    assert rec["rel_err_vs_dense"] < 1e-6
    assert rec["apply_ms"] is None and rec["gmres_k2_launches"] == 0
    assert rec["device"] == "cpu"


def test_helm2_scale_card_system_without_corrector():
    """The scale twin's card system (`models/bie.py` with no corrector) at
    n=512, applied to a complex64 vector in tree order, against
    0.5 x + A (w x) from the host operator in float64: its error within
    twice the plan's own float32 error on w x, and under the twin's 1e-6;
    the complex apply is a view of the real one."""
    card = helm2_scale.setup(512, 64.0, 64, device="cpu").card
    assert card.corr is None
    n = len(card.perm)
    rng = np.random.default_rng(2)
    z = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    zt = torch.from_numpy(z)
    got = card.sys_apply_complex(zt)
    wz = card.w[card.perm] * z.astype(np.complex128)
    Awz = card.A_bf.matvec(wz)
    want = 0.5 * z + Awz
    err = np.linalg.norm(got.numpy() - want)
    plan_err = np.linalg.norm(card.plan.apply_complex(wz[:, None])[:, 0]
                              - Awz)
    assert err <= 2 * plan_err
    assert err / np.linalg.norm(want) < 1e-6
    real = card.sys_apply(torch.view_as_real(zt).reshape(-1))
    assert torch.equal(torch.view_as_real(got).reshape(-1), real)


def test_fast_direct_solver_twin_on_cpu():
    """The BIE mode, and the device half of the operator-first mode (its
    peak-RSS gate holds only at large n, so it is left out)."""
    bie = fds_twin.run_bie(512, 10.0, 128)
    assert bie["residual"] < 1e-10
    acc, fds, _ = fds_twin.factor_operator(1024)
    b = np.random.default_rng(0).standard_normal(1024)
    assert _rel(acc.matmat(fds.solve(b)), b) < 1e-8
    out = fds_twin.run_device(acc, fds, np.random.default_rng(1),
                              device="cpu")
    assert out["rel_vs_host"] < 5e-4 and out["refined_residual"] < 1e-8
    assert out["ms_per_rhs"] is None
