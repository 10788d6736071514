"""The port's GMRES solvers (ops/linalg.py) against the JAX package's.

Both packages get the same numpy systems: the host `solve_gmres` on the
real, complex and multi-RHS/restart systems of tests/test_linalg.py, the
device solvers on its device systems (the port on the CPU, the JAX package
through XLA on the CPU), and the combined-field Helmholtz BIE of
`examples/helm2_scale.py` at n=1024 on one operator carried across with
`linop_from_numpy`: the JAX plan runs its cell kernel K2 in Pallas
interpret mode, the port's plan `cells_plain`. The port's
`solve_gmres_plan` also takes complex systems (a complex Krylov basis; the
JAX drivers are real-only): a plain complex128 matrix against
`numpy.linalg.solve`, and the same BIE in complex64 against the JAX
package's host complex `solve_gmres`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from butterfly_tpu.fac import helm2 as jax_fac_helm2
from butterfly_tpu.fac.partition import partition_apply_plan as jax_plan
from butterfly_tpu.geom import Ellipse
from butterfly_tpu.ops import linalg as J
from butterfly_tpu.ops.helm2 import Helm2, LayerPot
from butterfly_tpu.ops import linop as JL
from butterfly_tpu.ops.linop import Dense as JDense
from butterfly_tpu.ops.packed import pack as jax_pack
from butterfly_tpu.trees import Quadtree
from butterfly_tpu.utils.oracle import row_oracle_rel_err as jax_oracle
from butterfly_tpu_torch.convert import linop_from_numpy
from butterfly_tpu_torch.fac.partition import partition_apply_plan
from butterfly_tpu_torch.ops import linalg as P
from butterfly_tpu_torch.ops.linop import Dense
from butterfly_tpu_torch.ops.packed import pack
from butterfly_tpu_torch.utils.errors import InvalidArgumentsError
from butterfly_tpu_torch.utils.oracle import row_oracle_rel_err


def _rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _system(kind, rng):
    """tests/test_linalg.py's host systems: (A, b, solve_gmres kwargs)."""
    if kind == "real":
        n = 80
        A = np.eye(n) * 4 + 0.5 * rng.standard_normal((n, n))
        return A, rng.standard_normal(n), dict(tol=1e-12)
    if kind == "complex":
        n = 60
        A = np.eye(n) * (2 + 1j) + 0.3 * (
            rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
        b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        return A, b, dict(tol=1e-12)
    if kind == "multi_rhs_restart":
        n = 160
        A = (np.diag(np.linspace(1, 2, n))
             + 0.02 * rng.standard_normal((n, n)))
        return A, rng.standard_normal((n, 6)), dict(tol=1e-10, restart=15,
                                                   max_iter=300)
    # a matrix-free callable with a left preconditioner
    n = 100
    d = 1.0 + rng.random(n) * 100
    A = np.diag(d) + 0.1 * rng.standard_normal((n, n))
    return (lambda v: A @ v), rng.standard_normal(n), dict(
        tol=1e-10, max_iter=60, M=lambda v: v / d)


@pytest.mark.parametrize("kind", ["real", "complex", "multi_rhs_restart",
                                  "callable_preconditioned"])
def test_host_gmres_matches_jax(kind):
    A, b, kw = _system(kind, np.random.default_rng(42))
    want = J.solve_gmres(A, b, **kw)
    got = P.solve_gmres(A, b, **kw)
    assert got.converged and want.converged
    assert got.num_iter == want.num_iter
    np.testing.assert_allclose(got.x, want.x, rtol=0, atol=1e-10)
    np.testing.assert_allclose(got.residuals, want.residuals, rtol=1e-6,
                               atol=1e-14)


def test_device_gmres_matches_jax():
    """tests/test_linalg.py's n=128, 4-RHS system in float64."""
    rng = np.random.default_rng(42)
    n = 128
    A = np.diag(np.linspace(1, 2, n)) + 0.02 * rng.standard_normal((n, n))
    B = rng.standard_normal((n, 4))
    Aj = jnp.asarray(A)
    xj, itj, resj = J.solve_gmres_device(lambda V: Aj @ V, jnp.asarray(B),
                                         tol=1e-9, restart=20, max_cycles=10)
    At = torch.from_numpy(A)
    x, it, res = P.solve_gmres_device(lambda V: At @ V, B, tol=1e-9,
                                      restart=20, max_cycles=10,
                                      device="cpu")
    assert isinstance(x, torch.Tensor) and x.dtype == torch.float64
    assert it == int(itj)
    assert res < 1e-9
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=0, atol=1e-8)
    # a matrix operand and a vector right-hand side take the same path
    xv, itv, _ = P.solve_gmres_device(A, torch.from_numpy(B[:, 0]),
                                      tol=1e-9, restart=20, max_cycles=10)
    assert xv.shape == (n,) and itv <= it
    np.testing.assert_allclose(xv.numpy(), np.asarray(xj)[:, 0], rtol=0,
                               atol=1e-8)


def test_device_gmres_on_real_embedded_plan_matches_jax():
    """The complex system rides both packages' 2x2 real-embedded stage
    plans (tests/test_linalg.py's n=96 case)."""
    rng = np.random.default_rng(42)
    n = 96
    Ac = np.eye(n) + 0.05 * (rng.standard_normal((n, n))
                             + 1j * rng.standard_normal((n, n)))
    bc = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    br = np.concatenate([bc.real, bc.imag])[:, None]
    jp = jax_pack(JDense(Ac), dtype=np.complex128, real_embed=True)
    xj, itj, _ = J.solve_gmres_device(lambda V: jp.apply_stacked(V), br,
                                      tol=1e-10, restart=30, max_cycles=8)
    pp = pack(Dense(Ac), dtype=np.complex128, real_embed=True, device="cpu")
    x, it, res = P.solve_gmres_device(pp.apply_stacked, br, tol=1e-10,
                                      restart=30, max_cycles=8,
                                      device="cpu")
    assert it == int(itj) and res < 1e-10
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=0, atol=1e-8)
    xr = x.numpy()[:, 0]
    assert _rel(Ac @ (xr[:n] + 1j * xr[n:]), bc) < 1e-8


@pytest.mark.parametrize("restart,max_iter", [(40, 160), (10, 200)])
def test_gmres_plan_matches_jax(restart, max_iter):
    """tests/test_linalg.py's n=160 float32 system, one cycle and
    restarted."""
    rng = np.random.default_rng(42)
    n = 160
    A = np.diag(np.linspace(1, 2, n)) + 0.02 * rng.standard_normal((n, n))
    b = rng.standard_normal(n)
    Aj = jnp.asarray(A, jnp.float32)
    want = J.solve_gmres_plan(lambda v: Aj @ v.astype(jnp.float32),
                              jnp.asarray(b, jnp.float32), tol=1e-5,
                              restart=restart, max_iter=max_iter)
    At = torch.as_tensor(A, dtype=torch.float32)
    got = P.solve_gmres_plan(lambda v: At @ v,
                             torch.as_tensor(b, dtype=torch.float32),
                             tol=1e-5, restart=restart, max_iter=max_iter)
    assert got.converged and want.converged
    assert abs(got.num_iter - want.num_iter) <= 1
    assert got.x.dtype == np.float32
    np.testing.assert_allclose(got.x, np.asarray(want.x), rtol=0, atol=1e-4)
    assert _rel(A @ got.x, b) < 1e-4


@pytest.fixture(scope="module")
def bie():
    """The combined-field BIE of examples/helm2_scale.py at n=1024 (ppw 64,
    leaf 64), factorized once by the JAX package."""
    n = 1024
    X, _, Nrm, w = Ellipse(1.0, 0.7, (0.0, 0.0), 0.3).sample_linspaced(n)
    k = 2 * np.pi * n / (64.0 * float(np.sum(w)))
    helm = Helm2(k=k, layer_pot=LayerPot.COMBINED_FIELD, alpha=-1j * k,
                 beta=1.0)
    tree = Quadtree(X, leaf_size=64, normals=Nrm)
    A = jax_fac_helm2.make_multilevel(helm, tree, tree)
    Xp, Np, wp = X[tree.perm], Nrm[tree.perm], w[tree.perm]
    u = Helm2(k=k, layer_pot=LayerPot.SINGLE).kernel_matrix(
        np.array([[0.1, -0.05]]), Xp)[:, 0]
    b2 = np.empty(2 * n, np.float32)
    b2[0::2], b2[1::2] = u.real, u.imag
    rng = np.random.default_rng(0)
    zs = rng.standard_normal((n, 2)) + 1j * rng.standard_normal((n, 2))

    def exact_rows(rows):
        return helm.kernel_matrix(Xp, Xp[rows], Np, None) @ zs

    return A, np.repeat(wp, 2).astype(np.float32), b2, zs, exact_rows, wp, u


def test_bie_gmres_plan_matches_jax(bie):
    A, wp2, b2, zs, exact_rows, _, _ = bie
    n = A.shape[0]
    jp = jax_plan(A)
    wj = jnp.asarray(wp2)
    want = J.solve_gmres_plan(
        lambda v: 0.5 * v + jp.apply_device((v * wj)[:, None])[:, 0],
        jnp.asarray(b2), tol=3e-7, restart=80, max_iter=300)
    pp = partition_apply_plan(linop_from_numpy(A), device="cpu")
    wt = torch.from_numpy(wp2)
    got = P.solve_gmres_plan(
        lambda v: 0.5 * v + pp.apply((v * wt)[:, None])[:, 0],
        torch.from_numpy(b2), tol=3e-7, restart=80, max_iter=300)
    assert got.converged and want.converged
    assert abs(got.num_iter - want.num_iter) <= 1
    assert _rel(got.x, np.asarray(want.x)) < 1e-5
    rel_t, rows_t = row_oracle_rel_err(pp.apply_complex(zs), exact_rows, n)
    rel_j, rows_j = jax_oracle(jp.apply_complex(zs), exact_rows, n)
    np.testing.assert_array_equal(rows_t, rows_j)
    assert rel_t < 1e-6 and abs(rel_t - rel_j) < 1e-6


@pytest.mark.parametrize("restart", [400, 12])
def test_gmres_plan_complex_matches_numpy_solve(restart):
    """A well-conditioned complex128 system through the complex basis, in
    one cycle and restarted: the solution to 1e-10 of `numpy.linalg.solve`."""
    rng = np.random.default_rng(11)
    n = 90
    A = np.eye(n) * (3 + 1j) + (rng.standard_normal((n, n))
                                + 1j * rng.standard_normal((n, n))) / n ** .5
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    At = torch.as_tensor(A)
    got = P.solve_gmres_plan(lambda v: At @ v, torch.as_tensor(b),
                             tol=1e-13, restart=restart, max_iter=400)
    assert got.converged and got.x.dtype == np.complex128
    assert _rel(got.x, np.linalg.solve(A, b)) <= 1e-10
    assert got.residuals[-1] < 1e-12


@pytest.mark.parametrize("dtype,rtol", [(torch.complex64, 1e-6),
                                        (torch.complex128, 1e-12),
                                        (torch.float64, 1e-12)])
def test_cgs2_on_the_whole_basis_equals_the_rows_in_use(dtype, rtol):
    """The step a card replays, CGS2 and the packed column over a basis
    whose rows past j are zero (the bucket of rows the card replays at j,
    and the whole basis), against the step on V[: j + 1] that the CPU
    runs: h, beta, q and the column, at the first, a middle and the last
    j; each also against w = V^T h + beta q, q orthogonal to V."""
    m, n = 24, 64
    rng = np.random.default_rng(5)
    cplx = dtype.is_complex
    hdtype = torch.complex128 if cplx else torch.float64

    def draw(*shape):
        z = rng.standard_normal(shape)
        return z + 1j * rng.standard_normal(shape) if cplx else z

    def close(got, want):
        return float(torch.linalg.vector_norm(got - want)) <= rtol * float(
            torch.linalg.vector_norm(want))

    basis = np.linalg.qr(draw(n, m + 1))[0].T
    for j in (0, m // 2, m - 1):
        V = torch.zeros((m + 1, n), dtype=dtype)
        V[: j + 1] = torch.as_tensor(basis[: j + 1], dtype=dtype)
        w = torch.as_tensor(draw(n), dtype=dtype)
        q, col = P._cgs2(V[: j + 1], w, hdtype)
        assert col.shape == (j + 2,) and col.dtype == hdtype
        for rows in (P._rows(j, m), m + 1):
            q_all, col_all = P._cgs2(V[:rows], w, hdtype)
            assert rows >= j + 1 and col_all.shape == (rows + 1,)
            assert col_all.dtype == hdtype
            assert torch.count_nonzero(col_all[j + 2:]) == 0
            assert close(col_all[: j + 2], col)
            assert close(col_all[1: j + 2], col[1:])                 # h
            assert abs(col_all[0] - col[0]) <= rtol * abs(col[0])    # beta
            assert close(q_all, q)
        h = col[1:].to(dtype)
        assert close(V[: j + 1].T @ h + col[0].real.to(dtype) * q, w)
        assert float(torch.linalg.vector_norm(V.conj() @ q)) <= rtol


def test_bie_gmres_plan_complex_against_jax_host(bie):
    """The combined-field BIE in complex64 through the port's plan (its
    interleaved real apply viewed as complex) against the JAX package's
    host complex128 GMRES on the same operator and settings: converged
    (true residual < 10 x tol), the density to 2e-5, and at most 1.1x the
    host's iterations; the real embedding needs more."""
    A, wp2, b2, _, _, wp, u = bie
    n = A.shape[0]
    sys_j = JL.Sum([JL.Product([A, JL.Diag(wp)]),
                    JL.Scaled(0.5, JL.Identity(n, dtype=np.complex128))])
    want = J.solve_gmres(sys_j, u, tol=3e-7, restart=80, max_iter=300)
    pp = partition_apply_plan(linop_from_numpy(A), device="cpu")
    wt = torch.from_numpy(wp2)

    def sys_real(v):
        return 0.5 * v + pp.apply((v * wt)[:, None])[:, 0]

    def sys_complex(z):
        v = torch.view_as_real(z).reshape(-1)
        return torch.view_as_complex(sys_real(v).reshape(-1, 2))

    got = P.solve_gmres_plan(sys_complex, torch.from_numpy(
        u.astype(np.complex64)), tol=3e-7, restart=80, max_iter=300)
    assert want.converged and got.converged
    assert got.residuals[-1] < 3e-6 and got.x.dtype == np.complex64
    assert got.num_iter <= 1.1 * want.num_iter
    assert _rel(got.x, np.asarray(want.x)) <= 2e-5
    real = P.solve_gmres_plan(sys_real, torch.from_numpy(b2), tol=3e-7,
                              restart=80, max_iter=300)
    assert real.converged and got.num_iter < real.num_iter


def test_device_gmres_refuses_complex():
    with pytest.raises(InvalidArgumentsError, match="solve_gmres_plan"):
        P.solve_gmres_device(lambda v: v, torch.ones(4, dtype=torch.complex64))
