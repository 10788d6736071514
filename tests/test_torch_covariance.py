"""The port's Chebyshev and covariance layers (ops/cheb.py,
models/covariance.py, the covariance twin) and the compressed LBO basis
carried across by `lbo_compression_from_numpy`, against the JAX package's.

All of it is host float64 numpy and scipy in both packages, so the
coefficients and applies agree to 1e-10 (the same code on the same
inputs). The compressed covariance is applied through the JAX package's own
compression, carried across, so both packages apply the same basis.
Meshes are icosphere(2), as in tests/test_covariance.py.
"""

import numpy as np
import pytest
import torch

from butterfly_tpu.geom.trimesh import icosphere as jax_icosphere
from butterfly_tpu.models import covariance as jcov
from butterfly_tpu.models.lbo import compress_lbo_eigenfunctions as jax_lbo
from butterfly_tpu.ops import cheb as jcheb
from butterfly_tpu_torch.convert import lbo_compression_from_numpy
from butterfly_tpu_torch.examples import covariance as twin_cov
from butterfly_tpu_torch.models import covariance as tcov
from butterfly_tpu_torch.ops import cheb as tcheb


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch and one BLAS thread while this module runs (see
    tests/test_torch_lbo.py)."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sphere():
    """The JAX package's icosphere(2), its FEM pencil and its compressed
    eigenbasis (tol 1e-8), and that compression carried across."""
    mesh = jax_icosphere(2)
    L, M = mesh.lbo_fem()
    comp = jax_lbo(mesh, tol=1e-8)
    return mesh, L, M, comp, lbo_compression_from_numpy(comp)


def _rel(got, want):
    return np.linalg.norm(np.asarray(got) - want) / np.linalg.norm(want)


@pytest.mark.parametrize("f", [np.exp, lambda x: 1.0 / (1.0 + x * x)])
def test_cheb_fit_and_matvec_match_jax(f):
    t, j = tcheb.ChebFit(f, -1.0, 3.0, 40), jcheb.ChebFit(f, -1.0, 3.0, 40)
    np.testing.assert_allclose(t.c, j.c, rtol=0, atol=1e-10)
    x = np.linspace(-1.0, 3.0, 101)
    np.testing.assert_allclose(t(x), j(x), rtol=0, atol=1e-10)
    assert abs(t.max_error(f) - j.max_error(f)) <= 1e-10
    rng = np.random.default_rng(0)
    A = rng.standard_normal((30, 30))
    S = np.diag(np.linspace(-0.9, 2.9, 30))
    S = A @ S @ np.linalg.inv(A)
    w = rng.standard_normal((30, 3))
    got = tcheb.cheb_matvec(lambda v: S @ v, t, w)
    assert _rel(got, jcheb.cheb_matvec(lambda v: S @ v, j, w)) <= 1e-10


def test_chebyshev_covariance_apply_matches_jax(sphere):
    _, L, M, comp, _ = sphere
    w = np.random.default_rng(1).standard_normal(L.shape[0])
    lam_max = float(comp.freqs.max() ** 2)
    for gamma_t, gamma_j in (
            (tcov.squared_exponential_density(0.1),
             jcov.squared_exponential_density(0.1)),
            (tcov.matern_density(0.5, 2.0), jcov.matern_density(0.5, 2.0))):
        lam = np.linspace(0.0, lam_max, 7)
        np.testing.assert_array_equal(gamma_t(lam), gamma_j(lam))
        got = tcov.chebyshev_covariance_apply(L, M, gamma_t, w, lam_max, 64)
        want = jcov.chebyshev_covariance_apply(L, M, gamma_j, w, lam_max, 64)
        assert _rel(got, want) <= 1e-10


def test_compressed_covariance_on_the_carried_basis_matches_jax(sphere):
    """`lbo_compression_from_numpy` carries the JAX compression (same
    operators, freqs, perm, bytes); both packages' apply and sample on it
    agree to 1e-10, for one and for several right-hand sides."""
    _, L, M, comp, tcomp = sphere
    np.testing.assert_array_equal(tcomp.freqs, comp.freqs)
    np.testing.assert_array_equal(tcomp.row_tree.perm, comp.row_tree.perm)
    assert tcomp.compressed_bytes == comp.compressed_bytes
    assert tcomp.compression_rate == comp.compression_rate
    assert [(n.i0, n.i1) for n in tcomp.fac.row_nodes] == [
        (n.i0, n.i1) for n in comp.fac.row_nodes]
    np.testing.assert_array_equal(tcomp.col_tree.perm, comp.col_tree.perm)
    tc, jc = tcov.CompressedCovariance(tcomp), jcov.CompressedCovariance(comp)
    gt = tcov.squared_exponential_density(0.1)
    gj = jcov.squared_exponential_density(0.1)
    rng = np.random.default_rng(2)
    n, k = L.shape[0], comp.freqs.size
    for w in (rng.standard_normal(n), rng.standard_normal((n, 3))):
        assert _rel(tc.apply(gt, w), jc.apply(gj, w)) <= 1e-10
    for om in (rng.standard_normal(k), rng.standard_normal((k, 2))):
        assert _rel(tc.sample(gt, om), jc.sample(gj, om)) <= 1e-10
    # the apply is the covariance of the compressed basis: C = Phi g Phi^T
    Phi = np.empty((n, k))
    Phi[comp.row_tree.perm] = comp.fac.as_linop().materialize()
    w = rng.standard_normal(n)
    want = Phi @ (gj(comp.freqs ** 2) * (Phi.T @ w))
    assert _rel(tc.apply(gt, w), want) <= 1e-10


def test_covariance_twin_matches_the_jax_arithmetic(sphere):
    """The covariance twin at its defaults (icosphere(2), tol 1e-8, order
    96, kappa 0.1) and with the device eigensolver (float64 on the CPU):
    its fast-vs-Chebyshev difference equals that of the JAX example's
    arithmetic on the JAX compression."""
    mesh, L, M, comp, _ = sphere
    rec = twin_cov.main([])
    dev = twin_cov.main(["--eigensolver", "device", "--device", "cpu"])
    assert rec["eigenpairs"] == comp.freqs.size
    gamma = jcov.squared_exponential_density(0.1)
    rng = np.random.default_rng(0)
    w = rng.standard_normal(mesh.num_verts)
    fast = jcov.CompressedCovariance(comp).apply(gamma, np.asarray(M @ w))
    cheb = jcov.chebyshev_covariance_apply(L, M, gamma, w,
                                           float(comp.freqs.max() ** 2),
                                           order=96)
    want = _rel(fast, cheb)
    assert abs(rec["rel_diff_fast_vs_cheb"] - want) <= 1e-9
    assert dev["rel_diff_fast_vs_cheb"] <= 2 * want
    assert np.isfinite(rec["sample_std"]) and rec["sample_std"] > 0
