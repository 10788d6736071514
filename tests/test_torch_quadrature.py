"""Kapur-Rokhlin quadrature, `Coo` and Poisson-disk sampling against the
JAX package.

Both packages get the same S' kernel (`kernel_ij` of the JAX package's
`Helm2` on one ellipse) and the same permutation; the corrections are
compared entry by entry, the correctors by their tables and applies, and
the Poisson-disk samples for the same seed must be identical.
"""

import numpy as np
import pytest
import torch

from butterfly_tpu.geom import Ellipse as JaxEllipse
from butterfly_tpu.geom import sample_poisson_disk as jax_poisson
from butterfly_tpu.ops import quadrature as JQ
from butterfly_tpu.ops.helm2 import Helm2 as JaxHelm2
from butterfly_tpu.ops.helm2 import LayerPot as JaxLayerPot
from butterfly_tpu.ops.linop import Coo as JaxCoo
from butterfly_tpu_torch.convert import (
    kr_corrector_from_numpy,
    linop_from_numpy,
)
from butterfly_tpu_torch.geom import sample_poisson_disk
from butterfly_tpu_torch.ops import quadrature as Q
from butterfly_tpu_torch.ops.linop import Coo

N = 384
OFFSETS = [0, 128, 256, 384]


@pytest.fixture(scope="module")
def sprime():
    """kernel_ij of S' on 384 points of the helm2_bie ellipse (k=10), and
    a fixed permutation standing in for a tree order."""
    X, _, Nrm, _ = JaxEllipse(1.0, 0.6, (0.0, 0.0), 0.1).sample_linspaced(N)
    helm = JaxHelm2(k=10.0, layer_pot=JaxLayerPot.PV_NORMAL_DERIV_SINGLE)

    def kernel_ij(i, j):
        return helm.kernel_matrix(X[j:j + 1], X[i:i + 1], None,
                                  Nrm[i:i + 1])[0, 0]

    return kernel_ij, np.random.default_rng(3).permutation(N)


def _same_coo(got, want):
    assert isinstance(got, Coo) and got.shape == tuple(want.shape)
    np.testing.assert_array_equal(got.row_inds, want.row_inds)
    np.testing.assert_array_equal(got.col_inds, want.col_inds)
    np.testing.assert_allclose(got.values, want.values, rtol=1e-12, atol=0)
    np.testing.assert_allclose(got.materialize(), want.materialize(),
                               rtol=0, atol=1e-12 * np.abs(want.values).max())


def test_kr_weights_equal():
    assert set(Q.KR_WEIGHTS) == set(JQ.KR_WEIGHTS) == {2, 6, 10}
    for order, w in JQ.KR_WEIGHTS.items():
        np.testing.assert_array_equal(Q.KR_WEIGHTS[order], w)


@pytest.mark.parametrize("permuted", [False, True],
                         ids=["original", "tree_order"])
def test_kr_corrections_match_jax(sprime, permuted):
    kernel_ij, perm = sprime
    p = perm if permuted else None
    _same_coo(Q.kr_correction(6, N, kernel_ij, perm=p),
              JQ.kr_correction(6, N, kernel_ij, perm=p))
    _same_coo(Q.kr_block_correction(6, N, OFFSETS, kernel_ij, perm=p),
              JQ.kr_block_correction(6, N, OFFSETS, kernel_ij, perm=p))
    for offsets in (None, OFFSETS):
        got = Q.kr_accum_correction(6, N, kernel_ij, offsets=offsets, perm=p)
        want = JQ.kr_accum_correction(6, N, kernel_ij, offsets=offsets,
                                      perm=p)
        np.testing.assert_array_equal(got.idx, want.idx)
        np.testing.assert_allclose(got.coef, want.coef, rtol=1e-12, atol=0)
        # the accumulate form is the explicit correction's action
        x = np.random.default_rng(0).standard_normal((N, 3)) + 0j
        explicit = (Q.kr_correction(6, N, kernel_ij, perm=p)
                    if offsets is None
                    else Q.kr_block_correction(6, N, offsets, kernel_ij,
                                               perm=p))
        np.testing.assert_allclose(got.apply(x), explicit.matmat(x),
                                   rtol=0, atol=1e-12 * np.abs(got.coef).max())
        carried = kr_corrector_from_numpy(want)
        np.testing.assert_array_equal(carried.apply(x), want.apply(x))


def test_kr_rejects_bad_orders_and_offsets(sprime):
    kernel_ij, _ = sprime
    from butterfly_tpu_torch.utils.errors import InvalidArgumentsError

    with pytest.raises(InvalidArgumentsError):
        Q.kr_correction(4, N, kernel_ij)
    with pytest.raises(InvalidArgumentsError):
        Q.kr_block_correction(6, N, [0, 10, N], kernel_ij)
    with pytest.raises(InvalidArgumentsError):
        Q.kr_accum_correction(6, N, kernel_ij, offsets=[0, 200, 100])


def test_coo_matches_jax():
    rng = np.random.default_rng(1)
    n, m, nnz = 40, 30, 120
    rows, cols = rng.integers(0, n, nnz), rng.integers(0, m, nnz)
    vals = rng.standard_normal(nnz) + 1j * rng.standard_normal(nnz)
    got, want = Coo((n, m), rows, cols, vals), JaxCoo((n, m), rows, cols,
                                                      vals)
    X = rng.standard_normal((m, 4)) + 1j * rng.standard_normal((m, 4))
    Y = rng.standard_normal((n, 4)) + 1j * rng.standard_normal((n, 4))
    tol = dict(rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.matmat(X), want.matmat(X), **tol)
    np.testing.assert_allclose(got.rmatmat(Y), want.rmatmat(Y), **tol)
    np.testing.assert_allclose(got.materialize(), want.materialize(), **tol)
    np.testing.assert_allclose(got.adjoint().matmat(Y),
                               want.adjoint().matmat(Y), **tol)
    np.testing.assert_allclose(got.transpose().materialize(),
                               want.materialize().T, **tol)
    assert got.nbytes() == want.nbytes()
    sq = np.abs(rows) % m
    perm = rng.permutation(m)
    got_sq, want_sq = Coo((m, m), sq, cols, vals), JaxCoo((m, m), sq, cols,
                                                          vals)
    np.testing.assert_allclose(got_sq.permuted(perm).materialize(),
                               want_sq.permuted(perm).materialize(), **tol)
    carried = linop_from_numpy(want)
    assert isinstance(carried, Coo)
    np.testing.assert_array_equal(carried.matmat(X), want.matmat(X))


@pytest.mark.parametrize("r", [None, 5], ids=["vector", "r5"])
def test_accum_apply_on_interleaved_tensor(sprime, r):
    """The corrector's tensor apply (complex64 tables on the tensor's
    device) against its complex numpy apply."""
    kernel_ij, perm = sprime
    corr = Q.kr_accum_correction(6, N, kernel_ij, offsets=OFFSETS, perm=perm)
    rng = np.random.default_rng(2)
    shape = (N,) if r is None else (N, r)
    z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    x = np.empty((2 * N,) + shape[1:], np.float32)
    x[0::2], x[1::2] = z.real, z.imag
    y = corr.apply(torch.from_numpy(x))
    assert y.dtype == torch.float32 and tuple(y.shape) == x.shape
    y = y.double().numpy()
    want = corr.apply(z)
    got = y[0::2] + 1j * y[1::2]
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-6


def test_poisson_disk_samples_are_identical():
    got = sample_poisson_disk((0, 0), (1, 1), 0.45,
                              rng=np.random.default_rng(5))
    want = jax_poisson((0, 0), (1, 1), 0.45, rng=np.random.default_rng(5))
    assert got.shape == want.shape and got.shape[0] >= 3
    assert np.array_equal(got, want)
    got = sample_poisson_disk((-1, 0), (2, 1.5), 0.1,
                              rng=np.random.default_rng(11))
    want = jax_poisson((-1, 0), (2, 1.5), 0.1, rng=np.random.default_rng(11))
    assert np.array_equal(got, want)
    d = np.hypot(*(got[:, None, :] - got[None, :, :]).transpose(2, 0, 1))
    assert d[np.triu_indices(len(got), 1)].min() >= 0.1
