"""The whole slice against the JAX package: streamed factorization ->
distillation to FFT form -> fused apply.

Both packages stream the same DCT matrix (the spec of
`tests/test_distill.py`) through their own `FacStreamer`, distill the
result on the host in float64 with the same NumPy LAPACK, and apply it
through their fused plan (JAX: K1 in Pallas interpret mode; port: the plain
pass a CPU tensor takes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from butterfly_tpu.config import FacSpec as JaxFacSpec
from butterfly_tpu.fac.distill import distill_butterfly as jax_distill
from butterfly_tpu.fac.streamer import FacStreamer as JaxFacStreamer
from butterfly_tpu.fac.uniformize import uniformize_fused as jax_uniformize
from butterfly_tpu.trees import uniform_tree as jax_uniform_tree
from butterfly_tpu_torch.config import FacSpec
from butterfly_tpu_torch.convert import distilled_from_numpy
from butterfly_tpu_torch.fac.distill import distill_butterfly
from butterfly_tpu_torch.fac.streamer import FacStreamer
from butterfly_tpu_torch.fac.uniformize import uniformize_fused
from butterfly_tpu_torch.trees import uniform_tree

N, M = 1024, 512


def _fourier(n, m):
    x = (np.arange(n) + 0.5) / n
    k = np.arange(m)
    return np.cos(np.pi * np.outer(x, k)) * np.sqrt(2.0 / n)


def _stream(spec_cls, streamer_cls, tree_fn, Phi):
    spec = spec_cls(
        row_tree=tree_fn(N, 2, 5),
        col_tree=tree_fn(M, 2, 3),
        row_tree_init_depth=2,
        tol=1e-9,
        min_num_rows=8,
        min_num_cols=8,
    )
    st = streamer_cls(spec)
    for leaf in spec.col_tree.nodes_at_depth(3):
        if leaf.num_points:
            st.feed(Phi[:, leaf.i0:leaf.i1])
    return st.get_fac()


@pytest.fixture(scope="module")
def facs():
    Phi = _fourier(N, M)
    jfac = _stream(JaxFacSpec, JaxFacStreamer, jax_uniform_tree, Phi)
    tfac = _stream(FacSpec, FacStreamer, uniform_tree, Phi)
    return Phi, jfac, tfac


def test_streamed_facs_agree(facs):
    Phi, jfac, tfac = facs
    assert [(n.i0, n.i1) for n in tfac.row_nodes] == [
        (n.i0, n.i1) for n in jfac.row_nodes]
    x = np.random.default_rng(0).standard_normal((M, 3))
    yj = jfac.as_linop().matmat(x)
    yt = tfac.as_linop().matmat(x)
    assert np.linalg.norm(yt - yj) <= 1e-12 * np.linalg.norm(yj)
    assert np.linalg.norm(yt - Phi @ x) <= 1e-6 * np.linalg.norm(Phi @ x)


def test_distilled_weights_agree_f64(facs):
    Phi, jfac, tfac = facs
    dj = jax_distill(jfac.as_linop(), 16, rank=None, tol=1e-7,
                     dtype=np.float64)
    dt = distill_butterfly(tfac.as_linop(), 16, rank=None, tol=1e-7,
                           dtype=torch.float64, device="cpu")
    assert dt.rank == dj.rank
    np.testing.assert_array_equal(dt.row_perm, dj.row_perm)
    pairs = [(dt.bf.leaf, dj.bf.leaf)] + list(zip(dt.bf.levels,
                                                  dj.bf.levels))
    for t, j in pairs:
        t, j = t.numpy(), np.asarray(j)
        assert t.shape == j.shape
        assert np.abs(t - j).max() <= 1e-10 * max(np.abs(j).max(), 1.0)
    assert dt.max_sv_discarded == pytest.approx(dj.max_sv_discarded,
                                                rel=1e-8, abs=1e-14)
    assert dt.bf.precision == "highest"
    # the JAX result carried across applies the same operator
    dc = distilled_from_numpy(
        np.asarray(dj.bf.leaf), [np.asarray(W) for W in dj.bf.levels],
        dj.row_perm, dj.rank, dj.max_sv_discarded, dj.sigma_max,
        device="cpu")
    x = np.random.default_rng(4).standard_normal((M, 3))
    want = np.asarray(dj.apply(jnp.asarray(x)))
    assert np.abs(dc.apply(torch.from_numpy(x)).numpy() - want).max() <= (
        1e-12 * np.abs(want).max())
    # canonical row order reproduces the dense product
    yc = dt.apply_canonical(torch.from_numpy(x)).numpy()
    assert np.linalg.norm(yc - Phi @ x) <= 1e-6 * np.linalg.norm(Phi @ x)


def test_uniformize_fused_apply_matches_jax(facs):
    Phi, jfac, tfac = facs
    jfp = jax_uniformize(jfac, tol=1e-7, dtype=np.float32, r_tile=128,
                         interpret=True)
    tfp = uniformize_fused(tfac, tol=1e-7, dtype=torch.float32,
                           device="cpu")
    assert tfp.rank == jfp.rank and tfp.shape == jfp.shape
    np.testing.assert_array_equal(tfp.dist.row_perm, jfp.dist.row_perm)
    x = np.random.default_rng(3).standard_normal((M, 8)).astype(np.float32)
    yj = np.asarray(jfp.apply(jnp.asarray(x)), np.float64)
    yt = tfp.apply(torch.from_numpy(x))
    assert yt.dtype == torch.float32
    yt = yt.double().numpy()
    assert np.linalg.norm(yt - yj) <= 1e-5 * np.linalg.norm(yj)
    want = Phi @ x.astype(np.float64)
    for y in (yt, yj):  # the reference's own bound, tests/test_distill.py
        assert np.linalg.norm(y - want) <= 2e-4 * np.linalg.norm(want)
    yb = tfp.apply_butterfly_order(torch.from_numpy(x)).double().numpy()
    np.testing.assert_array_equal(yb, yt[tfp.dist.row_perm])
