"""The port's Helmholtz host layers against the JAX package's: the
quadtree, the kernel assembly, the multilevel factorization (host
float64) and the packed stage plan (`pack(...).materialize()`).

Both packages get the same numpy points; the factorizations run in each
package's own copy of the host code, and the port's stage plan applies on
the CPU (the JAX one through XLA on the CPU).
"""

import numpy as np
import pytest
import torch

from butterfly_tpu.fac import helm2 as jax_fac_helm2
from butterfly_tpu.geom import Ellipse as JaxEllipse
from butterfly_tpu.ops import linop as JL
from butterfly_tpu.ops.helm2 import Helm2 as JaxHelm2
from butterfly_tpu.ops.helm2 import LayerPot as JaxLayerPot
from butterfly_tpu.ops.packed import pack as jax_pack
from butterfly_tpu.trees import Quadtree as JaxQuadtree
from butterfly_tpu_torch.convert import linop_from_numpy
from butterfly_tpu_torch.fac import helm2 as fac_helm2
from butterfly_tpu_torch.geom import Ellipse
from butterfly_tpu_torch.ops.helm2 import Helm2, LayerPot
from butterfly_tpu_torch.ops.packed import pack
from butterfly_tpu_torch.trees import Quadtree


def _points(n):
    X, _, Nrm, _ = Ellipse(1.0, 0.7, (0.0, 0.0), 0.3).sample_linspaced(n)
    Xj, _, Nj, _ = JaxEllipse(1.0, 0.7, (0.0, 0.0), 0.3).sample_linspaced(n)
    np.testing.assert_array_equal(X, Xj)
    np.testing.assert_array_equal(Nrm, Nj)
    return X, Nrm


def _nodes(tree):
    return [(n.depth, n.i0, n.i1) for n in tree.root.subtree_nodes()]


@pytest.fixture(scope="module")
def trees():
    X, Nrm = _points(2048)
    return (X, Nrm, Quadtree(X, leaf_size=32, normals=Nrm),
            JaxQuadtree(X, leaf_size=32, normals=Nrm))


def test_quadtree_matches_jax(trees):
    X, Nrm, t, j = trees
    np.testing.assert_array_equal(t.perm, j.perm)
    assert _nodes(t) == _nodes(j)
    for a, b in zip(t.root.subtree_nodes(), j.root.subtree_nodes()):
        np.testing.assert_array_equal(a.bbox.lo, b.bbox.lo)
        np.testing.assert_array_equal(a.bbox.hi, b.bbox.hi)


@pytest.mark.parametrize("lp", ["SINGLE", "PV_DOUBLE", "COMBINED_FIELD"])
def test_kernels_and_reexpansion_match_jax(lp):
    rng = np.random.default_rng(0)
    h = Helm2(k=30.0, layer_pot=LayerPot[lp], alpha=1.0, beta=0.5j)
    hj = JaxHelm2(k=30.0, layer_pot=JaxLayerPot[lp], alpha=1.0, beta=0.5j)
    src, tgt = rng.standard_normal((40, 2)), rng.standard_normal((30, 2)) + 4
    nrm = rng.standard_normal((40, 2))
    want = hj.kernel_matrix(src, tgt, nrm)
    assert np.abs(h.kernel_matrix(src, tgt, nrm) - want).max() <= (
        1e-12 * np.abs(want).max())
    B = 3
    so, se = rng.standard_normal((B, 24, 2)), rng.standard_normal((B, 16, 2))
    tg = rng.standard_normal((B, 16, 2)) + 5
    no, ne = rng.standard_normal((B, 24, 2)), rng.standard_normal((B, 16, 2))
    want = hj.reexpansion_matrices_batched(so, se, tg, no, ne)
    got = h.reexpansion_matrices_batched(so, se, tg, no, ne)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_make_multilevel_matches_jax():
    X, Nrm = _points(512)
    A = fac_helm2.make_multilevel(
        Helm2(k=30.0, layer_pot=LayerPot.SINGLE),
        *[Quadtree(X, leaf_size=32, normals=Nrm)] * 2)
    Aj = jax_fac_helm2.make_multilevel(
        JaxHelm2(k=30.0, layer_pot=JaxLayerPot.SINGLE),
        *[JaxQuadtree(X, leaf_size=32, normals=Nrm)] * 2)
    Dj = Aj.materialize()
    assert np.abs(A.materialize() - Dj).max() <= 1e-12 * np.abs(Dj).max()


def test_make_multilevel_butterflies_match_jax(trees):
    """At 2048 points and k=40 the partition holds separated blocks, each a
    butterfly Product of BlockDiag/BlockCoo factors; both operators act the
    same, and the JAX one carried across acts the same again."""
    X, Nrm, t, j = trees
    A = fac_helm2.make_multilevel(Helm2(k=40.0), t, t)
    Aj = jax_fac_helm2.make_multilevel(JaxHelm2(k=40.0), j, j)
    rng = np.random.default_rng(1)
    z = rng.standard_normal((2048, 3)) + 1j * rng.standard_normal((2048, 3))
    want = Aj.matmat(z)
    for op in (A, linop_from_numpy(Aj)):
        assert np.linalg.norm(op.matmat(z) - want) <= (
            1e-12 * np.linalg.norm(want))


@pytest.fixture(scope="module")
def butterfly_block(trees):
    """One separated block's butterfly (a 4-factor Product) and a real
    operator built from every other node kind the packed planner reads."""
    X, Nrm, _, j = trees
    nodes = j.nodes_at_depth(2)
    src = next(n for n in nodes if n.is_separated_from(nodes[0]))
    Bj = jax_fac_helm2.make_single(JaxHelm2(k=40.0), j, j, src, nodes[0])
    assert isinstance(Bj, JL.Product) and len(Bj.factors) > 2
    rng = np.random.default_rng(2)
    n = 96
    Rj = JL.Sum([
        JL.Scaled(0.5, JL.Dense(rng.standard_normal((n, n)))),
        JL.Product([JL.Dense(rng.standard_normal((n, n))),
                    JL.Perm(rng.permutation(n))]),
        JL.Diff(JL.Identity(n), JL.Diag(rng.standard_normal(n))),
        JL.BlockDiag([JL.Dense(rng.standard_normal((32, 32))),
                      JL.Zero((64, 64))]),
    ])
    return Bj, Rj


@pytest.mark.parametrize("which", ["complex", "complex real_embed", "real"])
def test_pack_materialize_matches_jax(butterfly_block, which):
    Bj, Rj = butterfly_block
    opj = Rj if which == "real" else Bj
    embed = which == "complex real_embed"
    want = np.asarray(jax_pack(opj, real_embed=embed).materialize())
    plan = pack(linop_from_numpy(opj), real_embed=embed, device="cpu")
    got = plan.materialize()
    assert got.dtype == (np.float32 if which == "real" else np.complex64)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    dense = opj.materialize()
    assert np.abs(got - dense).max() <= 1e-5 * np.abs(dense).max()
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        opj.shape[1]).astype(np.float32))
    y = plan(x)
    assert y.shape == (opj.shape[0],)
    assert np.abs(y.numpy() - got @ x.numpy()).max() <= (
        1e-5 * np.abs(got).max() * np.abs(x.numpy()).sum())


@pytest.mark.parametrize("which", ["complex real_embed", "real"])
def test_pack_chains_splits_the_operator(butterfly_block, which):
    """`pack(op, chains=...)` packs only those positioned chains of op: two
    plans over complementary halves of its chains sum to the plan of the
    whole operator."""
    from butterfly_tpu_torch.ops.packed import _flatten

    Bj, Rj = butterfly_block
    op = linop_from_numpy(Rj if which == "real" else Bj)
    embed = which == "complex real_embed"
    chains: list = []
    _flatten(op, 0, 0, chains)
    if len(chains) == 1:
        # the butterfly is one chain: each half packs it once, and the
        # halves sum to twice the operator
        chains = chains + chains
        halves = (chains[:1], chains[1:])
        want = 2 * pack(op, real_embed=embed, device="cpu").materialize()
    else:
        k = len(chains) // 2
        halves = (chains[:k], chains[k:])
        want = pack(op, real_embed=embed, device="cpu").materialize()
    got = sum(pack(op, real_embed=embed, device="cpu",
                   chains=h).materialize() for h in halves)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
