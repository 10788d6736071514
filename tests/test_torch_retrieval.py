"""The port's retrieval (models/retrieval.py, the entry point and the two
example twins) against the JAX package's.

Both packages get the same seeded numpy tables and queries. The host parts
(batched SVD, PCA tree order, recall measures) are the same NumPy code, so
factors, permutations and recalls must be identical; the device parts
(scoring, lookup, top-k, the packed deep plan, the fused plan) are IEEE
float32 in both on the CPU, so they agree to rounding: rel 1e-6 for the
one-level products and the training step, 1e-5 for the deep and fused
applies (other summation orders through several stages). The JAX fused
plan runs K1 in Pallas interpret mode; the port's runs its plain passes.
Tables have no near-ties at the top-100 cutoff (`torch.topk` and
`lax.top_k` break ties differently), so top-100 sets must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from butterfly_tpu.fac.distill import distill_butterfly as jax_distill
from butterfly_tpu.fac.uniformize import (
    choose_block_align as jax_choose_block_align,
)
from butterfly_tpu.fac.uniformize import fac_block_stats as jax_block_stats
from butterfly_tpu.models import retrieval as jr
from butterfly_tpu.ops.pallas_butterfly import (
    FusedButterflyPlan as JaxFusedPlan,
)
from butterfly_tpu_torch.convert import (
    compressed_table_from_numpy,
    uniform_butterfly_from_numpy,
)
from butterfly_tpu_torch.entry import entry
from butterfly_tpu_torch.examples import retrieval as twin_retrieval
from butterfly_tpu_torch.examples import retrieval_lbo as twin_lbo
from butterfly_tpu_torch.fac.distill import distill_butterfly
from butterfly_tpu_torch.fac.uniformize import (
    choose_block_align,
    fac_block_stats,
)
from butterfly_tpu_torch.models import retrieval as tr
from butterfly_tpu_torch.ops.fused_butterfly import FusedButterflyPlan


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch and one BLAS thread while this module runs: the suite runs
    several workers at once, and a pool of a thread per core in each of
    them oversubscribes the cores until small products stall."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(n)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _smooth_table(n, d, rng, latent=8):
    """tests/test_retrieval.py's table: rows are smooth functions of a
    latent coordinate plus 1e-3 noise (no near-ties at the cutoff)."""
    z = np.sort(rng.random(n))
    freqs = rng.standard_normal((latent, d))
    phases = rng.random((latent, 1)) * 2 * np.pi
    comps = np.stack([np.cos(2 * np.pi * (j + 1) * z + phases[j, 0])
                      for j in range(latent)])
    return (comps.T @ freqs) + 0.001 * rng.standard_normal((n, d))


def _same_sets(a, b):
    return all(set(x.tolist()) == set(y.tolist()) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def table():
    return _smooth_table(2048, 64, np.random.default_rng(0))


@pytest.fixture(scope="module")
def tables(table):
    """Both packages' one-level tables of one table at rank 16, and eight
    queries."""
    q = np.random.default_rng(3).standard_normal((8, 64)).astype(np.float32)
    return (jr.compress_table(table, rank=16, block_rows=128),
            tr.compress_table(table, rank=16, block_rows=128, device="cpu"),
            q)


def test_compress_table_factors_are_identical(tables):
    jct, tct, _ = tables
    np.testing.assert_array_equal(tct.Psi.detach().numpy(),
                                  np.asarray(jct.Psi))
    np.testing.assert_array_equal(tct.V.detach().numpy(), np.asarray(jct.V))
    assert (tct.num_rows, tct.dim, tct.rank, tct.nbytes()) == (
        jct.num_rows, jct.dim, jct.rank, jct.nbytes())


def test_tree_order_rows_is_identical():
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((32, 64))
    t = centers[rng.integers(0, 32, 4096)] + 0.05 * rng.standard_normal(
        (4096, 64))
    np.testing.assert_array_equal(tr.tree_order_rows(t, leaf_size=128),
                                  jr.tree_order_rows(t, leaf_size=128))


def test_score_lookup_materialize_match_jax(tables):
    jct, tct, q = tables
    ids = np.random.default_rng(1).integers(0, jct.num_rows, 50)
    with torch.no_grad():
        assert _rel(tct.score(torch.from_numpy(q)), jct.score(q)) <= 1e-6
        assert _rel(tct.lookup(torch.from_numpy(ids)),
                    jct.lookup(jnp.asarray(ids))) <= 1e-6
        assert _rel(tct.materialize(), jct.materialize()) <= 1e-6
        assert _rel(tct(torch.from_numpy(q)), jct.score(q)) <= 1e-6


def test_topk_sets_and_recalls_equal_jax(table, tables):
    jct, tct, q = tables
    _, jidx = jct.topk(q, 100)
    with torch.no_grad():
        tvals, tidx = tct.topk(torch.from_numpy(q), 100, approx=True)
    jidx, tidx = np.asarray(jidx), tidx.numpy()
    assert tidx.shape == (8, 100) and tvals.shape == (8, 100)
    assert _same_sets(tidx, jidx)
    true_idx = jr.exact_topk(table, q, 100)
    np.testing.assert_array_equal(tr.exact_topk(table, q, 100), true_idx)
    true_scores = q @ table.T
    assert tr.recall_at_k(tidx, true_idx) == jr.recall_at_k(jidx, true_idx)
    assert (tr.recall_with_tolerance(tidx, true_scores, 100)
            == jr.recall_with_tolerance(jidx, true_scores, 100))
    assert tr.recall_at_k(tidx, true_idx) > 0.97


def test_train_step_matches_jax(table):
    jct = jr.compress_table(table, rank=8, block_rows=128)
    tct = tr.compress_table(table, rank=8, block_rows=128, device="cpu")
    ids = np.random.default_rng(4).integers(0, table.shape[0], 256)
    rows = table[ids].astype(np.float32)
    psi0 = tct.Psi.detach().clone()
    for _ in range(3):
        jct, jl = jr.train_step(jct, jnp.asarray(rows), jnp.asarray(ids),
                                lr=1e-2)
        tct, tl = tr.train_step(tct, torch.from_numpy(rows),
                                torch.from_numpy(ids), lr=1e-2)
        assert abs(float(tl) - float(jl)) <= 1e-6 * abs(float(jl))
    assert _rel(tct.Psi.detach(), jct.Psi) <= 1e-6
    assert _rel(tct.V.detach(), jct.V) <= 1e-6
    assert not torch.equal(tct.Psi.detach(), psi0)


def _scaled_dct(n, d):
    """retrieval_lbo.py's synthetic table at n x d, rows scaled to unit
    RMS, and 16 unit queries."""
    x = (np.arange(n) + 0.5) / n
    Phi = (np.cos(np.pi * np.outer(x, np.arange(d)))
           * np.sqrt(2.0 / n)).astype(np.float32)
    Phi *= np.sqrt(n / np.linalg.norm(Phi) ** 2) * np.sqrt(d)
    Q = np.random.default_rng(0).standard_normal((16, d)).astype(np.float32)
    Q /= np.linalg.norm(Q, axis=1, keepdims=True)
    return Phi, Q


@pytest.fixture(scope="module")
def deep_tables():
    """Both packages' deep tables of a 1024 x 128 DCT table (tol 1e-3,
    col_depth 3, leaf 128: the synthetic path's settings)."""
    Phi, Q = _scaled_dct(1024, 128)
    jdt = jr.compress_table_deep(Phi, tol=1e-3, col_depth=3, row_leaf=128)
    tdt = tr.compress_table_deep(Phi, tol=1e-3, col_depth=3, row_leaf=128,
                                 device="cpu")
    return Phi, Q, jdt, tdt


def test_choose_block_align_matches_jax(deep_tables):
    _, _, jdt, tdt = deep_tables
    ja, jests = jax_choose_block_align(jdt.fac)
    ta, tests_ = choose_block_align(tdt.fac)
    assert ta == ja
    assert [vars(e) for e in tests_] == [vars(e) for e in jests]
    assert fac_block_stats(tdt.fac) == jax_block_stats(jdt.fac)


def test_deep_table_scores_and_topk_match_jax(deep_tables):
    Phi, Q, jdt, tdt = deep_tables
    # the padded device sizes differ: the port's pack pads every unit to
    # its own tile, where the JAX package's also tiles for the TPU
    assert tdt.nbytes_logical() == jdt.nbytes_logical()
    assert _rel(tdt.score(Q), jdt.score(Q)) <= 1e-5
    assert _rel(tdt.materialize(), jdt.materialize()) <= 1e-12
    _, jidx = jdt.topk(Q, 100)
    _, tidx = tdt.topk(Q, 100)
    assert _same_sets(tidx.numpy(), np.asarray(jidx))
    true_idx = jr.exact_topk(Phi, Q, 100)
    assert tr.recall_at_k(tidx.numpy(), true_idx) > 0.97


def test_deep_fused_top100_ids_match_jax(deep_tables):
    """The deep_fused format: the deep fac distilled to NB=16 at rank 72,
    scored through each package's fused plan, ids mapped back to table rows
    through row_perm."""
    Phi, Q, jdt, tdt = deep_tables
    jdist = jax_distill(jdt.fac.as_linop(), 16, rank=72, dtype=np.float32)
    tdist = distill_butterfly(tdt.fac.as_linop(), 16, rank=72,
                              dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(tdist.row_perm, jdist.row_perm)
    jplan = JaxFusedPlan(jdist.bf, fuse=8, r_tile=256, interpret=True)
    tplan = FusedButterflyPlan(tdist.bf, fuse=8, device="cpu")
    js = np.asarray(jplan.apply(jnp.asarray(Q.T)))
    ts = tplan.apply_plain(torch.from_numpy(Q.T.copy()))
    assert _rel(ts, js) <= 1e-5
    jids = jdist.row_perm[np.asarray(jax.lax.top_k(js.T, 100)[1])]
    tids = tdist.row_perm[torch.topk(ts.T, 100).indices.numpy()]
    assert _same_sets(tids, jids)
    assert tr.recall_at_k(tids, jr.exact_topk(Phi, Q, 100)) > 0.97


def test_entry_matches_jax_with_its_weights():
    from __graft_entry__ import entry as jax_entry

    jfn, (jct, jbf, jq) = jax_entry()
    jvals, jidx = jax.jit(jfn)(jct, jbf, jq)
    forward, (ct, bf, q) = entry(device="cpu")
    assert ct.Psi.shape == jct.Psi.shape and bf.NB == jbf.NB
    assert q.shape == jq.shape
    ct = compressed_table_from_numpy(np.asarray(jct.Psi), np.asarray(jct.V),
                                     device="cpu")
    bf = uniform_butterfly_from_numpy(np.asarray(jbf.leaf),
                                      [np.asarray(W) for W in jbf.levels],
                                      device="cpu")
    with torch.no_grad():
        vals, idx = forward(ct, bf, torch.from_numpy(np.array(jq)))
    assert _same_sets(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=1e-5,
                               atol=1e-5 * float(np.abs(jvals).max()))


def test_twins_run_on_the_cpu():
    """CPU smoke runs of both twins at small sizes: every format's row,
    recall near 1 on these tables, and no time reported off the card."""
    one = twin_retrieval.main(["--n", "8192", "--device", "cpu"])
    deep = twin_retrieval.main(["--deep", "--n", "1024", "--device", "cpu"])
    assert one["recall_at_100_strict"] > 0.97
    assert deep["recall_at_100_strict"] > 0.97
    assert one["queries_per_s"] is None and deep["queries_per_s"] is None
    rows = twin_lbo.main(["--synthetic", "--queries", "32", "--device",
                          "cpu"])
    assert [r["format"] for r in rows] == ["one_level", "deep_butterfly",
                                           "deep_fused"]
    assert rows[2]["rank"] == 80
    assert all(r["recall_at_100_strict"] > 0.97 for r in rows)
    rows = twin_lbo.main(["--config1m", "--rows", "16384", "--queries",
                          "32", "--device", "cpu"])
    assert [r["format"] for r in rows] == ["one_level_1m",
                                           "one_level_1m_rerank", "deep_1m"]
    assert rows[0]["rank"] == 32 and rows[0]["compression_ratio"] == 0.5
    assert rows[0]["lookup_rel_err_vs_f64"] <= 1e-6
    assert rows[0]["score_rel_err_vs_f64"] <= 1e-6
    assert rows[0]["recall_at_100_tol1e-3"] >= 0.99
    assert rows[1]["recall_at_100_strict"] >= rows[0]["recall_at_100_strict"]
    assert all(r["queries_per_s"] is None for r in rows)
    # without --synthetic or --config1m: the LBO eigenvector table
    # (icosphere(7) x 1024 by default; tests/test_torch_lbo.py runs its
    # three formats at icosphere(3))
    args = twin_lbo.parse_args([])
    assert (args.subdiv, args.num_eigs, args.phi) == (7, 1024, None)
    rows = twin_lbo.main(["--subdiv", "2", "--num-eigs", "32",
                          "--formats", "one_level", "--rank-one-level",
                          "32", "--queries", "32", "--device", "cpu"])
    assert [(r["format"], r["n"], r["d"], r["table"]) for r in rows] == [
        ("one_level", 162, 32, "lbo icosphere(2)")]
    # the sphere's symmetry ties scores: strict recall depends on the order
    # ties are broken in, tolerance recall does not
    assert rows[0]["eigsh_s"] > 0 and rows[0]["recall_at_100_tol1e-3"] >= 0.99
