"""The port's leftovers (io/serialization.py, utils/profiling.py,
ops/eval_tree.py and its twin, the rest of ops/linop.py) against the JAX
package's.

Files cross between the packages both ways: a LinOp saved by one loads in
the other with matvecs to 1e-12 (host float64 in both), a butterfly or
retrieval table saved by the JAX package loads in the port and applies to
1e-6 (float32), and a streamer checkpoint resumes in either. The
EvalTree's leaf edges are the same host code in both and are held equal.
"""

import json
import os

import jax
import numpy as np
import pytest
import scipy.special as ss
import torch

from butterfly_tpu.config import FacSpec as JFacSpec
from butterfly_tpu.fac.streamer import FacStreamer as JFacStreamer
from butterfly_tpu.io import serialization as jser
from butterfly_tpu.models.retrieval import CompressedTable as JTable
from butterfly_tpu.ops import eval_tree as jet
from butterfly_tpu.ops import linop as JL
from butterfly_tpu.ops.butterfly import random_butterfly as jrandom_bf
from butterfly_tpu.trees import uniform_tree as juniform_tree
from butterfly_tpu_torch.config import FacSpec
from butterfly_tpu_torch.examples import tree_evaluator as twin_te
from butterfly_tpu_torch.fac.streamer import FacStreamer
from butterfly_tpu_torch.io import serialization as tser
from butterfly_tpu_torch.models.retrieval import CompressedTable
from butterfly_tpu_torch.ops import eval_tree as tet
from butterfly_tpu_torch.ops import linop as TL
from butterfly_tpu_torch.ops.butterfly import UniformButterfly
from butterfly_tpu_torch.trees import uniform_tree
from butterfly_tpu_torch.utils import profiling as tprof


def _ops(L, seed=0):
    """tests/test_aux.py::test_linop_roundtrip_all_types's operators, built
    in package L from `default_rng(seed)`."""
    rng = np.random.default_rng(seed)
    d = L.Dense(rng.standard_normal((6, 4)))
    return {
        "dense": d,
        "diag": L.Diag(rng.standard_normal(5), (7, 5)),
        "eye": L.Identity(5),
        "zero": L.Zero((3, 4)),
        "perm": L.Perm(rng.permutation(6)),
        "coo": L.Coo((5, 5), [0, 2], [1, 3], rng.standard_normal(2)),
        "scaled": L.Scaled(2.0 + 1j,
                           L.Dense(rng.standard_normal((3, 3)) + 0j)),
        "prod": L.Product([L.Dense(rng.standard_normal((4, 6))), d]),
        "sum": L.Sum([L.Dense(rng.standard_normal((3, 3))), L.Identity(3)]),
        "diff": L.Diff(L.Dense(rng.standard_normal((3, 3))), L.Identity(3)),
        "bdiag": L.BlockDiag([L.Dense(rng.standard_normal((2, 3))),
                              L.Identity(2)]),
        "bdense": L.BlockDense([[L.Dense(rng.standard_normal((2, 2))),
                                 L.Zero((2, 3))]]),
        "bcoo": L.BlockCoo(
            np.array([0, 2, 4]), np.array([0, 3]), [0, 1], [0, 0],
            [L.Dense(rng.standard_normal((2, 3))),
             L.Dense(rng.standard_normal((2, 3)))],
        ),
    }


OP_NAMES = list(_ops(TL))


def _probe(op, rng):
    x = rng.standard_normal(op.shape[1])
    if np.issubdtype(op.dtype, np.complexfloating):
        x = x + 1j * rng.standard_normal(op.shape[1])
    return x


@pytest.mark.parametrize("name", OP_NAMES)
def test_linop_files_cross_both_ways(tmp_path, name):
    rng = np.random.default_rng(1)
    jop, top = _ops(JL)[name], _ops(TL)[name]
    for save, load, src, cls in ((jser.save_linop, tser.load_linop, jop,
                                  TL.LinOp),
                                 (tser.save_linop, jser.load_linop, top,
                                  JL.LinOp)):
        p = str(tmp_path / f"{name}.npz")
        save(p, src)
        back = load(p)
        assert isinstance(back, cls) and back.shape == src.shape
        x = _probe(src, rng)
        np.testing.assert_allclose(back.matvec(x), src.matvec(x),
                                   rtol=0, atol=1e-12)
        # and it round-trips in the port
        tser.save_linop(p, back if cls is TL.LinOp else top)
        again = tser.load_linop(p)
        np.testing.assert_allclose(again.matvec(x), src.matvec(x),
                                   rtol=0, atol=1e-12)


def test_jax_butterfly_and_table_files_load_in_the_port(tmp_path):
    bf = jrandom_bf(4, 4, key=jax.random.key(1))  # leaf + two levels
    p = str(tmp_path / "bf.npz")
    jser.save_butterfly(p, bf)
    back = tser.load_butterfly(p, device="cpu")
    assert isinstance(back, UniformButterfly)
    assert back.radix == bf.radix and back.num_levels == bf.num_levels
    x = np.ones(bf.shape[1], np.float32)
    np.testing.assert_allclose(back.apply(torch.from_numpy(x)).numpy(),
                               np.asarray(bf.apply(x)), rtol=0, atol=1e-6)

    rng = np.random.default_rng(3)
    ct = JTable(jax.numpy.asarray(rng.standard_normal((4, 8, 3)), "float32"),
                jax.numpy.asarray(rng.standard_normal((4, 3, 5)), "float32"))
    p2 = str(tmp_path / "ct.npz")
    jser.save_butterfly(p2, ct)
    back2 = tser.load_butterfly(p2, device="cpu")
    assert isinstance(back2, CompressedTable)
    np.testing.assert_allclose(back2.materialize().detach().numpy(),
                               np.asarray(ct.materialize()), rtol=0,
                               atol=1e-6)

    # the port's files load in the JAX package, and in the port again
    for obj, want in ((back, np.asarray(bf.apply(x))),
                      (back2, np.asarray(ct.materialize()))):
        p3 = str(tmp_path / "port.npz")
        tser.save_butterfly(p3, obj)
        j = jser.load_butterfly(p3)
        t = tser.load_butterfly(p3, device="cpu")
        if isinstance(obj, UniformButterfly):
            got_j = np.asarray(j.apply(x))
            got_t = t.apply(torch.from_numpy(x)).numpy()
        else:
            got_j = np.asarray(j.materialize())
            got_t = t.materialize().detach().numpy()
        np.testing.assert_allclose(got_j, want, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got_t, got_j, rtol=0, atol=1e-6)


def _stream_problem():
    rng = np.random.default_rng(42)
    x = np.sort(rng.random(128))
    y = np.sort(rng.random(64))
    Phi = np.exp(-((x[:, None] - y[None, :]) ** 2) / 0.3**2)
    kw = dict(tol=1e-12, min_num_rows=4, min_num_cols=4)
    spec = FacSpec(row_tree=uniform_tree(128, 2, 3),
                   col_tree=uniform_tree(64, 2, 2), **kw)
    jspec = JFacSpec(row_tree=juniform_tree(128, 2, 3),
                     col_tree=juniform_tree(64, 2, 2), **kw)
    return Phi, spec, jspec


@pytest.mark.parametrize("saved_by", ["port", "jax"])
def test_streamer_checkpoint_resumes_in_the_port(tmp_path, saved_by):
    """Checkpoint after two of four leaves, resume in the port, finish:
    the same result as an uninterrupted stream (1e-9, as the JAX test)."""
    Phi, spec, jspec = _stream_problem()
    leaves = spec.col_tree.nodes_at_depth(2)
    if saved_by == "port":
        st = FacStreamer(spec)
        save = tser.save_streamer
    else:
        st = JFacStreamer(jspec)
        save = jser.save_streamer
    for leaf in leaves[:2]:
        st.feed(Phi[:, leaf.i0:leaf.i1])
    ckpt = str(tmp_path / "streamer.npz")
    save(ckpt, st)

    st2 = tser.load_streamer(ckpt, spec)
    for leaf in leaves[2:]:
        st2.feed(Phi[:, leaf.i0:leaf.i1])
    assert st2.is_done()
    got = st2.get_fac().as_linop().materialize()
    rel = np.linalg.norm(got - Phi) / np.linalg.norm(Phi)
    assert rel < 1e-9

    whole = FacStreamer(spec)
    for leaf in leaves:
        whole.feed(Phi[:, leaf.i0:leaf.i1])
    np.testing.assert_allclose(got, whole.get_fac().as_linop().materialize(),
                               rtol=0, atol=1e-12)


def test_device_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    a = torch.ones(64, 64)
    with tprof.device_trace(log_dir) as prof:
        (a @ a).sum()
    path = os.path.join(log_dir, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert prof.key_averages()


def test_eval_tree_matches_jax():
    def f(x):
        return ss.jv(0, x)

    want = jet.EvalTree(f, 0.5, 500.0, tol=1e-12)
    got = tet.EvalTree(f, 0.5, 500.0, tol=1e-12)
    np.testing.assert_array_equal(got.edges, want.edges)
    x = np.random.default_rng(0).uniform(0.5, 500.0, 2000)
    np.testing.assert_array_equal(got(x), want(x))
    assert np.abs(got(x) - f(x)).max() < 1e-11
    with pytest.raises(Exception, match="outside"):
        got(np.array([501.0]))


def test_tree_evaluator_twin_runs(capsys):
    out = twin_te.main(["--n", "2000"])
    assert "J0:" in capsys.readouterr().out
    assert out["J0"]["max_abs_err"] < 1e-11 and out["Y0"]["leaves"] > 0


def test_givens_indexed_blocks_and_aslinop_match_jax():
    rng = np.random.default_rng(5)
    X = rng.standard_normal((6, 3)) + 1j * rng.standard_normal((6, 3))
    c, s = 0.6, 0.8j
    jg, tg = JL.Givens(6, 1, 4, c, s), TL.Givens(6, 1, 4, c, s)
    np.testing.assert_array_equal(tg.matmat(X), jg.matmat(X))
    np.testing.assert_array_equal(tg.rmatmat(X), jg.rmatmat(X))
    assert tg.dtype == jg.dtype

    blocks = [(0, 0, rng.standard_normal((2, 3))),
              (2, 3, rng.standard_normal((3, 2))),
              (0, 3, rng.standard_normal((2, 2)))]
    jb = JL.block_coo_from_indexed(
        (5, 5), [JL.IndexedBlock(i, j, JL.Dense(a)) for i, j, a in blocks])
    tb = TL.block_coo_from_indexed(
        (5, 5), [TL.IndexedBlock(i, j, TL.Dense(a)) for i, j, a in blocks])
    np.testing.assert_array_equal(tb.row_offsets, jb.row_offsets)
    np.testing.assert_array_equal(tb.col_offsets, jb.col_offsets)
    x = rng.standard_normal(5)
    np.testing.assert_allclose(tb.matvec(x), jb.matvec(x), rtol=0,
                               atol=1e-15)
    with pytest.raises(Exception, match="align"):
        TL.block_coo_from_indexed(
            (5, 5), [TL.IndexedBlock(0, 0, TL.Dense(np.ones((2, 2)))),
                     TL.IndexedBlock(1, 2, TL.Dense(np.ones((2, 2))))])

    A = rng.standard_normal((4, 3))
    ta, ja = TL.aslinop(A), JL.aslinop(A)
    assert isinstance(ta, TL.Dense) and TL.aslinop(ta) is ta
    np.testing.assert_array_equal(ta.matvec(x[:3]), ja.matvec(x[:3]))
