"""The port's LBO layers (geom/trimesh.py, trees/interval_tree.py,
trees/fiedler_tree.py, the host eigensolvers of ops/linalg.py,
ops/device_eigs.py, models/lbo.py, the bf_lbo and fiedler_tree twins and
the LBO-table path of the retrieval_lbo twin) against the JAX package's.

Both packages get the same meshes and the same numpy matrices. Both
packages' native mesh kits are switched off in this module (their NumPy
paths run, the oracle the kits are tested against in
tests/test_native_mesh.py and tests/test_torch_native.py): the kits' FEM
matrices differ from the NumPy ones in the last bits, which turns the
sphere's degenerate eigenvectors (and the Fiedler splits) another way.
The host layers are the same NumPy and scipy code, so meshes, trees, permutations
and the host eigensolvers' results are identical or agree to 1e-10/1e-12;
the device eigensolver runs in float64 on the CPU in both, its dense path
agreeing to 1e-8. LOBPCG's search directions come from different
generators, so its pairs are held to scipy's (1e-8), as the JAX package's
own test holds them. The JAX fused plan runs K1 in Pallas interpret mode,
the port's its plain passes (1e-5). Meshes are icosphere(2) and (3), as in
tests/test_lbo.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import scipy.sparse as sp
import torch

from butterfly_tpu.fac.distill import distill_butterfly as jax_distill
from butterfly_tpu.geom import trimesh as jtm
from butterfly_tpu.models import lbo as jlbo
from butterfly_tpu.models import retrieval as jr
from butterfly_tpu.ops import device_eigs as jde
from butterfly_tpu.ops import linalg as jla
from butterfly_tpu.ops.pallas_butterfly import (
    FusedButterflyPlan as JaxFusedPlan,
)
from butterfly_tpu.trees import IntervalTree as JaxIntervalTree
from butterfly_tpu.trees import fiedler_tree as jft
from butterfly_tpu_torch.examples import bf_lbo as twin_bf_lbo
from butterfly_tpu_torch.examples import fiedler_tree as twin_fiedler
from butterfly_tpu_torch.examples import retrieval_lbo as twin_rl
from butterfly_tpu_torch.geom import trimesh as ttm
from butterfly_tpu_torch.models import lbo as tlbo
from butterfly_tpu_torch.ops import device_eigs as tde
from butterfly_tpu_torch.ops import linalg as tla
from butterfly_tpu_torch.trees import IntervalTree
from butterfly_tpu_torch.trees import fiedler_tree as tft


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


_NATIVE = {}


@pytest.fixture(autouse=True, scope="module")
def _numpy_mesh_paths():
    import functools

    import butterfly_tpu.geom.native as jnative

    _NATIVE["lbo_fem"] = jnative.lbo_fem_native
    with pytest.MonkeyPatch.context() as mp:
        for name in ("lbo_fem_native", "boundary_edges_native",
                     "load_obj_native"):
            mp.setattr(jnative, name, lambda *a: None)
        # the port's: every call takes `use_native=False`
        for name in ("lbo_fem", "boundary_edges"):
            mp.setattr(ttm.Trimesh, name, functools.partialmethod(
                getattr(ttm.Trimesh, name), use_native=False))
        mp.setattr(ttm.Trimesh, "from_obj", classmethod(functools.partial(
            ttm.Trimesh.from_obj.__func__, use_native=False)))
        yield


@pytest.fixture(scope="module")
def spheres():
    """icosphere(2) and (3) of both packages, and the JAX package's FEM
    pencils of each (the matrices both packages' solvers get)."""
    out = {}
    for s in (2, 3):
        jm, tm = jtm.icosphere(s), ttm.icosphere(s)
        out[s] = (jm, tm, *jm.lbo_fem())
    return out


def _dense_vals(L, M):
    return np.sort(sla.eigh(L.toarray(), M.toarray(), eigvals_only=True))


@pytest.mark.parametrize("subdiv", [2, 3])
def test_icosphere_and_topology_are_identical(spheres, subdiv):
    jm, tm, _, _ = spheres[subdiv]
    np.testing.assert_array_equal(tm.verts, jm.verts)
    np.testing.assert_array_equal(tm.faces, jm.faces)
    np.testing.assert_array_equal(tm.edges(), jm.edges())
    np.testing.assert_array_equal(tm.face_areas(), jm.face_areas())
    assert len(tm.boundary_edges()) == 0 and tm.interior_mask().all()
    assert (tm.vertex_adjacency() != jm.vertex_adjacency()).nnz == 0


@pytest.mark.parametrize("subdiv", [2, 3])
def test_lbo_fem_matches_jax(spheres, subdiv):
    """Identical to the JAX package's NumPy assembly, and within 1e-12 of
    its native kit's where the kit builds."""
    jm, tm, jL, jM = spheres[subdiv]
    L, M = tm.lbo_fem()
    assert (L != jL).nnz == 0 and (M != jM).nnz == 0
    nat = _NATIVE["lbo_fem"](jm.verts, jm.faces)
    if nat is None:
        return
    rows, cols, lv, mv = nat
    nL = sp.coo_matrix((lv, (rows, cols)), shape=L.shape).tocsr()
    nM = sp.coo_matrix((mv, (rows, cols)), shape=M.shape).tocsr()
    for got, want in ((L, nL), (M, nM)):
        assert abs(got - want).max() <= 1e-12 * abs(want).max()


def test_submeshes_and_obj_roundtrip_match_jax(spheres, tmp_path):
    jm, tm, _, _ = spheres[2]
    mask = tm.verts[:, 2] > 0.1
    (ts, tidx), (js, jidx) = tm.submesh(mask), jm.submesh(mask)
    np.testing.assert_array_equal(tidx, jidx)
    np.testing.assert_array_equal(ts.faces, js.faces)
    phi = tm.verts[:, 0] - 0.2
    (tl, tids), (jl, jids) = (tm.level_set_submesh(phi),
                              jm.level_set_submesh(phi))
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_array_equal(tl.faces, jl.faces)
    np.testing.assert_allclose(tl.verts, jl.verts, rtol=0, atol=1e-15)
    path = str(tmp_path / "s.obj")
    tm.save_obj(path)
    back = ttm.Trimesh.from_obj(path)
    np.testing.assert_array_equal(back.faces, jm.faces)
    np.testing.assert_allclose(back.verts, jm.verts, rtol=1e-15)


def test_interval_tree_set_points_gives_identical_leaves():
    pts = np.random.default_rng(0).uniform(0.0, 9.0, 300)
    pts[:20] = 3.0  # points on a node edge
    t, j = IntervalTree(0.0, 9.0, arity=3, depth=3), JaxIntervalTree(
        0.0, 9.0, arity=3, depth=3)
    t.set_points(pts)
    j.set_points(pts)
    np.testing.assert_array_equal(t.perm, j.perm)
    tn, jn = list(t.root.subtree_nodes()), list(j.root.subtree_nodes())
    assert [(a.i0, a.i1, a.a, a.b, a.is_leftmost, a.is_rightmost)
            for a in tn] == [(b.i0, b.i1, b.a, b.b, b.is_leftmost,
                              b.is_rightmost) for b in jn]


def test_host_eigensolvers_match_jax(spheres):
    _, _, L, M = spheres[2]
    assert abs(tla.get_max_eigenvalue(L, M)
               - jla.get_max_eigenvalue(L, M)) <= 1e-10
    tv, tX = tla.get_shifted_eigs(L, M, 7.0, 12)
    jv, jX = jla.get_shifted_eigs(L, M, 7.0, 12)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-10)
    np.testing.assert_allclose(tX, jX, rtol=0, atol=1e-10)
    vals = _dense_vals(L, M)
    for lo, hi, method in ((-np.inf, 13.0, "doubling"),
                           (13.0, 45.0, "covering"),
                           (45.0, np.inf, "doubling")):
        tv, tX = tla.get_eigenband(L, M, lo, hi, method=method)
        jv, jX = jla.get_eigenband(L, M, lo, hi, method=method)
        np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-10)
        np.testing.assert_allclose(tX, jX, rtol=0, atol=1e-10)
        want = vals[(vals >= lo) & (vals < hi)]
        np.testing.assert_allclose(tv, want, rtol=1e-8, atol=1e-8)


def test_fiedler_tree_perm_is_identical(spheres):
    jm, tm, _, _ = spheres[2]
    np.testing.assert_allclose(tm.fiedler_vector(), jm.fiedler_vector(),
                               rtol=0, atol=1e-10)
    t, j = tft.FiedlerTree(tm, leaf_size=16), jft.FiedlerTree(jm,
                                                               leaf_size=16)
    np.testing.assert_array_equal(t.perm, j.perm)
    split = tm.verts[:, 0] * tm.verts[:, 1] > 0  # two disconnected halves
    np.testing.assert_array_equal(tft._repair_nodal_domains(tm, split),
                                  jft._repair_nodal_domains(jm, split))


def test_device_session_dense_path_matches_jax(spheres):
    """Three consecutive bands of the dense path (float64 on the CPU in
    both packages) against the JAX session's and the dense eigensolve."""
    _, _, L, M = spheres[2]
    vals = _dense_vals(L, M)
    cuts = [-np.inf, float(vals[10]) + 1e-6, float(vals[40]) + 1e-6, np.inf]
    ts = tde.DeviceEigSession(L, M, device="cpu")
    js = jde.DeviceEigSession(L, M)
    got = []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        tv, tX = ts.next_band(lo, hi)
        jv, _ = js.next_band(lo, hi)
        np.testing.assert_allclose(tv, jv, rtol=1e-8, atol=1e-8)
        R = L @ tX - (M @ tX) * tv[None, :]
        assert np.linalg.norm(R, axis=0).max() < 1e-7
        got.append(tv)
    np.testing.assert_allclose(np.concatenate(got), vals, rtol=1e-8,
                               atol=1e-8)
    tv, _ = tde.dense_generalized_eigh_device(L, M, device="cpu")
    np.testing.assert_allclose(tv, vals, rtol=1e-8, atol=1e-8)


def test_lobpcg_chunk16_matches_scipy(spheres):
    """The LOBPCG path (forced by dense_cutoff=0) at chunk 16 on
    icosphere(3): the lowest 24 pairs against scipy to 1e-8, residuals
    against the band's scale, M-orthonormality. The JAX session stalls on
    this mesh (residuals 1.8e-6 of the scale, above its 1e-6 acceptance):
    its whitening drops residual directions of M-norm below 1e-6."""
    _, _, L, M = spheres[3]
    vals = _dense_vals(L, M)
    hi = float(vals[24]) + 1e-6
    ses = tde.DeviceEigSession(L, M, dense_cutoff=0, chunk=16, device="cpu")
    lam, Phi = ses.next_band(-np.inf, hi)
    want = vals[vals < hi]
    assert lam.size == want.size == 25  # l = 0..4 on the sphere
    np.testing.assert_allclose(lam, want, rtol=1e-8, atol=1e-8)
    ref, _ = tla.get_shifted_eigs(L, M, -1e-3, 24)
    np.testing.assert_allclose(lam[:24], ref, rtol=1e-8, atol=1e-8)
    R = L @ Phi - (M @ Phi) * lam[None, :]
    assert np.linalg.norm(R, axis=0).max() < 1e-5 * max(lam.max(), 1.0)
    np.testing.assert_allclose(Phi.T @ (M @ Phi), np.eye(25), atol=1e-6)
    with pytest.raises(Exception, match="made no progress"):
        jde.DeviceEigSession(L, M, dense_cutoff=0, chunk=16,
                             maxit=150).next_band(-np.inf, hi)


def test_compress_lbo_matches_jax(spheres):
    """Both eigensolver branches on icosphere(2): the scipy branch gives
    identical frequencies and row tree and the same fac to 1e-10; the
    device branch (float64 on the CPU) the same frequencies to 1e-8 and an
    eigen-residual at the compression tolerance."""
    jm, tm, _, _ = spheres[2]
    kw = dict(tol=1e-8, col_tree_depth=2)
    jc = jlbo.compress_lbo_eigenfunctions(jm, **kw)
    tc = tlbo.compress_lbo_eigenfunctions(tm, **kw)
    np.testing.assert_array_equal(tc.freqs, jc.freqs)
    np.testing.assert_array_equal(tc.row_tree.perm, jc.row_tree.perm)
    Pt, Pj = tc.fac.as_linop().materialize(), jc.fac.as_linop().materialize()
    assert np.abs(Pt - Pj).max() <= 1e-10 * np.abs(Pj).max()
    assert tc.compression_rate == jc.compression_rate
    dc = tlbo.compress_lbo_eigenfunctions(tm, eigensolver="device",
                                          device="cpu", **kw)
    assert dc.freqs.size == tm.num_verts
    np.testing.assert_allclose(dc.freqs, jc.freqs, rtol=1e-8, atol=1e-6)
    assert twin_bf_lbo.eigen_residual(tm, dc) <= 1e-6


def test_twins_run_on_the_cpu():
    """CPU smoke runs of the bf_lbo (both eigensolvers) and fiedler_tree
    twins, each against the JAX script's arithmetic where it has one."""
    rec = twin_bf_lbo.main(["--subdiv", "2"])
    dev = twin_bf_lbo.main(["--subdiv", "2", "--eigensolver", "device",
                            "--device", "cpu", "--fiedler"])
    assert rec["eigenpairs"] == dev["eigenpairs"] == 162
    assert rec["eigen_residual"] <= 1e-6 and dev["eigen_residual"] <= 1e-6
    jc = jlbo.compress_lbo_eigenfunctions(jtm.icosphere(2), tol=1e-6)
    assert rec["compression_rate"] == jc.compression_rate
    fied = twin_fiedler.main(["--subdiv", "2", "--leaf-size", "16"])
    assert fied["fiedler"]["depths"][0]["max"] == 162
    assert fied["octree"]["leaves"] > 1


def test_lbo_table_deep_fused_matches_jax():
    """The retrieval_lbo twin's LBO-table path at icosphere(3), 64
    eigenvectors: three formats, and the deep_fused scores against the JAX
    fused plan (interpret mode) on the same prepared table, to 1e-5."""
    args = twin_rl.parse_args(["--subdiv", "3", "--num-eigs", "64",
                               "--device", "cpu"])
    Phi, eig_s = twin_rl.lbo_table(3, 64)
    assert Phi.shape == (642, 64) and eig_s is not None
    rows, fused = twin_rl.run_table(Phi, args, torch.device("cpu"))
    assert [r["format"] for r in rows] == ["one_level", "deep_butterfly",
                                           "deep_fused"]
    assert all(r["recall_at_100_tol1e-3"] >= 0.99 for r in rows)
    table = fused["table"]
    assert table.shape == (768, 64)
    np.testing.assert_array_equal(table, twin_rl.prepare_table(Phi))
    NB, rank = twin_rl.fused_shape(*table.shape)
    jdt = jr.compress_table_deep(table, tol=1e-3, col_depth=3, row_leaf=128)
    jdist = jax_distill(jdt.fac.as_linop(), NB, rank=rank, dtype=np.float32)
    np.testing.assert_array_equal(fused["dist"].row_perm, jdist.row_perm)
    jplan = JaxFusedPlan(jdist.bf, fuse=8, r_tile=256, interpret=True)
    x = fused["x"]
    js = np.asarray(jplan.apply(jnp.asarray(x.numpy())))
    ts = fused["plan"].apply_plain(x).numpy()
    assert np.linalg.norm(ts - js) <= 1e-5 * np.linalg.norm(js)


def test_lbo_table_phi_cache_must_match_the_mesh(tmp_path):
    """`--phi` saves the eigenvector table on first use and loads it after;
    a cache made for another subdivision or another number of eigenvectors
    raises, naming both shapes, instead of being re-indexed."""
    from butterfly_tpu_torch.utils.errors import InvalidArgumentsError

    phi = str(tmp_path / "phi.npy")
    Phi, eig_s = twin_rl.lbo_table(2, 16, phi=phi)
    assert Phi.shape == (162, 16) and eig_s is not None
    again, eig_s = twin_rl.lbo_table(2, 16, phi=phi)
    assert eig_s is None
    np.testing.assert_array_equal(again, Phi)
    for subdiv, k in ((3, 16), (2, 8)):
        with pytest.raises(InvalidArgumentsError, match=r"\(162, 16\)"):
            twin_rl.lbo_table(subdiv, k, phi=phi)
