"""The port's native kits (`csrc/treekit.cpp` via trees/native.py,
`csrc/meshkit.cpp` via geom/native.py) against their NumPy oracles and the
JAX package's native kits.

The treekit's tree is held equal to the port's NumPy builder and to the JAX
package's `build_point_tree_native`: the permutation and every column of
the node table (parent, depth, ranges, octant, boxes), exactly. The
meshkit's FEM matrices are held to 1e-14 against the NumPy assembly and
against the JAX package's kit; the five tests of tests/test_native_mesh.py
run against the port's kit with its NumPy paths (`use_native=False`) as
the oracle. The kits are built with g++ into `build/kernels/`, never under
the JAX package's `native/`, and a kit that does not build raises.
"""

from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp

from butterfly_tpu.geom import native as jgn
from butterfly_tpu.trees import native as jtn
from butterfly_tpu_torch.geom import native as tgn
from butterfly_tpu_torch.geom.trimesh import Trimesh, icosphere
from butterfly_tpu_torch.trees import PointTree
from butterfly_tpu_torch.trees import native as ttn
from butterfly_tpu_torch.utils import nvcc
from butterfly_tpu_torch.utils.errors import (
    InvalidArgumentsError,
    RuntimeButterflyError,
)

ROOT = Path(__file__).resolve().parents[1]


def _points(d: int) -> np.ndarray:
    """2000 points of a normal cloud with 300 duplicates among them and a
    cluster of 80 copies of one point (more than a leaf of 64)."""
    rng = np.random.default_rng(10 + d)
    p = rng.standard_normal((2000, d))
    p[1700:] = p[rng.integers(0, 1700, 300)]
    p[:80] = p[100]
    return p


def _table(tree):
    """A tree's node table in the treekit's discovery order: the root, then
    for each node in pre-order its children, consecutively."""
    rows, ids = [], {}

    def emit(node, parent):
        ids[id(node)] = len(rows)
        rows.append((parent, node))

    emit(tree.root, -1)

    def walk(node):
        for c in node.children:
            emit(c, ids[id(node)])
        for c in node.children:
            walk(c)

    walk(tree.root)
    d = tree.points.shape[1]
    lo = np.zeros((len(rows), 3))
    hi = np.zeros((len(rows), 3))
    for k, (_, node) in enumerate(rows):
        lo[k, :d], hi[k, :d] = node.bbox.lo, node.bbox.hi
    return {
        "parent": np.array([p for p, _ in rows]),
        "depth": np.array([n.depth for _, n in rows]),
        "i0": np.array([n.i0 for _, n in rows]),
        "i1": np.array([n.i1 for _, n in rows]),
        "octant": np.array([n.index if p >= 0 else -1 for p, n in rows]),
        "lo": lo,
        "hi": hi,
    }


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("leaf", [1, 64])
def test_treekit_matches_numpy_and_jax(d, leaf):
    pts = _points(d)
    perm, tab = ttn.build_point_tree_native(pts, leaf, 64)
    jperm, jtab = jtn.build_point_tree_native(pts, leaf, 64)
    np.testing.assert_array_equal(perm, jperm)
    for key in tab:
        np.testing.assert_array_equal(tab[key], jtab[key], err_msg=key)
    tn = PointTree(pts, leaf_size=leaf)
    tp = PointTree(pts, leaf_size=leaf, use_native=False)
    np.testing.assert_array_equal(tn.perm, perm)
    np.testing.assert_array_equal(tp.perm, perm)
    want, got = _table(tp), _table(tn)
    for key in tab:
        np.testing.assert_array_equal(tab[key], want[key], err_msg=key)
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # the identical points stay together in one leaf past the leaf size
    assert max(n.num_points for n in tn.post_order() if n.is_leaf) >= 80


def _snapshot(path: Path) -> dict:
    return {p.name: (p.stat().st_size, p.stat().st_mtime_ns)
            for p in path.iterdir()}


def test_kits_build_into_build_kernels_and_not_native(tmp_path, monkeypatch):
    jtn.native_available()  # the JAX package may build its own first
    jgn.native_available()
    before = _snapshot(ROOT / "native")
    for lib in (ttn._load(), tgn._load()):
        assert Path(lib._name).parent == nvcc.BUILD_DIR
        assert nvcc.BUILD_DIR == ROOT / "build" / "kernels"
    monkeypatch.setattr(nvcc, "BUILD_DIR", tmp_path)
    built = [nvcc.build_host_library(s) for s in ("treekit.cpp",
                                                  "meshkit.cpp")]
    assert [p.parent for p in built] == [tmp_path, tmp_path]
    assert all(p.exists() for p in built)
    assert not list(tmp_path.glob("*.tmp"))
    assert _snapshot(ROOT / "native") == before


def test_a_kit_that_does_not_build_raises(monkeypatch):
    def broken(source):
        raise RuntimeButterflyError(f"g++ failed on {source}")

    for mod in (ttn, tgn):
        monkeypatch.setattr(mod, "build_host_library", broken)
        mod._load.cache_clear()
    try:
        with pytest.raises(RuntimeButterflyError, match="use_native=False"):
            PointTree(_points(2), leaf_size=8)
        with pytest.raises(RuntimeButterflyError, match="use_native=False"):
            icosphere(1).lbo_fem()
        assert not ttn.native_available() and not tgn.native_available()
        tree = PointTree(_points(2), leaf_size=8, use_native=False)
        assert tree.perm.size == 2000
    finally:
        ttn._load.cache_clear()
        tgn._load.cache_clear()


@pytest.mark.parametrize("subdiv", [2, 3])
def test_lbo_fem_native_matches_numpy_and_jax_kit(subdiv):
    mesh = icosphere(subdiv)
    L, M = mesh.lbo_fem()
    Lp, Mp = mesh.lbo_fem(use_native=False)
    assert jgn.native_available()
    rows, cols, lv, mv = jgn.lbo_fem_native(mesh.verts, mesh.faces)
    jL = sp.coo_matrix((lv, (rows, cols)), shape=L.shape).tocsr()
    jM = sp.coo_matrix((mv, (rows, cols)), shape=M.shape).tocsr()
    for got, want in ((L, Lp), (M, Mp), (L, jL), (M, jM)):
        assert abs(got - want).max() <= 1e-14


# ---- tests/test_native_mesh.py, against the port's kit -----------------


def test_lbo_fem_native_matches_numpy():
    mesh = icosphere(2)
    Ln, Mn = mesh.lbo_fem()
    Lp, Mp = mesh.lbo_fem(use_native=False)
    assert sp.issparse(Ln) and sp.issparse(Mn)
    assert abs(Ln - Lp).max() < 1e-12
    assert abs(Mn - Mp).max() < 1e-12
    # stiffness rows sum to zero, mass rows sum to vertex areas > 0
    assert np.abs(np.asarray(Ln.sum(axis=1))).max() < 1e-10
    assert np.asarray(Mn.sum(axis=1)).min() > 0


def _square():
    """One flat triangle pair with a boundary."""
    verts = np.array(
        [[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], dtype=np.float64
    )
    faces = np.array([[0, 1, 2], [1, 3, 2]], dtype=np.int64)
    return Trimesh(verts, faces)


def test_lbo_fem_native_open_mesh():
    mesh = _square()
    Ln, Mn = mesh.lbo_fem()
    Lp, Mp = mesh.lbo_fem(use_native=False)
    assert abs(Ln - Lp).max() < 1e-13
    assert abs(Mn - Mp).max() < 1e-13


def test_boundary_edges_native_matches_numpy():
    mesh = _square()
    bn = mesh.boundary_edges()
    bp = mesh.boundary_edges(use_native=False)
    assert sorted(map(tuple, bn)) == sorted(map(tuple, bp))
    np.testing.assert_array_equal(bn, bp)  # both sorted
    # closed surface has no boundary
    assert len(icosphere(1).boundary_edges()) == 0
    np.testing.assert_array_equal(mesh.interior_mask(), [False] * 4)


def test_obj_roundtrip_native(tmp_path):
    mesh = icosphere(1)
    path = str(tmp_path / "sphere.obj")
    mesh.save_obj(path)
    loaded = Trimesh.from_obj(path)  # native parser
    assert loaded.num_verts == mesh.num_verts
    assert loaded.num_faces == mesh.num_faces
    assert np.allclose(loaded.verts, mesh.verts, atol=1e-12)
    assert np.array_equal(loaded.faces, mesh.faces)
    py = Trimesh.from_obj(path, use_native=False)
    np.testing.assert_array_equal(loaded.verts, py.verts)
    np.testing.assert_array_equal(loaded.faces, py.faces)


def test_obj_native_quads_and_slashes(tmp_path):
    # quad fan-triangulation + v/vt/vn face syntax + negative indices
    path = str(tmp_path / "quad.obj")
    with open(path, "w") as f:
        f.write("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n")
        f.write("f 1/1/1 2/2/2 3/3/3 4/4/4\n")
        f.write("f -4 -3 -2\n")
    verts, faces = tgn.load_obj_native(path)
    assert verts.shape == (4, 3)
    # quad -> 2 triangles, plus the negative-index triangle
    assert faces.shape == (3, 3)
    assert faces.tolist() == [[0, 1, 2], [0, 2, 3], [0, 1, 2]]
    with pytest.raises(InvalidArgumentsError, match="cannot open"):
        tgn.load_obj_native(str(tmp_path / "missing.obj"))
