"""The port's radiosity layers (Trimesh face geometry, geom/visibility.py,
models/radiosity.py and the radiosity twin) against the JAX package's.

Both packages get the same meshes and the same numpy rays. View factors are
float64 in both (the reference's midpoint rule, one broadcast tile), held
to 1e-12; visibility is float32 Möller–Trumbore in both, held ray for ray
(no ray of these fields grazes an edge); the radiosity solve is float64
GMRES, B held to 1e-10 relative and the iterations to one of the JAX
model's. Meshes and fields are those of tests/test_radiosity.py; the
culled path is also held on a denser field of 2048 triangles across ray
chunks and tile budgets (its candidate buckets, split tiles and padding).
"""

import numpy as np
import pytest
import torch

from butterfly_tpu.geom import trimesh as jtm
from butterfly_tpu.geom import visibility as jvis
from butterfly_tpu.models import radiosity as jrad
from butterfly_tpu_torch.examples import radiosity as twin
from butterfly_tpu_torch.geom import trimesh as ttm
from butterfly_tpu_torch.geom import visibility as tvis
from butterfly_tpu_torch.models import radiosity as trad
from butterfly_tpu_torch.utils.errors import RuntimeButterflyError


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


def _plates(mod, gap=1.0, blocked=False):
    """The JAX test's two parallel unit squares (normals facing away from
    the gap), optionally with a third, larger plate between them."""
    v = np.array([
        [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
        [0, 0, gap], [1, 0, gap], [1, 1, gap], [0, 1, gap],
    ], dtype=np.float64)
    f = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7]])
    if blocked:
        v3 = np.array([[-1, -1, 1], [2, -1, 1], [2, 2, 1], [-1, 2, 1]],
                      dtype=np.float64)
        v = np.vstack([v, v3])
        f = np.vstack([f, [[8, 9, 10], [8, 10, 11]]])
    return mod.Trimesh(v, f)


def _occluder_field():
    """tests/test_radiosity.py's random occluder field."""
    rng = np.random.default_rng(42)
    F = 400
    c = rng.random((F, 1, 3))
    tris = (c + 0.08 * (rng.random((F, 3, 3)) - 0.5)).astype(np.float64)
    B = 300
    orig = rng.random((B, 3))
    dirs = rng.random((B, 3)) - orig
    skip = rng.integers(-1, F, (B, 2)).astype(np.int32)
    return tris, orig, dirs, skip


@pytest.mark.parametrize("subdiv", [1, 3])
def test_face_geometry_matches_jax(subdiv):
    jm, tm = jtm.icosphere(subdiv), ttm.icosphere(subdiv)
    for name in ("face_centroids", "face_normals", "face_areas"):
        np.testing.assert_allclose(getattr(tm, name)(), getattr(jm, name)(),
                                   rtol=0, atol=1e-15, err_msg=name)


@pytest.mark.parametrize("which", ["icosphere1", "plates"])
def test_view_factors_match_jax(which):
    if which == "plates":
        jm, tm = _plates(jtm), _plates(ttm)
    else:
        jm, tm = jtm.icosphere(1), ttm.icosphere(1)
    cent, norm, area = (jm.face_centroids(), jm.face_normals(),
                        jm.face_areas())
    want_tile = np.asarray(jrad.view_factor_tile(cent, norm, cent, norm,
                                                 area))
    got_tile = trad.view_factor_tile(*(torch.from_numpy(a) for a in
                                       (cent, norm, cent, norm, area)))
    np.testing.assert_allclose(got_tile.numpy(), want_tile, rtol=1e-12,
                               atol=0)
    want = jrad.view_factor_matrix(jm)
    got = trad.view_factor_matrix(tm, device="cpu")
    np.testing.assert_array_equal(got.toarray() != 0, want.toarray() != 0)
    np.testing.assert_allclose(got.toarray(), want.toarray(), rtol=1e-12,
                               atol=0)
    dense = trad.view_factor_matrix(tm, sparse=False, device="cpu")
    assert isinstance(dense, torch.Tensor) and dense.dtype == torch.float64
    np.testing.assert_array_equal(dense.numpy(), got.toarray())


def test_blocked_plates_occlusion_matches_jax():
    """The blocker zeroes F[0, 2] in both packages. The sightlines of the
    pairs (0, 3), (1, 2) and their transposes cross the blocker exactly on
    its two triangles' shared diagonal (u + v = 1 on one, v = 0 on the
    other), where float32 rounding decides: there the port may read 0 or
    the unoccluded value, and everywhere else it equals the JAX package."""
    jm, tm = _plates(jtm, 2.0, True), _plates(ttm, 2.0, True)
    want = jrad.view_factor_matrix(jm, occlusion=True, sparse=False)
    got = trad.view_factor_matrix(tm, occlusion=True, sparse=False,
                                  device="cpu").numpy()
    assert want[0, 2] == 0.0 and got[0, 2] == 0.0
    free = trad.view_factor_matrix(tm, sparse=False, device="cpu").numpy()
    assert free[0, 2] > 0
    edge = np.zeros_like(got, dtype=bool)
    for i, j in ((0, 3), (1, 2)):
        edge[i, j] = edge[j, i] = True
    np.testing.assert_allclose(got[~edge], want[~edge], rtol=1e-12, atol=0)
    assert np.all((got[edge] == 0) | (got[edge] == free[edge]))
    src, tgt = np.array([0, 0, 1, 2]), np.array([2, 3, 3, 0])
    brute = tvis.segment_occluded(tm, src, tgt, culled=False, device="cpu")
    culled = tvis.segment_occluded(tm, src, tgt, culled=True, device="cpu")
    np.testing.assert_array_equal(culled, brute)
    assert tm._culled_vis.device == torch.device("cpu")
    off_edge = [0, 2, 3]
    np.testing.assert_array_equal(
        brute[off_edge],
        jvis.segment_occluded(jm, src, tgt, culled=False)[off_edge])
    assert brute[off_edge].tolist() == [True, True, True]


def test_visibility_matches_jax_on_the_occluder_field():
    tris, orig, dirs, skip = _occluder_field()
    want = jvis.ray_hits_any(orig, dirs, tris, skip_idx=skip)
    got = tvis.ray_hits_any(orig, dirs, tris, skip_idx=skip, device="cpu")
    assert 0 < want.sum() < want.size
    np.testing.assert_array_equal(got, want)
    jcv = jvis.CulledVisibility(tris, leaf_size=32)
    tcv = tvis.CulledVisibility(tris, leaf_size=32, device="cpu")
    assert (tcv.num_groups, tcv.group_pad) == (jcv.num_groups, jcv.group_pad)
    np.testing.assert_array_equal(tcv.group_lo, jcv.group_lo)
    np.testing.assert_array_equal(tcv._tidx.numpy(), jcv._tidx)
    np.testing.assert_array_equal(
        tcv.ray_hits_any(orig, dirs, skip_idx=skip),
        jcv.ray_hits_any(orig, dirs, skip_idx=skip))
    np.testing.assert_array_equal(tcv.ray_hits_any(orig, dirs,
                                                   skip_idx=skip), want)
    far_o = np.full((8, 3), 10.0)
    far_d = np.tile(np.array([[0.0, 0.0, 1.0]]), (8, 1))
    assert not tcv.ray_hits_any(far_o, far_d).any()

    # the field as a mesh: centroid-to-centroid segments, culled and brute
    verts, faces = tris.reshape(-1, 3), np.arange(3 * len(tris)).reshape(
        -1, 3)
    jm, tm = jtm.Trimesh(verts, faces), ttm.Trimesh(verts, faces)
    pairs = np.random.default_rng(7).integers(0, len(tris), (2, 300))
    want = jvis.segment_occluded(jm, *pairs, culled=False)
    assert 0 < want.sum() < want.size
    np.testing.assert_array_equal(
        jvis.segment_occluded(jm, *pairs, culled=True), want)
    for culled in (False, True):
        np.testing.assert_array_equal(
            tvis.segment_occluded(tm, *pairs, culled=culled, device="cpu"),
            want)


def _dense_field():
    """The JAX test's occluder field at 2048 triangles and 2048 rays."""
    rng = np.random.default_rng(42)
    F = B = 2048
    c = rng.random((F, 1, 3))
    tris = c + 0.08 * (rng.random((F, 3, 3)) - 0.5)
    orig = rng.random((B, 3))
    dirs = rng.random((B, 3)) - orig
    skip = rng.integers(-1, F, (B, 2)).astype(np.int32)
    return tris, orig, dirs, skip


@pytest.mark.parametrize("ray_chunk,tile_elems,rays", [
    (16384, 1 << 23, 2048),  # one chunk, whole buckets a launch
    (500, 1 << 14, 2048),  # 5 chunks, the 512-ray bucket split in two
    (16, 1 << 10, 300),  # a chunk smaller than the least bucket (32)
])
def test_culled_visibility_on_the_device_path(ray_chunk, tile_elems, rays):
    """The culled path, each chunk on the device with one host read of its
    candidate counts: equal ray for ray to brute force and to the JAX
    package's CulledVisibility (no ray of this field grazes an edge), at
    every chunk size and tile budget."""
    tris, orig, dirs, skip = _dense_field()
    orig, dirs, skip = orig[:rays], dirs[:rays], skip[:rays]
    want = tvis.ray_hits_any(orig, dirs, tris, skip_idx=skip, device="cpu")
    assert 0.3 < want.mean() < 0.7
    tcv = tvis.CulledVisibility(tris, leaf_size=64, device="cpu")
    assert tcv.group_size.sum() == len(tris)
    tcv.tile_elems = tile_elems
    got = tcv.ray_hits_any(orig, dirs, skip_idx=skip, ray_chunk=ray_chunk)
    np.testing.assert_array_equal(got, want)
    assert tcv.syncs == -(-rays // ray_chunk)
    jcv = jvis.CulledVisibility(tris, leaf_size=64)
    np.testing.assert_array_equal(
        got, jcv.ray_hits_any(orig, dirs, skip_idx=skip))


def test_segment_occluded_on_a_mesh_past_the_brute_force_size():
    """icosphere(4) has 5120 faces: segment_occluded picks the culled path
    on its own, and on the convex sphere no segment is blocked."""
    jm, tm = jtm.icosphere(4), ttm.icosphere(4)
    rng = np.random.default_rng(3)
    src = rng.integers(0, tm.num_faces, 256)
    tgt = (src + rng.integers(1, tm.num_faces, 256)) % tm.num_faces
    got = tvis.segment_occluded(tm, src, tgt, device="cpu")
    assert isinstance(tm._culled_vis, tvis.CulledVisibility)
    np.testing.assert_array_equal(got, jvis.segment_occluded(jm, src, tgt))
    assert not got.any()


@pytest.mark.parametrize("subdiv", [1, 2])
def test_radiosity_solve_matches_jax(subdiv):
    jm, tm = jtm.icosphere(subdiv), ttm.icosphere(subdiv)
    E = np.zeros(tm.num_faces)
    E[0] = 1.0
    Bj, itj = jrad.RadiosityModel(jm, rho=0.3).solve(E)
    model = trad.RadiosityModel(tm, rho=0.3, device="cpu")
    Bt, itt = model.solve(E)
    assert Bt.device == torch.device("cpu") and Bt.dtype == torch.float64
    assert abs(itt - itj) <= 1
    np.testing.assert_allclose(Bt.numpy(), Bj, rtol=1e-10,
                               atol=1e-10 * np.abs(Bj).max())
    # every form of apply_F gives the same B
    F = trad.view_factor_matrix(tm, device="cpu")
    for apply_F in (F, torch.from_numpy(F.toarray()),
                    lambda x: torch.from_numpy(F @ x.numpy())):
        B2, _ = trad.RadiosityModel(tm, 0.3, apply_F=apply_F,
                                    device="cpu").solve(E)
        np.testing.assert_allclose(B2.numpy(), Bt.numpy(), rtol=1e-12,
                                   atol=1e-14)


@pytest.mark.parametrize("occlusion", [False, True])
def test_twin_runs_on_the_cpu(occlusion, capsys):
    argv = ["--subdiv", "1", "--device", "cpu"]
    row = twin.main(argv + (["--occlusion"] if occlusion else []))
    out = capsys.readouterr().out
    assert "radiosity GMRES solve" in out and "matvec: not measured" in out
    assert row["faces"] == 80 and row["nnz"] == 6320
    assert row["fixed_point_residual"] < 1e-8 and row["matvec_ms"] is None
    assert 1.0 < row["row_sum_min"] <= row["row_sum_max"] < 1.04
    assert (row["visibility_s"] > 0) == occlusion


def test_no_card_and_no_device_raises():
    tris, orig, dirs, _ = _occluder_field()
    with pytest.raises(RuntimeButterflyError):
        tvis.ray_hits_any(orig, dirs, tris)
    with pytest.raises(RuntimeButterflyError):
        trad.RadiosityModel(ttm.icosphere(1), rho=0.3)
