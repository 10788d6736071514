"""The Helmholtz BIE family against the JAX package: the S' operator of
`examples/helm2_bie.py` (n=512, k=10) and of
`examples/multiple_scattering.py` (3 scatterers of 128 points, k=10).

Each operator is built by the JAX package and carried across with
`linop_from_numpy`, so both `PartitionPlan`s compile the same S' operator
(the JAX plan runs K2 in Pallas interpret mode, the port's `cells_plain`).
The port's host system, built by its own modules, is held to the JAX
script's, host GMRES to its iteration count, and the card path (plan +
accumulate corrector + `solve_gmres_plan`, `models/bie.py`) is run with
`device="cpu"`: its complex basis against the JAX script's host complex
GMRES, and the system's deviation from complex-linearity against its MVP
error.
"""

import numpy as np
import pytest
import torch

from butterfly_tpu.fac import helm2 as jax_fac_helm2
from butterfly_tpu.fac.partition import partition_apply_plan as jax_plan
from butterfly_tpu.geom import Ellipse as JaxEllipse
from butterfly_tpu.geom import sample_poisson_disk as jax_poisson
from butterfly_tpu.ops import linop as JL
from butterfly_tpu.ops import quadrature as JQ
from butterfly_tpu.ops.helm2 import Helm2 as JaxHelm2
from butterfly_tpu.ops.helm2 import LayerPot as JaxLayerPot
from butterfly_tpu.ops.linalg import solve_gmres as jax_gmres
from butterfly_tpu.trees import Quadtree as JaxQuadtree
from butterfly_tpu_torch.convert import linop_from_numpy
from butterfly_tpu_torch.examples import helm2_bie, multiple_scattering
from butterfly_tpu_torch.fac.partition import partition_apply_plan
from butterfly_tpu_torch.ops.linalg import solve_gmres


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
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _jax_system(X, N, W, k, offsets):
    """The JAX scripts' butterfly system: S' from make_multilevel plus the
    KR correction (block form with offsets), weighted, plus 0.5 I."""
    helm_sp = JaxHelm2(k=k, layer_pot=JaxLayerPot.PV_NORMAL_DERIV_SINGLE)
    n = len(X)

    def kernel_ij(i, j):
        return helm_sp.kernel_matrix(X[j:j + 1], X[i:i + 1], None,
                                     N[i:i + 1])[0, 0]

    tree = JaxQuadtree(X, leaf_size=32, normals=N)
    perm = tree.perm
    A_bf = jax_fac_helm2.make_multilevel(helm_sp, tree, tree)
    corr = JQ.kr_block_correction(6, n, offsets, kernel_ij, perm=perm)
    sys_bf = JL.Sum([
        JL.Product([JL.Sum([A_bf, corr]), JL.Diag(W[perm])]),
        JL.Scaled(0.5, JL.Identity(n, dtype=np.complex128)),
    ])
    return A_bf, sys_bf, perm, helm_sp


@pytest.fixture(scope="module")
def bie():
    """helm2_bie at n=512, k=10: the port's run (host path and the card
    system on the CPU) and the JAX script's system."""
    n = 512
    prob = helm2_bie.setup(n, 10.0, device="cpu")
    X, _, N, w = JaxEllipse(1.0, 0.6, (0.0, 0.0), 0.1).sample_linspaced(n)
    A_bf, sys_bf, perm, helm_sp = _jax_system(X, N, w, 10.0, [0, n])
    rhs = helm_sp.kernel_matrix(np.array([[0.1, -0.05]]), X, None, N)[:, 0]
    return prob, A_bf, sys_bf, perm, rhs


@pytest.fixture(scope="module")
def scattering():
    """multiple_scattering at 3 x 128 points, k=10: the port's run and
    the JAX script's system on the same Poisson-disk geometry."""
    k, num, pb, seed = 10.0, 3, 128, 5
    sc = multiple_scattering.setup(k, num, pb, seed=seed, device="cpu")
    rng = np.random.default_rng(seed)
    centers = jax_poisson((0, 0), (1, 1), 0.45, rng=rng)[:num]
    X, N, W, offsets = [], [], [], [0]
    for c in centers:
        a, b = 0.12, 0.08 + 0.02 * rng.random()
        e = JaxEllipse(a, b, tuple(c), rng.random() * np.pi)
        Xe, _, Ne, we = e.sample_linspaced(pb)
        X.append(Xe)
        N.append(Ne)
        W.append(we)
        offsets.append(offsets[-1] + pb)
    X, N, W = np.concatenate(X), np.concatenate(N), np.concatenate(W)
    np.testing.assert_array_equal(sc.hs.X, X)
    A_bf, sys_bf, perm, helm_sp = _jax_system(X, N, W, k, offsets)
    rhs = helm_sp.kernel_matrix(centers, X, None, N).sum(axis=1)
    return sc, A_bf, sys_bf, perm, rhs


@pytest.fixture(params=["helm2_bie", "multiple_scattering"])
def case(request, bie, scattering):
    if request.param == "helm2_bie":
        prob, A_bf, sys_bf, perm, rhs = bie
        return prob.sys_bf, prob.card, A_bf, sys_bf, perm, rhs
    sc, A_bf, sys_bf, perm, rhs = scattering
    return sc.hs.sys_op, sc.card, A_bf, sys_bf, perm, rhs


def test_sprime_plan_matches_jax_plan(case):
    """S' through both partition plans, on the JAX operator."""
    _, _, A_bf, _, _, _ = case
    n = A_bf.shape[0]
    rng = np.random.default_rng(0)
    zs = rng.standard_normal((n, 2)) + 1j * rng.standard_normal((n, 2))
    pp = partition_apply_plan(linop_from_numpy(A_bf), device="cpu")
    got = pp.apply_complex(zs)
    assert _rel(got, jax_plan(A_bf).apply_complex(zs)) < 1e-5
    assert _rel(got, A_bf.matmat(zs)) < 1e-5


def test_host_system_matches_jax(case):
    """The port's host system (its own tree, fac and correction) against
    the JAX script's: the MVP to 1e-12 and host GMRES's iterations."""
    sys_t, card, _, sys_j, perm, rhs = case
    np.testing.assert_array_equal(card.perm, perm)
    n = sys_t.shape[0]
    x = np.random.default_rng(1).standard_normal(n) + 0j
    assert _rel(sys_t.matvec(x), sys_j.matvec(x)) < 1e-12
    got = solve_gmres(sys_t, rhs[perm], tol=1e-10, max_iter=400)
    want = jax_gmres(sys_j, rhs[perm], tol=1e-10, max_iter=400)
    assert got.converged and want.converged
    assert got.num_iter == want.num_iter
    assert _rel(got.x, np.asarray(want.x)) < 1e-8


def test_card_path_on_cpu_helm2_bie(bie):
    """The card composition (plan + corrector + solve_gmres_plan) with
    device="cpu": converged, density within 1e-5 of the dense LU, the
    field within the JAX test's 1e-5."""
    prob = bie[0]
    rec = helm2_bie.solve(prob)
    assert rec["gmres_converged"] and rec["gmres_rel_res"] < 3e-6
    assert rec["mvp_rel"] < 1e-6
    assert rec["density_rel_vs_dense_lu"] <= 1e-5
    assert rec["field_rel_err"] <= 1e-5
    assert rec["k2_launches"] == 0 and rec["apply_ms_r1"] is None


def test_card_path_on_cpu_multiple_scattering(scattering):
    """As for helm2_bie, with the scattering field's 1e-4; the float32
    floor's two sources are reported, each under 10 x tol here."""
    rec = multiple_scattering.solve(scattering[0])
    assert rec["gmres_converged"] and rec["gmres_rel_res"] < 3e-6
    assert rec["mvp_rel"] < 1e-6
    assert rec["density_rel_vs_dense_lu"] <= 1e-5
    assert rec["field_rel_err"] <= 1e-4
    assert max(rec["floor_from_plan"], rec["floor_from_corrector"]) < 3e-6
    assert rec["k2_launches"] == 0 and rec["gmres_s"] > 0


def test_complex_card_gmres_against_jax_host_gmres(case):
    """The card path's complex basis (on the CPU, the twins' settings):
    converged with a true residual < 10 x tol, at most 1.1x the JAX
    script's host complex GMRES iterations (tol 1e-10), its density within
    2e-5 of the host's."""
    _, card, _, sys_j, perm, rhs = case
    want = jax_gmres(sys_j, rhs[perm], tol=1e-10, max_iter=400)
    tol = 3e-7
    sigma, res, secs, launches = card.solve(rhs, tol, restart=400,
                                            max_iter=400)
    assert want.converged and res.converged
    assert res.residuals[-1] < 10 * tol
    assert res.x.dtype == np.complex64 and launches == 0 and secs > 0
    assert res.num_iter <= 1.1 * want.num_iter
    assert _rel(res.x, np.asarray(want.x)) <= 2e-5
    want_sigma = np.empty_like(np.asarray(want.x))
    want_sigma[perm] = np.asarray(want.x)
    assert _rel(sigma, want_sigma) <= 2e-5


def test_card_system_is_complex_linear_to_its_mvp_error(case):
    """||S(i z) - i S(z)|| / ||S(z)|| of the card system (the plan is real:
    it applies the interleaved embedding) within twice the system's MVP
    error against the JAX host system; the complex apply is a view of the
    real one."""
    _, card, _, sys_j, perm, _ = case
    n = len(perm)
    rng = np.random.default_rng(3)
    z = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    zt = torch.from_numpy(z)
    Sz = card.sys_apply_complex(zt)
    dev = float(torch.linalg.vector_norm(card.sys_apply_complex(1j * zt)
                                         - 1j * Sz)
                / torch.linalg.vector_norm(Sz))
    mvp = _rel(Sz.numpy().astype(np.complex128),
               sys_j.matvec(z.astype(np.complex128)))
    assert mvp < 1e-6 and dev <= 2 * mvp
    real = card.sys_apply(torch.view_as_real(zt).reshape(-1))
    assert torch.equal(torch.view_as_real(Sz).reshape(-1), real)
    zo = np.empty_like(z)
    zo[perm] = z
    assert torch.equal(card.to_card_complex(zo), zt)
    assert torch.equal(card.to_card(zo), torch.view_as_real(zt).reshape(-1))
    np.testing.assert_array_equal(card.from_card(zt), zo)
    np.testing.assert_array_equal(card.from_card(card.to_card(zo)), zo)


_BIE_KEYS = {"n", "k", "mvp_rel", "gmres_tol", "gmres_iters", "gmres_s", "ms_per_iter",
             "k2_launches", "density_rel_vs_dense_lu", "field_rel_err",
             "plan_s", "windows", "weights_mb", "apply_ms_r1"}


def test_twins_on_cpu(capsys):
    rec = helm2_bie.main(["--n", "512", "--k", "10", "--device", "cpu"])
    assert _BIE_KEYS <= set(rec) and rec["device"] == "cpu"
    assert rec["field_rel_err"] <= 1e-5 and rec["gmres_converged"]
    rows = multiple_scattering.main(["--k", "10", "--per-boundary", "128",
                                     "--device", "cpu"])
    assert len(rows) == 1 and rows[0]["field_rel_err"] <= 1e-4
    out = capsys.readouterr().out
    for line in ("MVP rel l2 error:", "dense LU solve", "BF GMRES solve:",
                 "butterfly field rel l2 error vs exact:",
                 "card GMRES solve:", "sweep row: k=10 n=384"):
        assert line in out
    assert multiple_scattering.sweep_per_boundary(177.8) == 512
    assert [multiple_scattering.sweep_per_boundary(k)
            for k in np.logspace(0, 3, 13)[-3:]] == [768, 1408, 2432]
