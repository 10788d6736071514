"""The plain reference on tiny ellipses: its Hankel functions, its dense
S' and combined-field systems against the program's assembly and a direct
NumPy solve, and its control."""

from __future__ import annotations

import numpy as np
import pytest
import scipy.special as ss
import torch

from portbench.reference import bie
from portbench.reference.hankel import hankel1

BIE = {"ellipse": {"semi_major": 1.0, "semi_minor": 0.6,
                   "center": [0.0, 0.0], "theta": 0.1},
       "n": 256, "k": 10.0, "kr_order": 6, "layer": {"pot": "sprime"}}
CFIE = {"ellipse": {"semi_major": 1.0, "semi_minor": 0.7,
                    "center": [0.0, 0.0], "theta": 0.3},
        "n": 256, "k": 6.0,
        "layer": {"pot": "combined", "alpha_per_k": [0.0, -1.0],
                  "beta": [1.0, 0.0]}}
SRC = torch.tensor([[0.1, -0.05]], dtype=torch.float64)
THETA = np.linspace(0, 2 * np.pi, 25)[:-1]
TARGETS = torch.tensor(np.stack([3 * np.cos(THETA), 2.5 * np.sin(THETA)], 1))


@pytest.mark.parametrize("nu", [0, 1])
def test_hankel_matches_scipy(nu):
    x = torch.linspace(1e-4, 700.0, 200001, dtype=torch.float64)
    got = hankel1(nu, x).numpy()
    want = ss.hankel1(nu, x.numpy())
    assert np.max(np.abs(got - want) / np.abs(want)) < 5e-11


def _field_error(cfg: dict, data_pot: dict) -> tuple[float, float]:
    """(residual of NumPy's solve, exterior field error against the point
    source) for the interior source's boundary data."""
    p = bie.Problem(cfg)
    A = p.dense(p.system_rows).numpy()
    f = bie.kernel(data_pot, p.k, p.x, SRC, p.nrm, None)[:, 0].numpy()
    sigma = np.linalg.solve(A, f)
    res = bie.solve_residuals(p, f[:, None], sigma[:, None])[0]
    rep = {"pot": "single"} if p.layer["pot"] == "sprime" else p.layer
    u = (bie.kernel(rep, p.k, TARGETS, p.x, None, p.nrm).numpy()
         @ (p.boundary.weights * sigma))
    ue = bie.kernel({"pot": "single"}, p.k, TARGETS, SRC).numpy()[:, 0]
    return res, float(np.linalg.norm(u - ue) / np.linalg.norm(ue))


def test_sprime_system_solves_the_exterior_neumann_problem():
    res, err = _field_error(BIE, {"pot": "sprime"})
    assert res < 1e-13
    assert err < 1e-4  # Kapur-Rokhlin order 6 at n=256, k=10: ~4e-5


def test_combined_field_converges_to_the_exterior_dirichlet_field():
    # the trapezoid rule with the diagonal dropped converges slowly
    errs = [_field_error(dict(CFIE, n=n), {"pot": "single"}) for n in
            (128, 512)]
    assert all(res < 1e-13 for res, _ in errs)
    # about O(h): 0.154 at n=128, 0.050 at n=512
    assert errs[1][1] < 0.5 * errs[0][1] and errs[1][1] < 0.1


def test_systems_match_the_programs_assembly():
    from butterfly_tpu_torch.geom import Ellipse
    from butterfly_tpu_torch.ops.helm2 import Helm2, LayerPot
    from butterfly_tpu_torch.ops.quadrature import kr_correction

    p = bie.Problem(BIE)
    X, _, N, w = Ellipse(1.0, 0.6, (0.0, 0.0), 0.1).sample_linspaced(256)
    h = Helm2(k=10.0, layer_pot=LayerPot.PV_NORMAL_DERIV_SINGLE)

    def kij(i, j):
        return h.kernel_matrix(X[j:j + 1], X[i:i + 1], None, N[i:i + 1])[0, 0]

    A = (h.kernel_matrix(X, X, None, N)
         + kr_correction(6, 256, kij).materialize()) * w[None, :]
    A += 0.5 * np.eye(256)
    got = p.dense(p.system_rows).numpy()
    assert np.abs(got - A).max() < 1e-11 * np.abs(A).max()

    q = bie.Problem(CFIE)
    X, _, N, w = Ellipse(1.0, 0.7, (0.0, 0.0), 0.3).sample_linspaced(256)
    h = Helm2(k=6.0, layer_pot=LayerPot.COMBINED_FIELD, alpha=-6j, beta=1.0)
    A = h.kernel_matrix(X, X, N, None) * w[None, :] + 0.5 * np.eye(256)
    got = q.dense(q.system_rows).numpy()
    assert np.abs(got - A).max() < 1e-11 * np.abs(A).max()


def test_blocks_of_rows_agree_with_the_whole(monkeypatch):
    p = bie.Problem(BIE)
    whole = p.matmul(p.system_rows, torch.eye(256, dtype=torch.complex128))
    monkeypatch.setattr(bie, "BLOCK_ENTRIES", 256 * 37)
    blocks = p.matmul(p.system_rows, torch.eye(256, dtype=torch.complex128))
    assert torch.equal(whole, blocks)


def test_control_reads_tf32_rounding():
    p = bie.Problem(BIE)
    f = bie.kernel({"pot": "sprime"}, p.k, p.x, SRC, p.nrm, None)
    res = bie.solve_residuals(p, f, bie.control_solve(p, f))
    assert 2e-5 < res[0] < 2e-3
    X = torch.randn((256, 4), dtype=torch.complex128,
                    generator=torch.Generator().manual_seed(0))
    err = bie.apply_errors(p, X, bie.control_apply(p, X))
    assert np.all((err > 2e-5) & (err < 2e-3))


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -(1.0 + 2 ** -12)], dtype=torch.float32)
    got = bie.round_tf32(x).tolist()
    assert got == [1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, -1.0]
