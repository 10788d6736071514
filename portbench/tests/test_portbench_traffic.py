"""The general traffic generator: every seed draws the same amount of work,
the same seed the same inputs."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from portbench import harness, traffic
from portbench.reference import geometry

CONFIG = json.loads((harness.ROOT / "portbench" / "configs"
                     / "helm2_bie_k40.json").read_text())
SMALL = dict(CONFIG, n=256, k=10.0)


def test_rhs_pool_is_fixed_by_the_seed():
    tr = {"rhs": {"kind": "sprime_point_source", "region_scale": 0.5},
          "pool": 12}
    a = traffic.rhs_pool(SMALL, tr, 2**31 + 11)
    b = traffic.rhs_pool(SMALL, tr, 2**31 + 11)
    c = traffic.rhs_pool(SMALL, tr, 2**31 + 12)
    assert a.shape == c.shape == (12, 256)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert np.all(np.isfinite(a))


def test_sources_lie_inside_the_scaled_ellipse_one_a_stratum():
    spec = CONFIG["ellipse"]
    gen = traffic.rng(7, "rhs")
    pts = traffic.source_points(spec, 0.5, 512, gen)
    # back to the ellipse's own frame: inside the half-size ellipse
    rot = geometry.rotation(spec["theta"])
    local = (pts - np.asarray(spec["center"])) @ rot
    rho = np.hypot(local[:, 0] / spec["semi_major"],
                   local[:, 1] / spec["semi_minor"])
    assert rho.max() < 0.5
    # 16 rings of equal area, 32 points in each
    ring = np.floor(16 * (rho / 0.5) ** 2).astype(int)
    assert np.array_equal(np.bincount(ring, minlength=16), np.full(16, 32))


def test_order_and_blocks_are_fixed_by_the_seed():
    assert np.array_equal(traffic.order(2**33, 16), traffic.order(2**33, 16))
    assert sorted(traffic.order(2**33, 16)) == list(range(16))
    tr = {"cols": 4, "pool": 3}
    a = traffic.block_pool(8, tr, 2**31 + 1, "cpu")
    b = traffic.block_pool(8, tr, 2**31 + 1, "cpu")
    assert len(a) == 3 and a[0].dtype == torch.float32
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1])
