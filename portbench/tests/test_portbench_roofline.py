"""The roofline's counting functions on a tiny host factorization, and its
arithmetic."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import roofline


@pytest.fixture(scope="module")
def fac():
    from butterfly_tpu_torch.fac import helm2 as fac_helm2
    from butterfly_tpu_torch.geom import Ellipse
    from butterfly_tpu_torch.ops.helm2 import Helm2, LayerPot
    from butterfly_tpu_torch.trees import Quadtree

    X, _, N, _ = Ellipse(1.0, 0.6, (0.0, 0.0), 0.1).sample_linspaced(512)
    helm = Helm2(k=10.0, layer_pot=LayerPot.PV_NORMAL_DERIV_SINGLE)
    tree = Quadtree(X, leaf_size=32, normals=N)
    return fac_helm2.make_multilevel(helm, tree, tree)


def test_entries_are_the_stored_complex_weights(fac):
    entries, cplx = roofline.stored_entries(fac)
    assert cplx
    # every leaf of the S' factorization is dense complex128
    assert entries == fac.nbytes() // 16
    assert 0 < entries <= 512 * 512


def test_work_per_column(fac):
    entries, _ = roofline.stored_entries(fac)
    one, many = roofline.operator_work(fac, 1), roofline.operator_work(fac, 64)
    assert one.flops == 8 * entries and many.flops == 64 * one.flops
    # weights once in complex64, each input and output element once
    assert one.bytes == 8 * entries + 8 * (512 + 512)
    assert many.bytes == 8 * entries + 64 * 8 * (512 + 512)


def test_share_against_the_published_peaks():
    work = roofline.Work(flops=67e9, bytes=3.35e9)  # 1 ms at either peak
    got = roofline.roofline_share(work, 4e-3, "NVIDIA H100 80GB HBM3")
    assert got["share_pct"] == pytest.approx(25.0)
    work = roofline.Work(flops=1.0, bytes=6.7e9)
    got = roofline.roofline_share(work, 4e-3, "NVIDIA H100 80GB HBM3")
    assert got["bound"] == "bytes" and got["share_pct"] == pytest.approx(50.0)


def test_unknown_leaf_with_weights_is_refused():
    class Leaf:
        shape = (4, 4)

        def children(self):
            return ()

        def nbytes(self):
            return 64

    class Node:
        shape = (4, 4)

        def children(self):
            return (Leaf(),)

    with pytest.raises(TypeError, match="no work model"):
        roofline.stored_entries(Node())


def test_real_dense_leaves_count_float32():
    class Dense:
        def __init__(self):
            self.data = np.ones((3, 5))
            self.shape = (3, 5)

        def children(self):
            return ()

    w = roofline.operator_work(Dense(), 2)
    assert w.flops == 2 * 15 * 2 and w.bytes == 4 * 15 + 4 * 8 * 2
