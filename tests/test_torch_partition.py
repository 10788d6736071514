"""The port's partition apply (fac/partition.py) against the JAX package's
and against the operator's own action in float64.

One `make_multilevel` operator, built by the JAX package and carried across
with `linop_from_numpy`, goes to both `PartitionPlan`s. The JAX plan runs
its cell kernel K2 in Pallas interpret mode; the port's runs `cells_plain`,
which any CPU tensor takes. The low-rank factorizations draw different
random sketches, so the plans are compared by their applies.
"""

import numpy as np
import pytest
import torch

from butterfly_tpu.fac import helm2 as jax_fac_helm2
from butterfly_tpu.fac.partition import partition_apply_plan as jax_plan
from butterfly_tpu.geom import Ellipse
from butterfly_tpu.ops.helm2 import Helm2, LayerPot
from butterfly_tpu.trees import Quadtree
from butterfly_tpu_torch.convert import linop_from_numpy
from butterfly_tpu_torch.fac.partition import partition_apply_plan


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


def _operator(nE, k):
    X, _, Nrm, _ = Ellipse(1.0, 0.7, (0.0, 0.0), 0.3).sample_linspaced(nE)
    tree = Quadtree(X, leaf_size=32, normals=Nrm)
    return jax_fac_helm2.make_multilevel(
        Helm2(k=k, layer_pot=LayerPot.SINGLE), tree, tree)


def _rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.fixture(scope="module")
def helm_fac():
    """tests/test_partition.py's fixture (1024 points, k=30: dense blocks
    only), the JAX plan's apply and the oracle on one probe."""
    nE = 1024
    A = _operator(nE, 30.0)
    rng = np.random.default_rng(0)
    zs = rng.standard_normal((nE, 3)) + 1j * rng.standard_normal((nE, 3))
    return A, zs, A.matmat(zs), jax_plan(A).apply_complex(zs)


@pytest.mark.parametrize("limit", [6 << 30, 0],
                         ids=["default", "host_chains"])
def test_partition_matches_jax_and_oracle(helm_fac, limit):
    A, zs, want, got_jax = helm_fac
    pp = partition_apply_plan(linop_from_numpy(A), device="cpu",
                              dense_materialize_limit_bytes=limit)
    got = pp.apply_complex(zs)
    assert _rel(got, want) < 2e-5
    assert _rel(got, got_jax) < 2e-5
    np.testing.assert_array_equal(pp.apply_complex(zs), got)


@pytest.fixture(scope="module")
def separated_fac():
    """2048 points at k=40: the partition holds separated butterfly
    blocks."""
    nE = 2048
    A = _operator(nE, 40.0)
    rng = np.random.default_rng(2)
    zs = rng.standard_normal((nE, 3)) + 1j * rng.standard_normal((nE, 3))
    return linop_from_numpy(A), zs, A.matmat(zs)


def test_partition_oversized_blocks_via_stage_plans(separated_fac):
    """A 256 tile cap turns every separated block into an oversized one,
    applied through its own packed stage plan (tests/test_partition.py's
    oversized case)."""
    A, zs, want = separated_fac
    pp = partition_apply_plan(A, bf_tiles=(256,), device="cpu",
                              dense_materialize_limit_bytes=0)
    assert pp._mega and pp.cells1 is None
    assert _rel(pp.apply_complex(zs), want) < 2e-5


@pytest.mark.parametrize("limit", [6 << 30, 0],
                         ids=["device_materialized", "host_chains"])
def test_partition_low_rank_classes(separated_fac, limit):
    """The default tiles factor the separated blocks as low-rank classes
    (the bench path): member windows sliced from the operator materialized
    through a packed plan, or multiplied out from their chains on the host;
    both factorizations reproduce the operator."""
    A, zs, want = separated_fac
    pp = partition_apply_plan(A, device="cpu",
                              dense_materialize_limit_bytes=limit)
    assert pp.cells1 is not None and not pp._mega
    assert [m["cls"] for m in pp._lr_meta] == [512, 1024]
    assert 0 < pp.useful_flops_per_col() < pp.flops_per_col()
    assert _rel(pp.apply_complex(zs), want) < 2e-5


@pytest.fixture(scope="module")
def combined_field():
    """The BIE operator of the scale twin (combined field, ppw 64, leaf 64)
    at n=2048, built by the port, with a probe and its exact action."""
    from butterfly_tpu_torch.fac import helm2 as fac_helm2
    from butterfly_tpu_torch.geom import Ellipse as PEllipse
    from butterfly_tpu_torch.ops.helm2 import Helm2 as PHelm2
    from butterfly_tpu_torch.ops.helm2 import LayerPot as PLayerPot
    from butterfly_tpu_torch.trees import Quadtree as PQuadtree

    n = 2048
    X, _, Nrm, w = PEllipse(1.0, 0.7, (0.0, 0.0), 0.3).sample_linspaced(n)
    k = 2 * np.pi * n / (64.0 * float(np.sum(w)))
    tree = PQuadtree(X, leaf_size=64, normals=Nrm)
    A = fac_helm2.make_multilevel(
        PHelm2(k=k, layer_pot=PLayerPot.COMBINED_FIELD, alpha=-1j * k,
               beta=1.0), tree, tree)
    rng = np.random.default_rng(0)
    zs = rng.standard_normal((n, 2)) + 1j * rng.standard_normal((n, 2))
    return A, zs, A.matmat(zs)


def test_combined_field_windows_need_more_than_the_f32_packed_apply(
        combined_field):
    """A plan whose low-rank windows are multiplied out from their chains
    in float64 reads under 3e-7 against `A.matmat`; the float32 packed
    apply, which the JAX package materializes to slice the windows from,
    reads at least 1.5x that. So windows sliced from a float32
    materialization would cap the plan's accuracy (at n=16384 such a plan
    read 8.0e-7 on the row oracle on the card, and GMRES took 18
    iterations through it where the TPU record took 12)."""
    from butterfly_tpu_torch.ops.packed import pack

    A, zs, want = combined_field
    pp = partition_apply_plan(A, device="cpu",
                              dense_materialize_limit_bytes=0)
    assert pp.cells1 is not None and pp.windows == "host_chains"
    rel_chains = _rel(pp.apply_complex(zs), want)
    packed = pack(A, block_align=64, real_embed=True, device="cpu")
    rel_packed = _rel(packed(zs).numpy(), want)
    assert rel_chains < 3e-7
    assert rel_packed > 1.5 * rel_chains


def test_combined_field_device_windows_are_sliced_from_float64(
        combined_field):
    """The default path materializes the whole operator through a float64
    packed plan and slices the windows from it: it reads under 3e-7, like
    the host-chain plan, where a float32 materialization could not."""
    A, zs, want = combined_field
    pp = partition_apply_plan(A, device="cpu")
    assert pp.cells1 is not None and pp.windows == "device_f64"
    assert _rel(pp.apply_complex(zs), want) < 3e-7


def test_float64_factoring_passes_the_float32_floor():
    """Two 512 x 512 windows of exact rank 60 (singular values 1 down to
    1e-9): factored in float32 (the JAX package's precision), the probe
    residual stays near 6e-7 at rank 64 and 128, above `_LR_TOL` and
    falling less than 2x, which the JAX package's escalation takes for a
    floor; the plan's float64 escalation meets `_LR_TOL` at rank 64 at
    once, and U V, rounded to float32 as K2 applies them, is within
    `_LR_TOL` of the window in float64."""
    from butterfly_tpu_torch.fac import partition as part

    rng = np.random.default_rng(0)
    Z = []
    for _ in range(2):
        U, _ = np.linalg.qr(rng.standard_normal((512, 60)))
        V, _ = np.linalg.qr(rng.standard_normal((512, 60)))
        Z.append((U * np.geomspace(1.0, 1e-9, 60)) @ V.T)
    Z = torch.from_numpy(np.stack(Z))
    rel32 = [part._factor_batch(Z.float(), rho)[2] for rho in (64, 128)]
    assert min(rel32) > part._LR_TOL and rel32[1] > 0.5 * rel32[0]
    U, V, rel64, rho64, steps64 = part._escalate(Z, 64, part._LR_TOL)
    assert len(steps64) == 1 and rho64 == 64 and rel64 <= part._LR_TOL
    UV = U.float().double() @ V.float().double()
    assert float((Z - UV).norm() / Z.norm()) <= part._LR_TOL


def test_oversized_blocks_share_one_float64_stage_plan(separated_fac):
    """With every separated block oversized (a 256 tile cap), all of their
    chains go into one float64 stage plan, whose part of the apply agrees
    with the chains applied on the host in float64 to 1e-12 (the input is
    float32, so it is exact in both), and the whole apply stays within
    2e-5 of the operator."""
    from butterfly_tpu_torch.fac import partition as part

    A, zs, want = separated_fac
    pp = partition_apply_plan(A, bf_tiles=(256,), device="cpu",
                              dense_materialize_limit_bytes=0)
    assert _rel(pp.apply_complex(zs), want) < 2e-5
    _, _, _, mega_blks = part._split_blocks(A, True, 256)
    assert pp.num_oversized == len(mega_blks) > 1 and len(pp._mega) == 1
    sp, in_idx, out_idx = pp._mega[0]
    assert sp.dtype == np.float64 and sp.real_embed
    z = zs.astype(np.complex64)
    x = np.empty((2 * z.shape[0], z.shape[1]), np.float32)
    x[0::2], x[1::2] = z.real, z.imag
    y = torch.zeros((pp.n2, z.shape[1]), dtype=torch.float64)
    y.index_add_(0, out_idx,
                 sp.apply_stacked(torch.from_numpy(x).index_select(0, in_idx)))
    got = (y[0::2] + 1j * y[1::2]).numpy()
    zc = z.astype(np.complex128)
    ref = np.zeros_like(got)
    for b in mega_blks:
        c = b.chain
        i0, j0 = b.i0 // 2, b.j0 // 2
        ref[i0:i0 + b.nr // 2] += c.src_scale * c.src.matmat(
            zc[j0:j0 + b.nc // 2])
    assert _rel(got, ref) <= 1e-12
