"""The rest of the fac -> device bridge against the JAX package:
`interleaved_real_op`, the batched host distillation, the device
distillation, the one-shot `fused_apply`, and a CPU run of the
`real_fac_scale` twin.

Both packages get the same numpy inputs. Distilled factors are compared by
their applies (SVD signs may differ between LAPACK paths); the JAX fused
apply runs K1 in Pallas interpret mode, the port's the plain pass a CPU
tensor takes.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from butterfly_tpu.fac.distill import distill_butterfly_batch as jax_batch
from butterfly_tpu.fac.distill import distill_butterfly_device as jax_device
from butterfly_tpu.fac.distill import interleaved_real_op as jax_interleaved
from butterfly_tpu.ops.linop import Dense as JaxDense
from butterfly_tpu.ops.pallas_butterfly import fused_apply as jax_fused_apply
from butterfly_tpu_torch.convert import uniform_butterfly_from_numpy
from butterfly_tpu_torch.examples import real_fac_scale
from butterfly_tpu_torch.fac.distill import (
    distill_butterfly_batch,
    distill_butterfly_device,
    interleaved_real_op,
)
from butterfly_tpu_torch.ops.fused_butterfly import (
    FusedButterflyPlan,
    fused_apply,
)
from butterfly_tpu_torch.ops.linop import Dense


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


def _fourier(n, m):
    x = (np.arange(n) + 0.5) / n
    k = np.arange(m)
    return np.cos(np.pi * np.outer(x, k)) * np.sqrt(2.0 / n)


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _batch():
    """(4, 256, 256): DCT matrices of shifted sample points."""
    x = (np.arange(256) + 0.5) / 256
    return np.stack([np.cos(np.pi * np.outer(x + 0.1 * b, np.arange(256)))
                     * np.sqrt(2.0 / 256) for b in range(4)])


def test_interleaved_real_op_matches_jax():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((24, 16)) + 1j * rng.standard_normal((24, 16))
    X = rng.standard_normal((32, 5))
    got = interleaved_real_op(Dense(A))
    want = jax_interleaved(JaxDense(A))
    assert got.shape == (48, 32) and got.dtype == np.float64
    np.testing.assert_allclose(got.matmat(X), want.matmat(X), rtol=0,
                               atol=1e-12)
    z = X[0::2] + 1j * X[1::2]
    y = got.matmat(X)
    assert _rel(y[0::2] + 1j * y[1::2], A @ z) < 1e-12


def test_distill_batch_matches_jax_and_block_diag():
    M = _batch()
    x = np.random.default_rng(1).standard_normal((4 * 256, 6))
    got = distill_butterfly_batch(M, 8, 64, dtype=torch.float64,
                                  workers=2, device="cpu")
    want = jax_batch(M, 8, 64, dtype=np.float64, workers=2)
    np.testing.assert_array_equal(got.row_perm, want.row_perm)
    y = got.apply(torch.from_numpy(x)).numpy()
    assert _rel(y, np.asarray(want.apply(jnp.asarray(x)))) < 1e-10
    dense = np.concatenate([M[b] @ x[b * 256:(b + 1) * 256]
                            for b in range(4)])
    assert _rel(y, dense[got.row_perm]) < 1e-6
    # float32 weights: the f32 storage floor
    got32 = distill_butterfly_batch(M, 8, 64, workers=2, device="cpu")
    y32 = got32.apply(torch.from_numpy(x).float()).double().numpy()
    assert got32.bf.dtype == torch.float32
    assert _rel(y32, dense[got.row_perm]) < 1e-6


@pytest.fixture(scope="module")
def device_distilled():
    Phi = _fourier(1024, 512).astype(np.float32)
    got = distill_butterfly_device(torch.from_numpy(Phi), 16, rank=64)
    want = jax_device(jnp.asarray(Phi), 16, rank=64)
    return Phi, got, want


def test_distill_device_against_dense_and_jax(device_distilled):
    Phi, got, want = device_distilled
    assert got.bf.dtype == torch.float32
    np.testing.assert_array_equal(got.row_perm, want.row_perm)
    x = np.random.default_rng(5).standard_normal((512, 8)).astype(np.float32)
    y = got.apply_canonical(torch.from_numpy(x)).double().numpy()
    dense = Phi.astype(np.float64) @ x
    assert _rel(y, dense) < 1e-5
    y_jax = np.asarray(want.apply_canonical(x), dtype=np.float64)
    assert _rel(y, y_jax) < 2e-5
    assert got.max_sv_discarded < 1e-5 * got.sigma_max
    assert abs(got.sigma_max - float(want.sigma_max)) < 1e-5 * got.sigma_max


def test_distill_device_batch_folds_into_blocks():
    M = _batch().astype(np.float32)
    got = distill_butterfly_device(torch.from_numpy(M), 8, rank=64)
    x = np.random.default_rng(2).standard_normal((4 * 256, 3))
    y = got.apply(torch.from_numpy(x).float()).double().numpy()
    dense = np.concatenate([M[b].astype(np.float64) @ x[b * 256:(b + 1) * 256]
                            for b in range(4)])
    assert got.bf.NB == 32 and got.bf.num_levels == 3
    assert _rel(y, dense[got.row_perm]) < 1e-5


def test_fused_apply_matches_jax(device_distilled):
    _, _, want = device_distilled
    jbf = want.bf
    bf = uniform_butterfly_from_numpy(
        np.asarray(jbf.leaf), [np.asarray(W) for W in jbf.levels],
        precision="highest", device="cpu")
    x = np.random.default_rng(3).standard_normal((512, 40)).astype(
        np.float32)
    y = fused_apply(bf, torch.from_numpy(x)).numpy()
    y_jax = np.asarray(jax_fused_apply(jbf, jnp.asarray(x)))
    assert _rel(y, y_jax) < 1e-5
    plan_y = FusedButterflyPlan(bf, fuse=3, device="cpu").apply(
        torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(y, plan_y)


def test_real_fac_scale_twin_on_cpu(capsys):
    rec = real_fac_scale.main(["--n", "1024", "--m", "256", "--r", "8",
                               "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out == rec
    assert {"n", "m", "stream_s", "distill_s", "rank", "weights_mb",
            "dense_mb", "compression_ratio", "apply_ms", "apply_tflops",
            "rel_err_vs_dense", "device"} <= set(rec)
    assert rec["rel_err_vs_dense"] < 1e-6
    assert all(rec[key] is None for key in (
        "apply_ms", "apply_tflops", "plain_ms", "library_ms", "dense_ms"))
    assert rec["device"] == "cpu"
