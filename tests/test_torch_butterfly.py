"""The port's UniformButterfly against the JAX package's, on the same weights.

Weights are made with numpy and handed to both packages (the port through
`butterfly_tpu_torch.convert`); both apply them on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from butterfly_tpu.ops.butterfly import UniformButterfly as JaxButterfly
from butterfly_tpu_torch.convert import uniform_butterfly_from_numpy
from butterfly_tpu_torch.ops.butterfly import random_butterfly


def _weights(NB, blk, num_levels, with_leaf, seed, dtype):
    rng = np.random.default_rng(seed)
    leaf = (rng.standard_normal((NB, blk, blk)) / np.sqrt(blk)
            if with_leaf else None)
    levels = [rng.standard_normal((NB // 2 ** (l + 1), 2, 2, 2 ** l, blk, blk))
              / np.sqrt(2 * blk) for l in range(num_levels)]
    cast = (lambda a: None if a is None else a.astype(dtype))
    return cast(leaf), [cast(W) for W in levels]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


# (dtype, tolerance): f64 agrees to rounding, f32 to f32 summation order
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-6)])
@pytest.mark.parametrize("NB,blk,num_levels,with_leaf",
                         [(8, 4, 3, True), (16, 8, 2, False),
                          (32, 4, 5, True)])
def test_apply_matches_jax(NB, blk, num_levels, with_leaf, dtype, tol):
    leaf, levels = _weights(NB, blk, num_levels, with_leaf, NB + blk, dtype)
    jb = JaxButterfly(None if leaf is None else jnp.asarray(leaf),
                      [jnp.asarray(W) for W in levels], 2)
    tb = uniform_butterfly_from_numpy(leaf, levels, 2, device="cpu")
    x = np.random.default_rng(1).standard_normal((jb.shape[1], 5)).astype(
        dtype)
    want = np.asarray(jb.apply(jnp.asarray(x)))
    got = tb.apply(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype
    assert _rel(got, want) <= tol
    # vector operand
    gv = tb.apply(torch.from_numpy(x[:, 0])).numpy()
    assert gv.shape == (jb.shape[0],)
    assert _rel(gv, want[:, 0]) <= tol
    assert tb.shape == jb.shape and tb.num_levels == jb.num_levels
    assert tb.flops_per_col() == jb.flops_per_col()
    assert tb.nbytes() == jb.nbytes()


def test_astype_bf16_matches_jax():
    leaf, levels = _weights(16, 8, 4, True, 3, np.float32)
    jb = JaxButterfly(jnp.asarray(leaf), [jnp.asarray(W) for W in levels],
                      2).astype(jnp.bfloat16)
    tb = uniform_butterfly_from_numpy(leaf, levels, 2,
                                      device="cpu").astype(torch.bfloat16)
    assert tb.dtype == torch.bfloat16
    assert tb.nbytes() == jb.nbytes()
    x = np.random.default_rng(4).standard_normal((jb.shape[1], 6)).astype(
        np.float32)
    want = np.asarray(jb.apply(jnp.asarray(x)), np.float64)
    got = tb.apply(torch.from_numpy(x))
    assert got.dtype == torch.float32  # the last bf16 level sums in f32
    assert _rel(got.numpy(), want) <= 2e-2


def test_to_linop_materializes_dense():
    leaf, levels = _weights(8, 4, 3, True, 5, np.float64)
    jb = JaxButterfly(jnp.asarray(leaf), [jnp.asarray(W) for W in levels], 2)
    tb = uniform_butterfly_from_numpy(leaf, levels, 2, device="cpu")
    dense = tb.to_linop().materialize()
    assert np.allclose(dense, jb.to_linop().materialize(), rtol=0,
                       atol=1e-13)
    x = np.random.default_rng(6).standard_normal((tb.shape[1], 3))
    got = tb.apply(torch.from_numpy(x)).numpy()
    assert _rel(got, dense @ x) <= 1e-12


def test_random_butterfly_shapes_and_scale():
    g = torch.Generator().manual_seed(0)
    bf = random_butterfly(16, 8, num_levels=3, generator=g, device="cpu")
    assert bf.shape == (128, 128) and bf.num_levels == 3
    assert [tuple(W.shape) for W in bf.levels] == [
        (8, 2, 2, 1, 8, 8), (4, 2, 2, 2, 8, 8), (2, 2, 2, 4, 8, 8)]
    # scaled so the chain neither explodes nor vanishes
    x = torch.randn(128, 64, generator=g)
    ratio = float(bf.apply(x).norm() / x.norm())
    assert 0.3 < ratio < 3.0
