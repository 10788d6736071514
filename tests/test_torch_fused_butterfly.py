"""The port's FusedButterflyPlan against the JAX package's fused kernel.

The JAX side runs K1 as its own tests do, in Pallas interpret mode on the
CPU (`tests/test_pallas_butterfly.py`). The port's plan runs its plain
PyTorch pass (`pass_plain`), which is what a CPU tensor takes; the CUDA
kernel itself is held against that plain pass on the card by
`chip_smoke.py`. Both packages get the same numpy weights and inputs.

Tolerances: f32 1e-5 (summation order); bf16 2e-2 against the JAX bf16
plan (a bf16 rounding can flip when the order differs) and 5e-2 against
f32 (bf16 rounding itself).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from butterfly_tpu.ops.butterfly import UniformButterfly as JaxButterfly
from butterfly_tpu.ops.pallas_butterfly import (
    FusedButterflyPlan as JaxFusedPlan,
)
from butterfly_tpu_torch.convert import uniform_butterfly_from_numpy
from butterfly_tpu_torch.ops.fused_butterfly import (
    FusedButterflyPlan,
    pass_plain,
)
from butterfly_tpu_torch.utils.errors import InvalidArgumentsError


def _weights(NB, ranks, k_in, num_levels, with_leaf, seed):
    """f32 numpy factors; `ranks[l]` is level l-1's output rank (ranks[0]
    the leaf's), so ranks may vary from level to level."""
    rng = np.random.default_rng(seed)
    leaf = None
    if with_leaf:
        leaf = (rng.standard_normal((NB, ranks[0], k_in))
                / np.sqrt(k_in)).astype(np.float32)
    levels = []
    for l in range(num_levels):
        k = ranks[l] if (with_leaf or l) else k_in
        levels.append((rng.standard_normal(
            (NB // 2 ** (l + 1), 2, 2, 2 ** l, ranks[l + 1], k))
            / np.sqrt(2 * k)).astype(np.float32))
    return leaf, levels


def _both(leaf, levels):
    jb = JaxButterfly(None if leaf is None else jnp.asarray(leaf),
                      [jnp.asarray(W) for W in levels], 2)
    tb = uniform_butterfly_from_numpy(leaf, levels, 2, device="cpu")
    return jb, tb


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _x(n, r, seed):
    shape = (n,) if r is None else (n, r)
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize(
    "NB,ranks,k_in,num_levels,with_leaf,fuse,r",
    [(8, [8] * 4, 8, 3, True, 1, 16),        # (8, 8, 1)
     (8, [8] * 4, 8, 3, True, 2, 16),        # (8, 8, 2)
     (16, [8] * 5, 8, 4, False, 2, None),    # no leaf, vector
     (8, [5, 7, 3, 6], 4, 3, True, 2, 9)],   # ranks vary by level
    ids=["8-8-1", "8-8-2", "noleaf-vector", "varying-ranks"])
def test_fused_f32_matches_jax_kernel(NB, ranks, k_in, num_levels,
                                      with_leaf, fuse, r):
    leaf, levels = _weights(NB, ranks, k_in, num_levels, with_leaf, NB + r
                            if r else NB)
    jb, tb = _both(leaf, levels)
    jplan = JaxFusedPlan(jb, fuse=fuse, r_tile=128, interpret=True)
    plan = FusedButterflyPlan(tb, fuse=fuse, device="cpu")
    assert plan.num_passes == jplan.num_passes
    x = _x(jb.shape[1], r, 2)
    want = np.asarray(jplan.apply(jnp.asarray(x)))
    got = plan.apply(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got.numpy(), want) <= 1e-5
    # and against the unfused einsum of both packages
    assert _rel(got.numpy(), np.asarray(jb.apply(jnp.asarray(x)))) <= 1e-5
    assert _rel(got.numpy(), tb.apply(torch.from_numpy(x)).numpy()) <= 1e-5


def test_fused_partial_depth_matches_jax_kernel():
    # fewer levels than log2(NB), uneven pass split (5 = 3 + 2)
    leaf, levels = _weights(64, [8] * 6, 8, 5, True, 5)
    jb, tb = _both(leaf, levels)
    jplan = JaxFusedPlan(jb, fuse=3, r_tile=128, interpret=True)
    plan = FusedButterflyPlan(tb, fuse=3, device="cpu")
    assert plan.num_passes == jplan.num_passes == 2
    assert [p.k for p in plan.passes] == [3, 2]
    x = _x(jb.shape[1], 8, 6)
    want = np.asarray(jplan.apply(jnp.asarray(x)))
    got = plan.apply(torch.from_numpy(x)).numpy()
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_fused_bf16_weights_match_jax_kernel(act):
    """bf16 weights with f32 or bf16 activations: each factor rounds its
    input to bf16 and sums in f32; bf16 activations are also rounded after
    every level."""
    leaf, levels = _weights(16, [8] * 5, 8, 4, True, 8)
    jb, tb = _both(leaf, levels)
    jplan = JaxFusedPlan(jb.astype(jnp.bfloat16), fuse=2, r_tile=128,
                         interpret=True, act_dtype=getattr(jnp, act))
    plan = FusedButterflyPlan(tb.astype(torch.bfloat16), fuse=2,
                              act_dtype=getattr(torch, act), device="cpu")
    x = _x(jb.shape[1], 4, 9)
    want16 = np.asarray(jplan.apply(jnp.asarray(x)).astype(jnp.float32))
    want32 = np.asarray(jb.apply(jnp.asarray(x)))
    got = plan.apply(torch.from_numpy(x))
    assert got.dtype == getattr(torch, act)
    got = got.float().numpy()
    assert _rel(got, want16) <= 2e-2
    assert _rel(got, want32) <= 5e-2


def test_fused_rejects_complex_and_bad_operands():
    leaf, levels = _weights(8, [8] * 4, 8, 3, True, 7)
    _, tb = _both(leaf, levels)
    with pytest.raises(InvalidArgumentsError):
        FusedButterflyPlan(tb.astype(torch.complex64), device="cpu")
    with pytest.raises(InvalidArgumentsError):
        FusedButterflyPlan(tb, act_dtype=torch.float64, device="cpu")
    plan = FusedButterflyPlan(tb, device="cpu")
    with pytest.raises(InvalidArgumentsError):
        plan.apply(torch.zeros(tb.shape[1] + 1, 2))


def test_pass_weight_relayout_matches_unfused_levels():
    """The one-time re-layout into per-pass (hiG, loG, U, V, R*m, R*k)
    mixing matrices puts W[h, c, d, lo] of every level at the block the
    pass expects, and the plain passes reproduce the unfused einsum."""
    R = 2
    leaf, levels = _weights(16, [4, 5, 6, 3, 7], 4, 4, True, 11)
    _, tb = _both(leaf, levels)
    plan = FusedButterflyPlan(tb, fuse=3, device="cpu")
    l0 = 0
    for pm, ws in zip(plan.passes, plan._pass_weights):
        for t, Wp in enumerate(ws):
            W = levels[l0 + t]
            m, k = W.shape[4:]
            U, V = R ** (pm.k - 1 - t), R ** t
            for a in range(pm.hiG):
                for u in range(U):
                    for v in range(V):
                        for lg in range(pm.loG):
                            blk = Wp[a, lg, u, v].numpy()
                            h, lo = a * U + u, v * pm.loG + lg
                            for c in range(R):
                                for d in range(R):
                                    np.testing.assert_array_equal(
                                        blk[c * m:(c + 1) * m,
                                            d * k:(d + 1) * k],
                                        W[h, c, d, lo])
        l0 += pm.k
    x = torch.from_numpy(_x(tb.shape[1], 3, 12))
    cur = x
    for pm, ws in zip(plan.passes, plan._pass_weights):
        cur = pass_plain(pm, R, cur, plan._leafp if pm.has_leaf else None,
                         ws)
    assert _rel(cur.numpy(), tb.apply(x).numpy()) <= 1e-6


@pytest.mark.parametrize(
    "wdtype,ranks,k_in,NB,want",
    [("float32", [128] * 4, 128, 8, [(1, 64)] * 3),    # flagship blocks
     ("bfloat16", [128] * 4, 128, 8, [(1, 128)] * 3),
     # real-fac ranks: leaf (64, 32), levels of rank 64, last level m=128
     ("float32", [64] * 5 + [128], 32, 32, [(2, 64), (2, 64), (1, 64)])],
    ids=["f32-blk128", "bf16-blk128", "f32-real-fac-ranks"])
def test_pass_split_follows_shared_memory(wdtype, ranks, k_in, NB, want):
    """Passes are deepened while a CTA's tiles and weight ring fit in the
    H100's 227 KB of shared memory at the engine's widest column tile."""
    from butterfly_tpu_torch.ops.fused_butterfly import (
        _SMEM_LIMIT_BYTES,
        _maxrows,
        _pass_smem_bytes,
    )

    num_levels = len(ranks) - 1
    leaf, levels = _weights(NB, ranks, k_in, num_levels, True, 13)
    _, tb = _both(leaf, levels)
    wdt = getattr(torch, wdtype)
    plan = FusedButterflyPlan(tb.astype(wdt), fuse=8, device="cpu")
    assert [(p.k, p.r_tile) for p in plan.passes] == want
    for pm in plan.passes:
        rows = _maxrows(pm.dims, pm.blk_in, pm.leaf_dims)
        assert _pass_smem_bytes(wdt, 2 ** pm.k, rows,
                                pm.r_tile) <= _SMEM_LIMIT_BYTES
