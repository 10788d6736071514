"""The port's slot form and GPipe pipeline against the JAX package's.

`SlotButterfly` runs here in this process. `PipelinedButterfly` runs on
gloo ranks on the CPU: one spawn of eight ranks runs the (S, M) = (4, 4),
(4, 1) and (8, 2) cases (a 4-stage mesh takes the first four ranks, as the
JAX package's `make_stage_mesh` takes the first devices), and a second
spawn of three ranks checks that 3 stages over 4 levels raise, and
that the ranks' error reaches the caller as itself. The JAX side runs on the
conftest's eight virtual devices, on the same numpy weights. Tolerances:
perms exact, slot weights 1e-6, applies 1e-5 (the JAX tests').
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from butterfly_tpu.ops.butterfly import UniformButterfly as JaxButterfly
from butterfly_tpu.parallel.pipeline import (
    PipelinedButterfly as JaxPipelined,
    SlotButterfly as JaxSlot,
    make_stage_mesh as jax_stage_mesh,
)
from butterfly_tpu_torch.convert import uniform_butterfly_from_numpy
from butterfly_tpu_torch.parallel.launch import run_programs, run_ranks
from butterfly_tpu_torch.parallel.pipeline import (
    SlotButterfly,
    pipeline_program,
)
from butterfly_tpu_torch.utils.errors import InvalidArgumentsError

CASES = [(4, 4), (4, 1), (8, 2)]


def _weights(NB, blk, seed, with_leaf=True):
    rng = np.random.default_rng(seed)
    leaf = ((rng.standard_normal((NB, blk, blk)) / np.sqrt(blk)).astype(
        np.float32) if with_leaf else None)
    L = int(np.log2(NB))
    levels = [(rng.standard_normal((NB // 2 ** (l + 1), 2, 2, 2 ** l, blk,
                                    blk)) / np.sqrt(2 * blk)).astype(
        np.float32) for l in range(L)]
    return leaf, levels


def _jax_bf(leaf, levels):
    return JaxButterfly(None if leaf is None else jnp.asarray(leaf),
                        [jnp.asarray(W) for W in levels], 2)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("NB,blk,with_leaf",
                         [(16, 8, True), (16, 8, False), (32, 4, True)])
def test_slot_form_matches_jax(NB, blk, with_leaf):
    leaf, levels = _weights(NB, blk, NB + blk, with_leaf)
    jsb = JaxSlot.from_butterfly(_jax_bf(leaf, levels))
    sb = SlotButterfly.from_butterfly(
        uniform_butterfly_from_numpy(leaf, levels, 2, device="cpu"))
    np.testing.assert_array_equal(sb.perms.numpy(), np.asarray(jsb.perms))
    assert _rel(sb.weights.numpy(), jsb.weights) < 1e-6
    rng = np.random.default_rng(3)
    for shape in [(NB * blk, 6), (NB * blk,)]:
        x = rng.standard_normal(shape).astype(np.float32)
        assert _rel(sb.apply(torch.as_tensor(x)).numpy(),
                    jsb.apply(jnp.asarray(x))) < 1e-5


@pytest.fixture(scope="module")
def pipelines():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    leaf, levels = _weights(256, 4, 5)  # 8 levels: 2, 4 or 8 stages
    xs = {c: np.random.default_rng(6).standard_normal(
        (256 * 4, c[1] * 3)).astype(np.float32) for c in CASES}
    res = run_ranks(run_programs, 8, device="cpu", backend="gloo", args=(
        [(pipeline_program, (leaf, levels, xs[c], *c)) for c in CASES],))
    return dict(leaf=leaf, levels=levels, xs=xs,
                ranks={c: [r[i] for r in res] for i, c in enumerate(CASES)})


@pytest.mark.parametrize("stages,micro", CASES)
def test_pipelined_apply_matches_jax(pipelines, stages, micro):
    bf = _jax_bf(pipelines["leaf"], pipelines["levels"])
    pipe = JaxPipelined(bf, jax_stage_mesh(stages), num_micro=micro)
    x = jnp.asarray(pipelines["xs"][stages, micro])
    want = np.asarray(pipe.apply(x))
    ranks = pipelines["ranks"][stages, micro]
    for r in ranks[:stages]:  # every stage rank returns the whole result
        assert _rel(r["y"], want) < 1e-5
    assert _rel(ranks[0]["y"], bf.apply(x)) < 1e-5
    assert all(r is None for r in ranks[stages:])


@pytest.mark.parametrize("stages,micro", CASES)
def test_stage_ranks_hold_their_own_levels(pipelines, stages, micro):
    g = 8 // stages
    for r in pipelines["ranks"][stages, micro][:stages]:
        assert r["weights"] == (1, g, 128, 2, 2, 4, 4)
        assert r["perms"] == (1, g, 256)


def test_three_stages_over_four_levels_raise():
    leaf, levels = _weights(16, 4, 8)
    x = np.zeros((64, 3), np.float32)
    with pytest.raises(InvalidArgumentsError, match="divide into 3 stages"):
        run_ranks(pipeline_program, 3, device="cpu", backend="gloo",
                  args=(leaf, levels, x, 3, 1))
