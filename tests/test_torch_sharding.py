"""The port's mesh, placements and sharded applies against the JAX package.

`make_mesh`'s factorization and the per-level placements are pure and run
here. The sharded scoring and the placed butterfly run on eight gloo ranks
on the CPU, both in one spawn (`parallel.launch.run_ranks`), on the default
mesh of 8 (data 4 x model 2); the JAX side runs in this process on the
conftest's eight virtual devices, on the same numpy inputs. Tolerance
1e-5, the JAX test's atol.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from butterfly_tpu.models.retrieval import compress_table
from butterfly_tpu.ops.butterfly import UniformButterfly as JaxButterfly
from butterfly_tpu.parallel import make_mesh as jax_make_mesh
from butterfly_tpu.parallel.sharding import _level_spec as jax_level_spec
from butterfly_tpu_torch.parallel.launch import run_programs, run_ranks
from butterfly_tpu_torch.parallel.sharding import (
    _level_spec,
    apply_program,
    mesh_shape,
    score_program,
)
from torch.distributed.tensor import Replicate, Shard

WORLD = 8


@pytest.mark.parametrize("n,data,model",
                         [(1, None, None), (2, None, None), (4, None, None),
                          (8, None, None), (8, 8, 1)])
def test_mesh_shape_matches_jax(n, data, model):
    want = jax_make_mesh(n, data=data, model=model).shape
    assert mesh_shape(n, data, model) == (want["data"], want["model"])


def _as_jax_spec(placement):
    if isinstance(placement, Replicate):
        return P()
    assert isinstance(placement, Shard)
    spec = [None] * 6
    spec[placement.dim] = "model"
    return P(*spec)


@pytest.mark.parametrize("n_model", [2, 4, 8])
def test_level_placements_match_jax(n_model):
    NB = 16
    for l in range(4):
        shape = (NB // 2 ** (l + 1), 2, 2, 2 ** l, 8, 8)
        assert _as_jax_spec(_level_spec(shape, n_model)) == jax_level_spec(
            shape, n_model)


def _butterfly(seed, NB=16, blk=8):
    rng = np.random.default_rng(seed)
    leaf = (rng.standard_normal((NB, blk, blk)) / np.sqrt(blk)).astype(
        np.float32)
    levels = [(rng.standard_normal((NB // 2 ** (l + 1), 2, 2, 2 ** l, blk,
                                    blk)) / np.sqrt(2 * blk)).astype(
        np.float32) for l in range(4)]
    return leaf, levels


@pytest.fixture(scope="module")
def ranks():
    if len(jax.devices()) < WORLD:
        pytest.skip("needs 8 virtual devices")
    rng = np.random.default_rng(42)
    table = rng.standard_normal((1024, 32)).astype(np.float32)
    ct = compress_table(table, rank=8, block_rows=64)
    queries = rng.standard_normal((8, 32)).astype(np.float32)
    leaf, levels = _butterfly(0)
    x = rng.standard_normal((16 * 8, 4)).astype(np.float32)
    Psi, V = np.asarray(ct.Psi), np.asarray(ct.V)
    res = run_ranks(run_programs, WORLD, device="cpu", backend="gloo",
                    args=([(score_program, (Psi, V, queries)),
                           (apply_program, (leaf, levels, x)),
                           (apply_program, (leaf, levels, x, 1, 8))],))
    return dict(ct=ct, queries=queries, leaf=leaf, levels=levels, x=x,
                score=[r[0] for r in res], apply=[r[1] for r in res],
                apply_1x8=[r[2] for r in res])


def _assemble(results, key, row_axis, col_axis):
    """The whole array from each rank's block at mesh coordinate (data,
    model): rows stacked by `row_axis`'s coordinate, columns by
    `col_axis`'s (None: the same on every rank of that axis)."""
    blocks = {r["coord"]: r[key] for r in results}
    n_data = 1 + max(c[0] for c in blocks)
    n_model = 1 + max(c[1] for c in blocks)

    def at(row, col):
        coord = [0, 0]
        coord[row_axis] = row
        if col_axis is not None:
            coord[col_axis] = col
        return blocks[tuple(coord)]

    n_rows = (n_data, n_model)[row_axis]
    n_cols = 1 if col_axis is None else (n_data, n_model)[col_axis]
    return np.concatenate([np.concatenate([at(i, j) for j in range(n_cols)],
                                          axis=1) for i in range(n_rows)])


def test_sharded_scoring_matches_jax(ranks):
    want = np.asarray(ranks["ct"].score(jnp.asarray(ranks["queries"])))
    got = _assemble(ranks["score"], "scores", row_axis=1, col_axis=0)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("mesh", ["apply", "apply_1x8"])
def test_placed_butterfly_apply_matches_jax(ranks, mesh):
    """Mesh 4 x 2 (every level on hi but the last, on lo) and 1 x 8 (the
    two middle levels replicated)."""
    bf = JaxButterfly(jnp.asarray(ranks["leaf"]),
                      [jnp.asarray(W) for W in ranks["levels"]], 2)
    want = np.asarray(bf.apply(jnp.asarray(ranks["x"])))
    got = _assemble(ranks[mesh], "y", row_axis=1, col_axis=None)
    np.testing.assert_allclose(got, want, atol=1e-5)
    # every data row of the mesh computes the same whole result
    rows = got.shape[0] // (1 + max(r["coord"][1] for r in ranks[mesh]))
    for r in ranks[mesh]:
        m = r["coord"][1]
        np.testing.assert_allclose(r["y"], want[m * rows:(m + 1) * rows],
                                   atol=1e-5)


@pytest.mark.parametrize("mesh", ["apply", "apply_1x8"])
def test_placed_butterfly_apply_issues_collectives(ranks, mesh):
    """The counterpart of `test_gspmd_butterfly_emits_collectives`: the
    re-blocking between placements is real exchange."""
    assert all(r["a2a_calls"] >= 1 for r in ranks[mesh])
