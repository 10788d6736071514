"""The port's ShardedButterfly (one all-to-all) against the JAX package's.

Eight gloo ranks on the CPU run every case in one spawn
(`parallel.launch.run_ranks`); the JAX side runs in this process on the
conftest's eight virtual devices. Both get the same numpy weights, inputs
and targets (NB=64, blocks of 16, r=8, a ("model",) mesh of 8). The JAX
`use_pallas=True` path runs its kernel in interpret mode; the port's
`use_kernel=True` runs K1's plain pass, as a CPU tensor does.

The exchange count is read from the port's own collective call
(`launch.A2A`): one all-to-all an apply, with (NB/D)*blk*r elements in
each rank's send buffer — the counterpart of the JAX test's compiled-HLO
volume check. Tolerances: 2e-6 relative (the JAX test's), gradients 1e-5.
"""

import os
from multiprocessing import forkserver, resource_tracker

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from butterfly_tpu.ops.butterfly import UniformButterfly as JaxButterfly
from butterfly_tpu.parallel.shmap_butterfly import (
    ShardedButterfly as JaxSharded,
)
from butterfly_tpu_torch.parallel.launch import (
    run_programs,
    run_ranks,
    stop_rank_servers,
)
from butterfly_tpu_torch.parallel.shmap_butterfly import (
    sharded_program,
    unpermute_rows,
)

NB, BLK, R_COLS, D = 64, 16, 8, 8


def _weights(seed):
    rng = np.random.default_rng(seed)
    leaf = (rng.standard_normal((NB, BLK, BLK)) / np.sqrt(BLK)).astype(
        np.float32)
    levels = [(rng.standard_normal((NB // 2 ** (l + 1), 2, 2, 2 ** l, BLK,
                                    BLK)) / np.sqrt(2 * BLK)).astype(
        np.float32) for l in range(6)]
    return leaf, levels


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def case():
    if len(jax.devices()) < D:
        pytest.skip("needs 8 virtual devices")
    rng = np.random.default_rng(11)
    w = {"einsum": _weights(0), "kernel": _weights(2)}
    x = rng.standard_normal((NB * BLK, R_COLS)).astype(np.float32)
    target = rng.standard_normal((NB * BLK, R_COLS)).astype(np.float32)
    programs = [(sharded_program, (*w["einsum"], x, target, False)),
                (sharded_program, (*w["kernel"], x, None, True))]
    res = run_ranks(run_programs, D, device="cpu", backend="gloo",
                    args=(programs,))
    mesh = Mesh(np.array(jax.devices()[:D]), ("model",))
    return dict(w=w, x=x, target=target, mesh=mesh,
                einsum=[r[0] for r in res], kernel=[r[1] for r in res])


def _jax(case, kind, **kw):
    leaf, levels = case["w"][kind]
    bf = JaxButterfly(jnp.asarray(leaf), [jnp.asarray(W) for W in levels], 2)
    return bf, JaxSharded(bf, case["mesh"], axis="model", **kw)


def _gathered(ranks):
    return np.concatenate([r["y"] for r in ranks])


@pytest.mark.parametrize("kind", ["einsum", "kernel"])
def test_sharded_matches_jax_and_single_device(case, kind):
    bf, jsb = _jax(case, kind, use_pallas=kind == "kernel")
    x = jnp.asarray(case["x"])
    want_sh = np.asarray(jsb.apply(x))
    want_1d = np.asarray(bf.apply(x))
    got = _gathered(case[kind])
    assert _rel(got, want_sh) < 2e-6
    assert _rel(unpermute_rows(got, D, NB, BLK), want_1d) < 2e-6
    assert jsb.exchanged


@pytest.mark.parametrize("kind", ["einsum", "kernel"])
def test_one_all_to_all_of_one_local_pass(case, kind):
    for r in case[kind]:
        assert r["a2a_calls"] == 1
        assert r["a2a_elems"] == (NB // D) * BLK * R_COLS


def test_exchange_bookkeeping_matches_jax(case):
    _, jsb = _jax(case, "einsum")
    r0 = case["einsum"][0]
    assert r0["exchanged"] == jsb.exchanged
    assert r0["expected"] == jsb.expected_exchange_elems(R_COLS)
    # the send buffers less each rank's own chunk
    moved = sum(r["a2a_elems"] for r in case["einsum"]) * (D - 1) // D
    assert moved == r0["expected"]
    y = np.random.default_rng(5).standard_normal((NB * BLK, 3))
    np.testing.assert_array_equal(
        unpermute_rows(y, D, NB, BLK),
        np.asarray(jsb.unpermute_rows(jnp.asarray(y))))


def test_gradients_through_the_exchange_match_jax(case):
    _, jsb = _jax(case, "einsum")
    x, target = jnp.asarray(case["x"]), jnp.asarray(case["target"])

    def loss(leaf, w1, w2):
        return jnp.mean((jsb._apply(x, leaf, w1, w2) - target) ** 2)

    lv, (g_leaf, g_w1, g_w2) = jax.value_and_grad(loss, argnums=(0, 1, 2))(
        jsb.leaf, jsb.w1, jsb.w2)
    ranks = case["einsum"]
    assert abs(ranks[0]["loss"] - float(lv)) <= 1e-5 * abs(float(lv))
    n1 = len(g_w1)
    grads = [r["grads"] for r in ranks]
    got_leaf = np.concatenate([g[0] for g in grads])
    assert _rel(got_leaf, g_leaf) < 1e-5
    for i, want in enumerate(g_w1):
        assert _rel(np.concatenate([g[1 + i] for g in grads]), want) < 1e-5
    for i, want in enumerate(g_w2):
        got = np.concatenate([g[1 + n1 + i] for g in grads], axis=3)
        assert _rel(got, want) < 1e-5


def test_stop_rank_servers_leaves_no_process(case):
    # `case` has run ranks, so their forkserver is up; once stopped, it and
    # the resource tracker are gone, and the next ranks start them again
    pids = [forkserver._forkserver._forkserver_pid,
            resource_tracker._resource_tracker._pid]
    assert pids[0] is not None
    stop_rank_servers()
    for pid in filter(None, pids):
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
    assert run_ranks(run_programs, 2, device="cpu", backend="gloo",
                     args=([],)) == [[], []]
    assert forkserver._forkserver._forkserver_pid not in (None, pids[0])
    stop_rank_servers()
    assert forkserver._forkserver._forkserver_pid is None
