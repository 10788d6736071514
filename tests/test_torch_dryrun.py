"""The port's `dryrun_multichip` against a single-device JAX step.

`dryrun_multichip(n, device="cpu")` runs its two parts on n gloo ranks on
the CPU (one spawn each for n = 4 and 8) and returns part 1's loss and
the weights after its first step, gathered from the ranks. The JAX side
takes `jax.value_and_grad` of the JAX dryrun's `loss_fn` on the same numpy
parameters (`dryrun_params`) in this process and one SGD step at 1e-2:
loss and updated table and butterfly to 1e-5. Part 2's assertions (the
sharded apply of the real fac against the single-device apply and dense,
the step through the exchange lowering the loss) hold in the function and
are read back here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from butterfly_tpu.models.retrieval import CompressedTable as JaxTable
from butterfly_tpu.ops.butterfly import UniformButterfly as JaxButterfly
from butterfly_tpu_torch.entry import dryrun_multichip, dryrun_params


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module", params=[4, 8])
def run(request):
    n = request.param
    return n, dryrun_multichip(n, device="cpu")


def _jax_step(p):
    ct = JaxTable(jnp.asarray(p["Psi"]), jnp.asarray(p["V"]))
    bf = JaxButterfly(jnp.asarray(p["leaf"]),
                      [jnp.asarray(W) for W in p["levels"]], 2)

    def loss_fn(params, queries, target):
        ct, bf = params
        return jnp.mean((bf.apply(ct.score(queries)) - target) ** 2)

    loss, grads = jax.value_and_grad(loss_fn)(
        (ct, bf), jnp.asarray(p["queries"]), jnp.asarray(p["target"]))
    new = jax.tree_util.tree_map(lambda a, g: a - 1e-2 * g, (ct, bf), grads)
    return float(loss), new


def test_first_step_matches_single_device_jax(run):
    n, rec = run
    loss, (ct, bf) = _jax_step(dryrun_params(n))
    assert abs(rec["loss"] - loss) <= 1e-5 * loss
    assert _rel(rec["Psi"], ct.Psi) < 1e-5
    assert _rel(rec["V"], ct.V) < 1e-5
    assert _rel(rec["leaf"], bf.leaf) < 1e-5
    for got, want in zip(rec["levels"], bf.levels):
        assert _rel(got, want) < 1e-5


def test_second_step_loss_bounded(run):
    _, rec = run
    assert np.isfinite(rec["loss"]) and rec["loss2"] <= 1.5 * rec["loss"]


def test_real_fac_through_the_exchange(run):
    _, rec = run
    assert rec["rel"] < 2e-5
    assert rec["rel_dense"] < 1e-3
    assert rec["fac_loss2"] < rec["fac_loss"]
