"""The general traffic generator: every input a run sends, made from the
traffic file's parameters and `--seed`.

A traffic file (`traffic/<name>.json`) names its driver and the
parameters below; a later mix is a new data file. Every seed draws the
same set of sizes: the pools are stratified, so that seeds change the
values and the order, not the amount of work.

Right-hand sides (`rhs.kind`), in the original point order, made from the
reference's own discretization of the configuration:

- `sprime_point_source`: the S' data of a point source, drawn uniformly
  in the ellipse scaled by `region_scale` about its centre (strata of equal
  area: `pool` = rings x sectors, one point in each, jittered by the seed);
  each has the exact exterior field of that source.

Blocks (`blocks`): `pool` blocks of `cols` float32 columns in the plan's
interleaved real layout, standard normal, made on the device by a
`torch.Generator` seeded from the run's seed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import bie, geometry

SEED_STREAMS = {"rhs": 1, "order": 2, "blocks": 3, "keep": 4}


def rng(seed: int, stream: str) -> np.random.Generator:
    """An independent NumPy stream of the run's seed (any whole number)."""
    return np.random.default_rng([abs(int(seed)), SEED_STREAMS[stream]])


def order(seed: int, pool: int) -> np.ndarray:
    """The seeded order in which a closed loop cycles through its pool."""
    return rng(seed, "order").permutation(pool)


def _strata(pool: int):
    rings = int(math.isqrt(pool))
    while pool % rings:
        rings -= 1
    return rings, pool // rings


def source_points(spec: dict, scale: float, pool: int, gen) -> np.ndarray:
    """`pool` points, one in each equal-area stratum (ring x sector) of the
    scaled ellipse."""
    rings, sectors = _strata(pool)
    i, j = np.divmod(np.arange(pool), sectors)
    u = (i + gen.random(pool)) / rings          # area fraction
    phi = 2 * math.pi * (j + gen.random(pool)) / sectors
    return geometry.inside(spec, scale, np.sqrt(u), phi)


def rhs_pool(config: dict, traffic: dict, seed: int) -> np.ndarray:
    """(pool, n) complex128 right-hand sides in the original point order."""
    spec = traffic["rhs"]
    pool = int(traffic["pool"])
    gen = rng(seed, "rhs")
    prob = bie.Problem(config, "cpu")
    kind = spec["kind"]
    if kind == "sprime_point_source":
        src = torch.as_tensor(source_points(config["ellipse"],
                                            float(spec["region_scale"]),
                                            pool, gen))
        K = bie.kernel({"pot": "sprime"}, prob.k, prob.x, src, prob.nrm)
        return K.T.contiguous().numpy()
    raise ValueError(f"unknown right-hand side kind {kind!r}")


def block_pool(rows: int, traffic: dict, seed: int, device) -> list:
    """`pool` (rows, cols) float32 blocks on `device`, from the seed."""
    seed = int(rng(seed, "blocks").integers(0, 2**62))
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn((rows, int(traffic["cols"])), generator=gen,
                        device=device, dtype=torch.float32)
            for _ in range(int(traffic["pool"]))]
