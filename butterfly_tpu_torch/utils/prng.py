"""Random number helpers.

Port counterpart of `butterfly_tpu/utils/prng.py` (reference: the
xoshiro256+/splitmix64 RNG, src/rand.c:20-72): host-side randomness uses a
numpy Generator, device-side a `torch.Generator`. A single `seed()` seeds
both deterministically. A torch generator gives other numbers than a JAX key
of the same seed, so tests that compare the two packages make their inputs
with numpy.
"""

from __future__ import annotations

import numpy as np
import torch

_HOST_RNG = np.random.default_rng(0)
_TORCH_GEN = torch.Generator().manual_seed(0)


def seed(s: int) -> None:
    """Seed host and torch RNG (reference: bfSeed, src/rand.c:20-33)."""
    global _HOST_RNG, _TORCH_GEN
    _HOST_RNG = np.random.default_rng(s)
    _TORCH_GEN = torch.Generator().manual_seed(s)


def host_rng() -> np.random.Generator:
    return _HOST_RNG


def torch_generator() -> torch.Generator:
    """The seeded CPU `torch.Generator`."""
    return _TORCH_GEN


def randn(*shape: int, dtype=np.float64) -> np.ndarray:
    """Host-side standard normals (reference: bfRealRandn, src/rand.c:55-72)."""
    return _HOST_RNG.standard_normal(shape).astype(dtype)


def crandn(*shape: int, dtype=np.complex128) -> np.ndarray:
    """Host-side complex standard normals (reference: bfComplexRandn)."""
    z = _HOST_RNG.standard_normal(shape) + 1j * _HOST_RNG.standard_normal(shape)
    return (z / np.sqrt(2.0)).astype(dtype)
