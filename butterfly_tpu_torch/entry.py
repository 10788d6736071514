"""The flagship forward step: butterfly-compressed retrieval scoring + top-k.

Twin of `entry()` in the JAX package's `__graft_entry__.py` (:16-43), at the
same shapes: a CompressedTable of NB=32 blocks of s=128 rows at rank 32 over
d=64, scored against q=16 queries, the (n, q) scores run through a random
UniformButterfly tower (NB=32, block 128) and the top 100 rows taken per
query. The weights are normals from a `torch.Generator` seeded 0 (the
queries: seeded 7), in place of `jax.random.key(0)` and `key(7)`, so they
differ from the JAX package's; a test carries the JAX weights across to
compare the two. The JAX module's `dryrun_multichip` waits for the
multi-device slice.
"""

from __future__ import annotations

import numpy as np
import torch

from butterfly_tpu_torch.models.retrieval import CompressedTable
from butterfly_tpu_torch.ops.butterfly import (
    UniformButterfly,
    random_butterfly,
)
from butterfly_tpu_torch.utils.device import resolve_device

__all__ = ["entry", "forward"]

NB, S, RANK, D, Q = 32, 128, 32, 64, 16


def forward(ct: CompressedTable, bf: UniformButterfly,
            queries: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Score queries against the compressed table, refine the scores through
    the butterfly tower, return the top-100 (values, ids), (q, 100) each."""
    scores = ct.score(queries)  # (n, q)
    deep = bf.apply(scores)  # (n, q) butterfly tower
    return torch.topk(deep.T, 100)


def entry(device=None):
    """Return (forward, (ct, bf, queries)) on `device` (default: the card)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    ct = CompressedTable(
        (torch.randn((NB, S, RANK), generator=gen) / np.sqrt(RANK)).to(device),
        (torch.randn((NB, RANK, D), generator=gen) / np.sqrt(D)).to(device),
    )
    bf = random_butterfly(NB, S, generator=torch.Generator(
        device=device).manual_seed(0), device=device)
    queries = torch.randn((Q, D), generator=torch.Generator().manual_seed(7)
                          ).to(device)
    return forward, (ct, bf, queries)
