"""Opt-in deep-invariant checks (the reference's BF_DEBUG analogue).

The reference compiles per-block point sets and shape assertions into its
factorization engines under BF_DEBUG (src/fac_helm2.c:127-138,926-936) so
mis-assembled blocks fail loudly during construction instead of surfacing
as silent accuracy loss. The TPU build's equivalent is a runtime flag:

    BUTTERFLY_DEBUG=1 python ...

turns on `deep_check_fac` calls after every streamer leaf build and merge
(fac/streamer.py), validating block <-> tree-node consistency through the
whole merge cascade. Off by default — the checks walk every block of every
partial fac and are O(num blocks) per merge.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["debug_enabled", "deep_check_fac"]


def debug_enabled() -> bool:
    return os.environ.get("BUTTERFLY_DEBUG", "0").lower() not in (
        "", "0", "false", "off")


def deep_check_fac(fac, where: str = "") -> None:
    """Validate a PartialFac's block structure against its tree nodes.

    Invariants (reference: the BF_DEBUG assertions after block assembly,
    src/fac_helm2.c:926-936, and the BfFacAux per-block point sets):
      * the row cut's nodes are disjoint, ordered, and their point counts
        sum to Psi's row count;
      * Psi is block-diagonal with one block per row-cut node, each block's
        rows equal to its node's point count;
      * the factor chain composes: Psi cols == W0 rows, W[k] cols ==
        W[k+1] rows, and the last W's cols equal the column node's points.
    Raises AssertionError with a location tag on violation.
    """
    tag = f" [{where}]" if where else ""

    def fail(msg):
        raise AssertionError(f"fac invariant violated{tag}: {msg}")

    rn = fac.row_nodes
    counts = [n.num_points for n in rn]
    if sum(counts) != fac.Psi.shape[0]:
        fail(f"row cut covers {sum(counts)} points but Psi has "
             f"{fac.Psi.shape[0]} rows")
    # disjoint + ordered row coverage
    spans = [(n.i0, n.i1) for n in rn]
    for (a0, a1), (b0, b1) in zip(spans, spans[1:]):
        if a1 > b0:
            fail(f"row cut nodes overlap/are unordered: ({a0},{a1}) then "
                 f"({b0},{b1})")
    blocks = getattr(fac.Psi, "blocks", None)
    if blocks is not None:
        if len(blocks) != len(rn):
            fail(f"Psi has {len(blocks)} blocks for {len(rn)} row nodes")
        for b, n in zip(blocks, rn):
            if b.shape[0] != n.num_points:
                fail(f"Psi block rows {b.shape[0]} != node points "
                     f"{n.num_points} (node [{n.i0},{n.i1}))")
    # chain composition
    dims = [fac.Psi.shape] + [w.shape for w in fac.W]
    for (m0, k0), (m1, k1) in zip(dims, dims[1:]):
        if k0 != m1:
            fail(f"factor chain break: ({m0},{k0}) @ ({m1},{k1})")
    if dims[-1][1] != fac.col_node.num_points:
        fail(f"last W cols {dims[-1][1]} != col node points "
             f"{fac.col_node.num_points}")
    # finite data where cheaply reachable
    for w in [fac.Psi] + list(fac.W):
        data = getattr(w, "data", None)
        if data is not None and not np.all(np.isfinite(data)):
            fail("non-finite entries in factor data")
