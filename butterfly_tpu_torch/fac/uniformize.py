"""The fac -> device bridge: factorized operators onto the K1 kernel.

Port counterpart of `butterfly_tpu/fac/uniformize.py`. Two paths take a
factorized operator (a `PartialFac` from the streaming factorizer, or any
LinOp) to the card:

- `uniformize` (:280-317) keeps the fac's ragged ranks and packs it into a
  `StagePlan` (ops/packed.py): one batched product per bucket of padded
  block shapes and stage. `choose_block_align` (:93-186, with
  `AlignEstimate`, `fac_block_stats` and `estimate_for_align`) picks the
  bucket tile from the unit shapes before any device memory is committed;
  the host NumPy code is the JAX package's, copied.
- `uniformize_fused` and `FusedFacPlan` (:187-277) re-compress a REAL
  operator to uniform FFT form on the host (fac/distill.py) and apply it
  through the fused pass kernel K1 (ops/fused_butterfly.py).

Both replace the reference's product apply (src/fac.c:133-146), which walks
the factor graph one small BLAS call per block. `materialize_on_device`
(:52-79) densifies a packed `StagePlan` on its device for the partition
apply.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from butterfly_tpu_torch.fac.distill import DistilledButterfly, distill_butterfly
from butterfly_tpu_torch.fac.streamer import PartialFac
from butterfly_tpu_torch.ops import packed as packed_mod
from butterfly_tpu_torch.ops.fused_butterfly import FusedButterflyPlan
from butterfly_tpu_torch.ops.linop import LinOp
from butterfly_tpu_torch.ops.packed import StagePlan, pack
from butterfly_tpu_torch.utils.device import resolve_device
from butterfly_tpu_torch.utils.errors import InvalidArgumentsError, check
from butterfly_tpu_torch.utils.logging import log_info

__all__ = [
    "AlignEstimate",
    "FusedFacPlan",
    "choose_block_align",
    "estimate_for_align",
    "fac_block_stats",
    "materialize_on_device",
    "uniformize",
    "uniformize_fused",
]


def materialize_on_device(plan: StagePlan, chunk: int = 256) -> torch.Tensor:
    """Dense materialization of a packed plan on its own device: apply it
    to identity column blocks built there, in the plan's own dtype (a
    float64 plan materializes in float64), and keep the result there. For a
    real-embedded complex plan the result is the (2n, 2m) STACKED [Re; Im]
    real matrix (StagePlan's convention)."""
    m = plan.shape[1] * (2 if plan.real_embed else 1)
    w = min(chunk, m)
    rows = torch.arange(m, device=plan.device)[:, None]
    cols = torch.arange(w, device=plan.device)[None, :]
    outs = []
    for j0 in range(0, m, w):
        E = (rows == j0 + cols).to(plan._meta.dtype)
        outs.append(plan._run(E))
    return torch.cat(outs, dim=1)[:, :m]


def _as_linop(obj) -> LinOp:
    if isinstance(obj, PartialFac):
        return obj.as_linop()
    if isinstance(obj, LinOp):
        return obj
    raise InvalidArgumentsError(
        f"expected a PartialFac or LinOp, got {type(obj).__name__}"
    )


@dataclasses.dataclass
class AlignEstimate:
    """Predicted pack statistics for one candidate block_align."""

    block_align: int
    num_gemm_units: int
    num_buckets: int
    useful_flops_per_col: int
    padded_flops_per_col: int
    padding_waste: float
    padded_weight_elems: int


def _unit_shapes(op: LinOp) -> list[tuple[int, int, int]]:
    """(stage, m, k) of every dense GEMM unit, via one flatten pass."""
    chains: list = []
    packed_mod._flatten(op, 0, 0, chains)
    shapes = []
    for c in chains:
        for t, f in enumerate(c.factors):
            for u in f.gemms:
                mm, kk = u.data.shape
                shapes.append((t, mm, kk))
    return shapes


def fac_block_stats(obj) -> dict:
    """Per-stage block-size histogram of a factorized operator — the raw
    rank-raggedness data behind the bucketing decision."""
    shapes = _unit_shapes(_as_linop(obj))
    stages: dict[int, list[tuple[int, int]]] = {}
    for t, m, k in shapes:
        stages.setdefault(t, []).append((m, k))
    out = {}
    for t, blks in sorted(stages.items()):
        ms = np.array([m for m, _ in blks])
        ks = np.array([k for _, k in blks])
        out[t] = {
            "num_blocks": len(blks),
            "m_min": int(ms.min()), "m_max": int(ms.max()),
            "k_min": int(ks.min()), "k_max": int(ks.max()),
            "m_mean": float(ms.mean()), "k_mean": float(ks.mean()),
        }
    return out


def estimate_for_align(shapes: Sequence[tuple[int, int, int]],
                       block_align: int) -> AlignEstimate:
    buckets: dict[tuple, int] = {}
    useful = 0
    padded = 0
    pelems = 0
    for t, m, k in shapes:
        mp = packed_mod._round_up(m, block_align)
        kp = packed_mod._round_up(k, block_align)
        buckets[(t, mp, kp)] = buckets.get((t, mp, kp), 0) + 1
        useful += 2 * m * k
        padded += 2 * mp * kp
        pelems += mp * kp
    return AlignEstimate(
        block_align=block_align,
        num_gemm_units=len(shapes),
        num_buckets=len(buckets),
        useful_flops_per_col=useful,
        padded_flops_per_col=padded,
        padding_waste=1.0 - useful / max(padded, 1),
        padded_weight_elems=pelems,
    )


def choose_block_align(
    obj,
    candidates: Sequence[int] = (16, 32, 64, 128),
    bucket_overhead_flops: int = 1 << 22,
) -> tuple[int, list[AlignEstimate]]:
    """Pick the bucket tile size minimizing estimated apply cost.

    Cost model (the JAX package's, kept so both packages pick the same
    tile): padded flops (work including the padding) plus a fixed cost per
    bucket, about 4 MFLOP of work, since each bucket is one take, one
    batched product and one take-sum. Small aligns waste little padding but
    multiply the buckets; 128 can pad ragged ranks more than 2x.
    """
    shapes = _unit_shapes(_as_linop(obj))
    check(shapes, "operator has no dense blocks to pack")
    ests = [estimate_for_align(shapes, a) for a in candidates]
    best = min(
        ests,
        key=lambda e: e.padded_flops_per_col
        + bucket_overhead_flops * e.num_buckets,
    )
    return best.block_align, ests


def uniformize(
    obj,
    dtype=None,
    block_align: int | None = None,
    real_embed: bool = False,
    device=None,
) -> StagePlan:
    """Compile a factorization-engine output into its packed device plan
    on `device` (default: the card).

    obj: a `PartialFac` (streamer output), a LinOp, or any expression over
    them. block_align: bucket tile size; None picks one via
    `choose_block_align`. The JAX function's `precision` and `tiling`
    arguments are gone: the port's `pack` always multiplies in IEEE float32
    (or the plan's float64) and pads every unit to its own tile.

    Returns a StagePlan; `plan.stats.padding_waste` records the
    uniformization cost.
    """
    op = _as_linop(obj)
    if block_align is None:
        block_align, ests = choose_block_align(op)
        est = next(e for e in ests if e.block_align == block_align)
        log_info("uniformize: chose block_align=%d (waste %.1f%%, %d "
                 "buckets)", block_align, 100 * est.padding_waste,
                 est.num_buckets)
    plan = pack(op, dtype=dtype, block_align=block_align,
                real_embed=real_embed, device=device)
    log_info(
        "uniformize: %d stages, %d gemm buckets, padding waste %.1f%%, "
        "%.1f MB weights",
        plan.stats.num_stages,
        plan.stats.num_gemm_buckets,
        100 * plan.stats.padding_waste,
        plan.stats.weight_bytes / 1e6,
    )
    return plan


class FusedFacPlan:
    """A REAL factorized operator re-compressed to FFT form and compiled
    through the fused butterfly kernel.

    Rows come out of the kernel in butterfly (bit-reversed-block) order;
    apply() restores canonical order with one gather,
    apply_butterfly_order() skips it (order-free consumers).
    """

    def __init__(self, dist: DistilledButterfly, fuse: int = 8,
                 act_dtype=None, device=None):
        device = resolve_device(device)
        self.dist = dist
        self.plan = FusedButterflyPlan(dist.bf, fuse=fuse,
                                       act_dtype=act_dtype, device=device)
        inv = np.empty_like(dist.row_perm)
        inv[dist.row_perm] = np.arange(dist.row_perm.size)
        self._inv_perm = torch.as_tensor(inv, device=device)
        self.shape = dist.bf.shape
        self.rank = dist.rank

    def apply_butterfly_order(self, x: torch.Tensor) -> torch.Tensor:
        return self.plan.apply(x)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return self.plan.apply(x)[self._inv_perm]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(x)

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        return self.apply(X)

    def flops_per_col(self) -> int:
        return self.dist.bf.flops_per_col()

    def nbytes(self) -> int:
        return self.plan.nbytes()


def uniformize_fused(
    obj,
    num_blocks: int | None = None,
    rank: int | None = None,
    tol: float = 1e-6,
    dtype=torch.float32,
    fuse: int = 8,
    act_dtype=None,
    device=None,
) -> FusedFacPlan:
    """Re-compress a real factorized operator into uniform FFT form
    (fac/distill.py, host f64) and compile the fused apply on `device`.

    num_blocks=None picks the largest power of two keeping >=32 columns
    per leaf block.
    """
    device = resolve_device(device)
    op = _as_linop(obj)
    n, m = op.shape
    check(not np.issubdtype(op.dtype, np.complexfloating),
          "uniformize_fused is real-only", InvalidArgumentsError)
    if num_blocks is None:
        nb = 1
        while (nb * 2 <= min(n, m) // 32
               and n % (nb * 2) == 0 and m % (nb * 2) == 0):
            nb *= 2
        num_blocks = nb
    check(num_blocks >= 2, "operator too small to butterfly",
          InvalidArgumentsError)
    dist = distill_butterfly(op, num_blocks, rank, dtype=dtype, tol=tol,
                             device=device)
    log_info(
        "uniformize_fused: NB=%d rank=%d dropped=%.2e nbytes=%.1f MB",
        num_blocks, dist.rank, dist.max_sv_discarded, dist.nbytes() / 1e6,
    )
    return FusedFacPlan(dist, fuse=fuse, act_dtype=act_dtype, device=device)
