"""The fac -> device bridge: factorized operators onto the K1 kernel.

Port counterpart of `FusedFacPlan` and `uniformize_fused` in
`butterfly_tpu/fac/uniformize.py` (:187-277). A REAL factorized operator
(a `PartialFac` from the streaming factorizer, or any real LinOp) is
re-compressed to uniform FFT form on the host (fac/distill.py) and applied
through the fused pass kernel (ops/fused_butterfly.py): the fast path for
the reference's product apply (src/fac.c:133-146), which walks the factor
graph one small BLAS call per block. `materialize_on_device` (:52-79)
densifies a packed `StagePlan` on its device for the partition apply; the
ragged packed-plan path `uniformize` waits for a later slice.
"""

from __future__ import annotations

import numpy as np
import torch

from butterfly_tpu_torch.fac.distill import DistilledButterfly, distill_butterfly
from butterfly_tpu_torch.fac.streamer import PartialFac
from butterfly_tpu_torch.ops.fused_butterfly import FusedButterflyPlan
from butterfly_tpu_torch.ops.linop import LinOp
from butterfly_tpu_torch.ops.packed import StagePlan
from butterfly_tpu_torch.utils.device import resolve_device
from butterfly_tpu_torch.utils.errors import InvalidArgumentsError, check
from butterfly_tpu_torch.utils.logging import log_info

__all__ = ["FusedFacPlan", "materialize_on_device", "uniformize_fused"]


def materialize_on_device(plan: StagePlan, chunk: int = 256) -> torch.Tensor:
    """Dense materialization of a packed plan on its own device: apply it
    to identity column blocks built there and keep the result there. For a
    real-embedded complex plan the result is the (2n, 2m) STACKED [Re; Im]
    real matrix (StagePlan's convention)."""
    m = plan.shape[1] * (2 if plan.real_embed else 1)
    w = min(chunk, m)
    rows = torch.arange(m, device=plan.device)[:, None]
    cols = torch.arange(w, device=plan.device)[None, :]
    outs = []
    for j0 in range(0, m, w):
        E = (rows == j0 + cols).to(torch.float32)
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
