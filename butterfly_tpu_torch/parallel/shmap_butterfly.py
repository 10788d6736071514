"""Explicit per-level butterfly exchange: local levels, ONE all-to-all.

Twin of `butterfly_tpu/parallel/shmap_butterfly.py`, with ranks in place of
`shard_map`: each rank runs `_body`'s schedule (:54-93) on its own rows.

  1. the NB leaf blocks are sharded contiguously over the model axis (the
     top digits of the block index name the rank); every level whose mixing
     stride stays inside a rank's blocks runs locally (einsum, or K1 through
     a `FusedButterflyPlan` of the rank's own leaf and levels);
  2. ONE `all_to_all_single` over the model group re-blocks the rows so each
     rank owns the blocks with fixed LOW digits (the block transpose);
  3. the remaining log_R(D) levels, whose partners differ in top digits, are
     then local too: their lo-axis slices are taken mod D at setup.

The exchange moves one pass of the activation tensor, NB*m*r*(D-1)/D
elements, the least any butterfly schedule can move. The output lands in
low-digit block order; `unpermute_rows` restores the canonical order on the
gathered output.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from butterfly_tpu_torch.convert import uniform_butterfly_from_numpy
from butterfly_tpu_torch.ops.butterfly import UniformButterfly, _f32_precision
from butterfly_tpu_torch.ops.fused_butterfly import FusedButterflyPlan
from butterfly_tpu_torch.parallel.launch import A2A
from butterfly_tpu_torch.parallel.sharding import _level, mesh_axis
from butterfly_tpu_torch.utils.errors import InvalidArgumentsError, check

__all__ = ["ShardedButterfly", "sharded_program", "unpermute_rows"]


class ShardedButterfly:
    """A UniformButterfly applied with the explicit exchange schedule.

    Each rank holds its leaf blocks, its hi chunk of the local levels and
    its mod-D lo slices of the top levels. `apply(x)` takes this rank's
    contiguous rows (NB/D * k_in, r); the result rows are in LOW-DIGIT block
    order when an exchange happened — gather the ranks' outputs in rank
    order and call `unpermute_rows` for canonical order.

    `use_kernel=True` (the JAX package's `use_pallas`) runs the local stage
    through a `FusedButterflyPlan` of this rank's leaf and local levels,
    itself a UniformButterfly of NB/D blocks: K1 on a CUDA tensor, its
    plain pass on a CPU tensor. Gradients flow through the einsum path
    (`use_kernel=False`) and the exchange (K1 has no backward, as the JAX
    kernel has none).
    """

    def __init__(self, bf: UniformButterfly, mesh: DeviceMesh,
                 axis: str = "model", use_kernel: bool = False,
                 fuse: int = 8):
        D, t, self.group = mesh_axis(mesh, axis)
        self.R = R = bf.radix
        self.NB = NB = bf.NB
        self.D, self.t = D, t
        check(D == 1 or R ** int(round(math.log(D, R))) == D,
              "model axis size must be a power of the radix",
              InvalidArgumentsError)
        check(NB % (D * D) == 0 or D == 1,
              "need NB >= D^2 blocks for the exchange reshape",
              InvalidArgumentsError)
        L = bf.num_levels
        # levels with mixing stride inside a rank: R^(l+1) <= NB/D
        n_local = min(L, max(0, int(round(math.log(max(NB // D, 1), R)))))
        self.n_local = n_local
        self.shape, self.k_in, self.m_out = bf.shape, bf.k_in, bf.m_out
        self.precision = bf.precision
        NBl = NB // D
        self.leaf = (None if bf.leaf is None
                     else bf.leaf[t * NBl:(t + 1) * NBl].clone())
        self.w1 = [W[t * (W.shape[0] // D):(t + 1) * (W.shape[0] // D)]
                   .clone() for W in bf.levels[:n_local]]
        # top levels: this rank's lo indices are those = t mod D, in
        # lo // D order (the JAX package's pre-permuted lo axis, sliced)
        self.w2 = []
        for W in bf.levels[n_local:]:
            check(W.shape[3] % D == 0, "top-level lo must divide the axis",
                  InvalidArgumentsError)
            self.w2.append(W[:, :, :, t::D].contiguous())
        self.plan = None
        if use_kernel and self.w1:
            self.plan = FusedButterflyPlan(
                UniformButterfly(self.leaf, self.w1, R), fuse=fuse,
                device=self.w1[0].device)

    def params(self) -> list[torch.Tensor]:
        """This rank's weights, leaf first, then the local and top levels."""
        return ([] if self.leaf is None else [self.leaf]) + self.w1 + self.w2

    # -- the schedule, stage by stage ---------------------------------------

    def local_stage(self, x: torch.Tensor) -> torch.Tensor:
        """Leaf and local levels on this rank's rows: -> (NB/D, m, r)."""
        NBl, r = self.NB // self.D, x.shape[1]
        if self.plan is not None:
            return self.plan.apply(x).reshape(NBl, -1, r)
        cur = x.reshape(NBl, self.k_in, r)
        with _f32_precision(self.precision):
            if self.leaf is not None:
                cur = torch.einsum("bmk,bkr->bmr", self.leaf,
                                   cur.to(self.leaf.dtype))
            for W in self.w1:
                cur = _level(W, cur, self.R)
        return cur

    def exchange(self, cur: torch.Tensor) -> torch.Tensor:
        """The block transpose and the one all-to-all (none when no level
        is left for the top stage)."""
        if not self.w2:
            return cur
        NBl, m, r = cur.shape
        D = self.D
        # local block q = u*D + t' -> chunk t' contiguous, sent to rank t';
        # received index u' = s*NBl/D + u == global_block // D
        cur = cur.reshape(NBl // D, D, m, r).swapaxes(0, 1).reshape(NBl, m, r)
        return A2A(cur, self.group)

    def top_stage(self, cur: torch.Tensor) -> torch.Tensor:
        with _f32_precision(self.precision):
            for W in self.w2:
                cur = _level(W, cur, self.R)
        return cur

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """x: (NB/D * k_in, r), this rank's contiguous rows."""
        check(x.ndim == 2 and x.shape[0] == self.NB // self.D * self.k_in,
              f"local operand of shape {tuple(x.shape)} does not match "
              f"{self.NB // self.D} blocks of {self.k_in} rows",
              InvalidArgumentsError)
        r = x.shape[1]
        return self.top_stage(self.exchange(self.local_stage(x))).reshape(
            -1, r)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(x)

    @property
    def exchanged(self) -> bool:
        return len(self.w2) > 0

    def expected_exchange_elems(self, r: int) -> int:
        """Elements moved by the single all-to-all (excluding the local
        chunk each rank keeps)."""
        if not self.exchanged:
            return 0
        m_mid = self.w2[0].shape[5]
        return self.NB * m_mid * r * (self.D - 1) // self.D

    def unpermute_rows(self, y):
        """Restore canonical block order after the exchange, on the global
        output (the ranks' outputs stacked in rank order; torch or numpy)."""
        if not self.exchanged:
            return y
        return unpermute_rows(y, self.D, self.NB, self.m_out)


def unpermute_rows(y, D: int, NB: int, m_out: int):
    """Canonical block order of the gathered output of an apply whose
    exchange ran over D ranks (NB blocks of m_out rows)."""
    r = y.shape[-1]
    yb = y.reshape(D, NB // D, m_out, r)
    return yb.swapaxes(0, 1).reshape(NB * m_out, r)


def sharded_program(rank: int, world: int, device, leaf, levels, x,
                    target=None, use_kernel: bool = False) -> dict:
    """`launch.run_ranks` target: a ShardedButterfly of numpy weights over a
    ("model",) mesh of all ranks, applied once to this rank's rows of x.

    Returns this rank's output rows, the all-to-alls of that apply (calls,
    send-buffer elements), `exchanged` and `expected_exchange_elems`; with
    a target (rows in the output's order), also the mean-square loss over
    all ranks and this rank's gradients of it, leaf first.
    """
    mesh = init_device_mesh(device.type, (world,), mesh_dim_names=("model",))
    bf = uniform_butterfly_from_numpy(leaf, levels, 2, device=device)
    sb = ShardedButterfly(bf, mesh, use_kernel=use_kernel)
    rows = x.shape[0] // world
    xl = torch.as_tensor(x[rank * rows:(rank + 1) * rows], device=device)
    A2A.reset()
    with torch.no_grad():
        y = sb.apply(xl)
    out = dict(y=y.cpu().numpy(), a2a_calls=A2A.calls, a2a_elems=A2A.elems,
               exchanged=sb.exchanged,
               expected=sb.expected_exchange_elems(x.shape[1]))
    if target is not None:
        params = [p.requires_grad_() for p in sb.params()]
        rows = target.shape[0] // world
        tl = torch.as_tensor(target[rank * rows:(rank + 1) * rows],
                             device=device)
        loss = ((sb.apply(xl) - tl) ** 2).sum() / target.size
        loss.backward()
        total = loss.detach().clone()
        torch.distributed.all_reduce(total)
        out.update(loss=float(total),
                   grads=[p.grad.cpu().numpy() for p in params])
    return out
