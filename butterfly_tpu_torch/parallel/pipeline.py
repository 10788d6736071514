"""Pipeline parallelism: butterfly level groups as pipeline stages.

Twin of `butterfly_tpu/parallel/pipeline.py`. A butterfly's levels have
different weight shapes (hi, R, R, lo, m, k); in **slot form** (a
Pease-style constant-geometry factorization) the activations live in a
per-level slot order where the R blocks a level mixes are adjacent, so
every level becomes

    weights  Wc_l : (NB/R, R, R, blk, blk)     (same shape for all l)
    perm_l   : (NB,) int64                      (slot reordering to the next
                                                 level's pair order)
    z <- einsum('pcdmk,pdkr->pcmr', Wc_l, z.reshape(NB/R, R, blk, r))[perm_l]

and the block-diagonal leaf folds into level 0 (slot (p, d) of level 0
reads natural block p*R+d, so Wc0'[p,c,d] = Wc0[p,c,d] @ leaf[p*R+d]).

`PipelinedButterfly` splits the L levels into S equal stage groups, one per
rank of a ("stage",) mesh, each rank holding only its own (1, g, ...)
weights and perms. The RHS columns split into M microbatches that run the
GPipe rotation of the JAX package's `_pipeline_apply` (:221-273): T = M + S
- 1 steps; stage 0 injects microbatch t; each rank applies its g levels to
the microbatch it holds (a rank holding none skips the work JAX's SPMD
program does on zeros); the state moves one stage a step; the last stage
banks finished microbatches; an all-reduce over the stage group stands in
for the closing `psum`. The rotation is an `all_to_all_single` in which
only the next stage gets rows (gloo's send/recv do not take CUDA tensors).
The bubble share is (S-1)/T.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from butterfly_tpu_torch.convert import uniform_butterfly_from_numpy
from butterfly_tpu_torch.ops.butterfly import UniformButterfly, _f32_precision
from butterfly_tpu_torch.parallel.launch import A2A
from butterfly_tpu_torch.parallel.sharding import mesh_axis
from butterfly_tpu_torch.utils.device import resolve_device
from butterfly_tpu_torch.utils.errors import InvalidArgumentsError, check

__all__ = ["PipelinedButterfly", "SlotButterfly", "make_stage_mesh",
           "pipeline_program"]


def _slot_order(NB: int, R: int, level: int) -> np.ndarray:
    """order[j] = natural block index held in slot j when entering `level`
    (digit `level` moved to the least-significant position, so the R blocks
    a level mixes sit in adjacent slots)."""
    j = np.arange(NB)
    d = j % R
    rest = j // R
    lo = R**level
    h, v = rest // lo, rest % lo
    return (h * R + d) * lo + v


def _slot_level(bf: UniformButterfly, l: int):
    """Level l of `bf` in slot form: (Wc (NB/R, R, R, blk, blk), perm (NB,)),
    the leaf folded into level 0."""
    R, NB, blk = bf.radix, bf.NB, bf.k_in
    W = bf.levels[l]
    # Wc[p, c, d] with p = h*lo + v  (natural input block of slot (p, d) at
    # level l is insert_digit(p, l, d))
    Wc = W.permute(0, 3, 1, 2, 4, 5).reshape(NB // R, R, R, blk, blk)
    if l == 0 and bf.leaf is not None:
        leaf = bf.leaf.reshape(NB // R, R, blk, blk)
        with _f32_precision("highest"):
            Wc = torch.einsum("pcdmn,pdnk->pcdmk", Wc, leaf)
    # after mixing, slot j holds natural block order_l[j]; reorder into the
    # next level's pair order (natural at the end)
    order_now = _slot_order(NB, R, l)
    order_next = (_slot_order(NB, R, l + 1) if l + 1 < bf.num_levels
                  else np.arange(NB))
    pos = np.empty(NB, dtype=np.int64)
    pos[order_now] = np.arange(NB)
    return Wc.contiguous(), torch.as_tensor(pos[order_next], device=W.device)


def _level_apply(R: int, Wc: torch.Tensor, perm: torch.Tensor,
                 z: torch.Tensor) -> torch.Tensor:
    """One slot-form level: z (NB, blk, r) -> (NB, blk, r)."""
    NB, blk, r = z.shape
    with _f32_precision("highest"):
        y = torch.einsum("pcdmk,pdkr->pcmr", Wc,
                         z.reshape(NB // R, R, blk, r).to(Wc.dtype))
    return y.reshape(NB, blk, r).to(z.dtype).index_select(0, perm)


class SlotButterfly(nn.Module):
    """Constant-geometry (slot-form) butterfly: stacked uniform levels.

    weights: (L, NB/R, R, R, blk, blk); perms: (L, NB) int64 slot
    reorderings applied AFTER each level's mixing.
    """

    def __init__(self, weights: torch.Tensor, perms: torch.Tensor,
                 radix: int):
        super().__init__()
        self.register_buffer("weights", weights)
        self.register_buffer("perms", perms)
        self.radix = radix

    @property
    def NB(self) -> int:
        return self.weights.shape[1] * self.radix

    @property
    def blk(self) -> int:
        return self.weights.shape[4]

    @classmethod
    def from_butterfly(cls, bf: UniformButterfly) -> "SlotButterfly":
        _check_uniform(bf)
        ws, perms = zip(*(_slot_level(bf, l) for l in range(bf.num_levels)))
        return cls(torch.stack(ws), torch.stack(perms), bf.radix)

    def level_apply(self, Wc, perm, z):
        """One slot-form level: z (NB, blk, r) -> (NB, blk, r)."""
        return _level_apply(self.radix, Wc, perm, z)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Sequential (single-device) slot-form apply; oracle for the
        pipelined schedule. x: (n,) or (n, r)."""
        was_vec = x.ndim == 1
        if was_vec:
            x = x[:, None]
        n, r = x.shape
        z = x.reshape(self.NB, self.blk, r)
        for Wc, perm in zip(self.weights, self.perms):
            z = self.level_apply(Wc, perm, z)
        out = z.reshape(n, r)
        return out[:, 0] if was_vec else out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(x)


def _check_uniform(bf: UniformButterfly) -> None:
    blk = bf.k_in
    check(bf.m_out == blk and all(
        W.shape[4] == blk and W.shape[5] == blk for W in bf.levels
    ), "slot form requires uniform ranks", InvalidArgumentsError)


def make_stage_mesh(num_stages: int, device=None) -> DeviceMesh:
    """A ("stage",) mesh over the first num_stages ranks; `device` names the
    device type (None: the card)."""
    check(num_stages <= dist.get_world_size(), "not enough ranks",
          InvalidArgumentsError)
    return init_device_mesh(resolve_device(device).type, (num_stages,),
                            mesh_dim_names=("stage",))


class PipelinedButterfly:
    """GPipe-style pipelined butterfly apply over a ("stage",) mesh.

    The levels split into S equal groups of g; this rank, stage s, holds
    group s's slot-form weights (1, g, NB/R, R, R, blk, blk) and perms
    (1, g, NB), so weight memory per rank drops by S. The RHS columns split
    into `num_micro` microbatches that rotate through the stages.
    """

    def __init__(self, bf: UniformButterfly, mesh: DeviceMesh,
                 num_micro: int = 4):
        check("stage" in mesh.mesh_dim_names, "mesh needs a 'stage' axis",
              InvalidArgumentsError)
        S = mesh.size()
        L = bf.num_levels
        check(L % S == 0, f"num levels {L} must divide into {S} stages",
              InvalidArgumentsError)
        _check_uniform(bf)
        self.S, s, self.group = mesh_axis(mesh, "stage")
        self.stage = s
        self.num_micro = num_micro
        self.g = g = L // S
        self.radix = bf.radix
        self.NB, self.blk = bf.NB, bf.k_in
        self.shape = bf.shape
        ws, perms = zip(*(_slot_level(bf, l)
                          for l in range(s * g, (s + 1) * g)))
        self.weights = torch.stack(ws)[None]
        self.perms = torch.stack(perms)[None]

    def _rotate(self, state: torch.Tensor) -> torch.Tensor:
        """Send the state to the next stage, take the previous stage's."""
        S, s = self.S, self.stage
        rows = state.shape[0]
        in_splits = [rows if u == (s + 1) % S else 0 for u in range(S)]
        out_splits = [rows if u == (s - 1) % S else 0 for u in range(S)]
        return A2A(state, self.group, out_splits, in_splits)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """x: (n, r) with num_micro dividing r, the same on every rank;
        every rank returns the whole (n, r) result."""
        M, S, s = self.num_micro, self.S, self.stage
        check(x.ndim == 2 and x.shape[1] % M == 0,
              "r must divide into microbatches", InvalidArgumentsError)
        n, r = x.shape
        rm = r // M
        micro = x.reshape(self.NB, self.blk, M, rm).permute(2, 0, 1, 3)
        state = torch.zeros_like(micro[0])
        outs = torch.zeros_like(micro)
        T = M + S - 1
        for t in range(T):
            if s == 0 and t < M:
                state = micro[t].contiguous()
            if s <= t < s + M:  # this stage holds microbatch t - s
                for i in range(self.g):
                    state = _level_apply(self.radix, self.weights[0, i],
                                         self.perms[0, i], state)
                if s == S - 1:
                    outs[t - s] = state
            if t < T - 1:
                state = self._rotate(state)
        # only the last stage holds the outputs: the all-reduce replicates
        dist.all_reduce(outs, group=self.group)
        return outs.permute(1, 2, 0, 3).reshape(n, r)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(x)


def pipeline_program(rank: int, world: int, device, leaf, levels, x,
                     num_stages: int, num_micro: int):
    """`launch.run_ranks` target: a PipelinedButterfly of numpy weights over
    the first `num_stages` ranks, applied to x; a rank outside the stage
    mesh returns None, a stage rank its result and the shapes of the
    weights and perms it holds."""
    mesh = make_stage_mesh(num_stages, device=device)
    if rank >= num_stages:
        return None
    bf = uniform_butterfly_from_numpy(leaf, levels, 2, device=device)
    pipe = PipelinedButterfly(bf, mesh, num_micro=num_micro)
    with torch.no_grad():
        y = pipe.apply(torch.as_tensor(x, device=device))
    return dict(y=y.cpu().numpy(), weights=tuple(pipe.weights.shape),
                perms=tuple(pipe.perms.shape))
