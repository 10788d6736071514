"""Multi-device sharding of butterfly factors and retrieval scoring.

Twin of `butterfly_tpu/parallel/sharding.py`. The mesh is a `DeviceMesh`
(`init_device_mesh` over the default group of `launch.run_ranks`) with
dimensions ("data", "model"):

- data (DP): the query/batch axis of scoring and training;
- model (TP/SP): the leaf-block axis of butterfly factors and the row axis
  of activations and scores.

Placements are DTensor placements, one per mesh dimension (`Shard(dim)`,
`Replicate()`). Every rank holds the same whole tensors (made from one
seed), and `local_shard` cuts its own piece from them without
communication.

Butterfly tensor parallelism. Level l of a UniformButterfly has weights
(hi, R, R, lo, m, k), hi = NB/R^(l+1), lo = R^l, placed as the JAX package
places them (`_level_spec`): on hi while hi is a multiple of the model
size D, else on lo, else replicated. For JAX, GSPMD re-blocks the
activations between levels; PyTorch has no GSPMD, so `PlacedButterfly`
writes that re-blocking out. Each level runs locally on a row layout in
which a rank owns the blocks whose index has fixed base-R digits, none of
them the level's own mixing digit: the top digits of the block index on a
hi-placed level (contiguous block ranges, the canonical layout), the digits
just below the mixing digit on a lo-placed one, some of each on a
replicated one. Where two consecutive layouts differ, one
`all_to_all_single` over the model group moves the rows; a last one returns
the canonical layout, as GSPMD's output is canonical. Gradients flow
through the exchanges (`launch.A2A`).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from butterfly_tpu_torch.convert import uniform_butterfly_from_numpy
from butterfly_tpu_torch.models.retrieval import CompressedTable
from butterfly_tpu_torch.ops.butterfly import UniformButterfly, _f32_precision
from butterfly_tpu_torch.parallel.launch import A2A
from butterfly_tpu_torch.utils.device import resolve_device
from butterfly_tpu_torch.utils.errors import InvalidArgumentsError, check

__all__ = [
    "PlacedButterfly",
    "data_sharding",
    "local_shard",
    "make_mesh",
    "mesh_axis",
    "mesh_shape",
    "apply_program",
    "replicated",
    "score_program",
    "shard_butterfly",
    "shard_table",
]


def mesh_shape(n_devices: int, data: int | None = None,
               model: int | None = None) -> tuple[int, int]:
    """(data, model) sizes of the mesh over n_devices ranks.

    Default factorization: model gets the largest power of two <= sqrt(n),
    data gets the rest — both axes >1 whenever n >= 4.
    """
    if data is None or model is None:
        model = 1
        while model * 2 * model * 2 <= n_devices:
            model *= 2
        while n_devices % model:
            model //= 2
        data = n_devices // model
    check(data * model == n_devices, "data*model must equal n_devices",
          InvalidArgumentsError)
    return data, model


def make_mesh(n_devices: int | None = None, data: int | None = None,
              model: int | None = None, device=None) -> DeviceMesh:
    """A ("data", "model") mesh over the first n_devices ranks (all ranks
    when None), row-major as the JAX package's. `device` names the device
    type (None: the card)."""
    world = torch.distributed.get_world_size()
    if n_devices is None:
        n_devices = world
    check(n_devices <= world, "not enough ranks", InvalidArgumentsError)
    shape = mesh_shape(n_devices, data, model)
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=("data", "model"))


def mesh_axis(mesh: DeviceMesh, name: str):
    """(size, this rank's coordinate, process group) of a mesh dimension."""
    check(name in mesh.mesh_dim_names, f"mesh has no {name!r} axis",
          InvalidArgumentsError)
    return (mesh.size(mesh.mesh_dim_names.index(name)),
            mesh.get_local_rank(name), mesh.get_group(name))


def _on_axis(mesh: DeviceMesh, name: str, placement) -> tuple:
    """`placement` on the mesh dimension `name`, Replicate on the others."""
    return tuple(placement if d == name else Replicate()
                 for d in mesh.mesh_dim_names)


def replicated(mesh: DeviceMesh) -> tuple:
    return (Replicate(),) * mesh.ndim


def data_sharding(mesh: DeviceMesh, axis: int = 0) -> tuple:
    """Shard a batch tensor's `axis` over the data axis."""
    return _on_axis(mesh, "data", Shard(axis))


def local_shard(t: torch.Tensor, mesh: DeviceMesh,
                placements) -> torch.Tensor:
    """This rank's piece of `t` under `placements` (one per mesh
    dimension): a view, cut without communication."""
    for dim, p in enumerate(placements):
        if isinstance(p, Shard):
            size = mesh.size(dim)
            check(t.shape[p.dim] % size == 0,
                  f"axis {p.dim} of {tuple(t.shape)} does not split over "
                  f"{size} ranks", InvalidArgumentsError)
            step = t.shape[p.dim] // size
            t = t.narrow(p.dim, mesh.get_local_rank(dim) * step, step)
    return t


def _level_spec(shape: tuple, n_model: int):
    """Placement on the model axis of one butterfly level (hi, R, R, lo,
    m, k)."""
    hi, lo = shape[0], shape[3]
    if hi % n_model == 0 and hi >= n_model:
        return Shard(0)
    if lo % n_model == 0 and lo >= n_model:
        return Shard(3)
    return Replicate()  # replicate tiny levels


def _digits_of(R: int, n: int, D: int, level: int | None, spec):
    """Rank digits (most significant first) of the row layout on which a
    level runs locally; `level=None` (the leaf) and hi-placed levels use
    the canonical layout, the top log_R(D) digits."""
    k = round(math.log(D, R))
    if level is None or isinstance(spec, Shard) and spec.dim == 0:
        a = k
    elif isinstance(spec, Shard):
        a = 0
    else:  # replicated: top digits above the mixing digit, then below it
        a = min(k, n - 1 - level)
    top = tuple(range(n - 1, n - 1 - a, -1))
    below = () if level is None else tuple(range(level - 1,
                                                 level - 1 - (k - a), -1))
    return top + below


def _layout_maps(NB: int, R: int, digits: tuple):
    """owner[g], local[g] of every block g under a layout: the owner is the
    rank digits read as a number, the local index the other digits."""
    n = round(math.log(NB, R))
    g = np.arange(NB)
    dig = [(g // R**p) % R for p in range(n)]
    owner = np.zeros(NB, np.int64)
    for p in digits:
        owner = owner * R + dig[p]
    local = np.zeros(NB, np.int64)
    for p in range(n - 1, -1, -1):
        if p not in digits:
            local = local * R + dig[p]
    return owner, local


class _Reblock:
    """One rank's part of moving block rows from layout A to layout B: the
    local rows to send (grouped by destination), the split sizes, and the
    order of the rows received."""

    def __init__(self, NB: int, R: int, D: int, t: int, A: tuple,
                 B: tuple, device):
        oA, lA = _layout_maps(NB, R, A)
        oB, lB = _layout_maps(NB, R, B)
        mine = np.flatnonzero(oA == t)
        mine = mine[np.argsort(lA[mine])]   # global block of local row i
        self.send = torch.as_tensor(np.lexsort((lB[mine], oB[mine])),
                                    device=device)
        self.in_blocks = np.bincount(oB[mine], minlength=D).tolist()
        inc = np.flatnonzero(oB == t)
        inc = inc[np.lexsort((lB[inc], oA[inc]))]  # as the senders order
        self.out_blocks = np.bincount(oA[inc], minlength=D).tolist()
        self.gather = torch.as_tensor(np.argsort(lB[inc]), device=device)

    def __call__(self, cur: torch.Tensor, group) -> torch.Tensor:
        y = A2A(cur.index_select(0, self.send), group, self.out_blocks,
                self.in_blocks)
        return y.index_select(0, self.gather)


def _level(W: torch.Tensor, cur: torch.Tensor, R: int) -> torch.Tensor:
    """One FFT-form level on local rows: cur (B, k, r) -> (B, m, r), where
    W (hi, R, R, lo, m, k) covers those B = hi*R*lo blocks."""
    hi, _, _, lo, m, k = W.shape
    r = cur.shape[-1]
    y = torch.einsum("hcdlmk,hdlkr->hclmr", W,
                     cur.reshape(hi, R, lo, k, r).to(W.dtype))
    return y.reshape(hi * R * lo, m, r)


class PlacedButterfly(nn.Module):
    """A UniformButterfly placed over a mesh's model axis as the JAX
    package's `shard_butterfly` places it, applied with the re-blocking
    written out.

    Buffers hold this rank's stored pieces: the leaf's block range, each
    level's hi or lo chunk (`placements[l]`), or the whole of a replicated
    level. `apply` takes and returns canonical row blocks: rank t's
    NB/D blocks [t NB/D, (t+1) NB/D).
    """

    def __init__(self, bf: UniformButterfly, mesh: DeviceMesh,
                 axis: str = "model"):
        super().__init__()
        D, t, self.group = mesh_axis(mesh, axis)
        R, NB = bf.radix, bf.NB
        n = round(math.log(NB, R))
        check(R ** round(math.log(D, R)) == D and R * D <= NB,
              f"the {axis} axis size {D} must be a power of the radix {R} "
              f"and at most NB/R = {NB // R}", InvalidArgumentsError)
        self.R, self.NB, self.D, self.t = R, NB, D, t
        self.shape, self.k_in, self.m_out = bf.shape, bf.k_in, bf.m_out
        self.precision = bf.precision
        self.placements = [_level_spec(tuple(W.shape), D)
                           for W in bf.levels]
        NBl = NB // D
        self.register_buffer(
            "leaf", None if bf.leaf is None
            else bf.leaf[t * NBl:(t + 1) * NBl].clone())
        for l, (W, p) in enumerate(zip(bf.levels, self.placements)):
            if isinstance(p, Shard):
                step = W.shape[p.dim] // D
                W = W.narrow(p.dim, t * step, step)
            self.register_buffer(f"level{l}", W.clone())
        self._canonical = canonical = _digits_of(R, n, D, None, None)
        self._layouts = [_digits_of(R, n, D, l, p)
                         for l, p in enumerate(self.placements)]
        self._reblocks: dict = {}
        device = (bf.levels or [bf.leaf])[0].device
        for A, B in zip([canonical] + self._layouts,
                        self._layouts + [canonical]):
            if A != B and (A, B) not in self._reblocks:
                self._reblocks[A, B] = _Reblock(NB, R, D, t, A, B, device)

    @property
    def levels(self) -> list[torch.Tensor]:
        return [getattr(self, f"level{l}")
                for l in range(len(self.placements))]

    def params(self) -> list[torch.Tensor]:
        """The stored pieces, leaf first."""
        return ([] if self.leaf is None else [self.leaf]) + self.levels

    def replicated_params(self) -> list[torch.Tensor]:
        """Stored pieces every model rank holds whole: a rank's gradient
        covers only the part its rows use, so these sum over the axis."""
        return [W for W, p in zip(self.levels, self.placements)
                if isinstance(p, Replicate)]

    def _local_weights(self, l: int, W: torch.Tensor) -> torch.Tensor:
        """The part of level l this rank's rows use, on its layout."""
        if not isinstance(self.placements[l], Replicate):
            return W
        digits, R = self._layouts[l], self.R
        a = sum(1 for p in digits if p > l)
        b = len(digits) - a
        t_hi, t_lo = divmod(self.t, R**b)
        hi, lo = W.shape[0] // R**a, W.shape[3] // R**b
        return W[t_hi * hi:(t_hi + 1) * hi, :, :, t_lo * lo:(t_lo + 1) * lo]

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """x: (NB/D * k_in, r), this rank's canonical row blocks."""
        check(x.ndim == 2 and x.shape[0] == self.NB // self.D * self.k_in,
              f"local operand of shape {tuple(x.shape)} does not match "
              f"{self.NB // self.D} blocks of {self.k_in} rows",
              InvalidArgumentsError)
        r = x.shape[1]
        cur = x.reshape(-1, self.k_in, r)
        here = self._canonical
        with _f32_precision(self.precision):
            if self.leaf is not None:
                cur = torch.einsum("bmk,bkr->bmr", self.leaf,
                                   cur.to(self.leaf.dtype))
            for l, W in enumerate(self.levels):
                to = self._layouts[l]
                if to != here:
                    cur = self._reblocks[here, to](cur, self.group)
                    here = to
                cur = _level(self._local_weights(l, W), cur, self.R)
            if here != self._canonical:
                cur = self._reblocks[here, self._canonical](cur, self.group)
        return cur.reshape(-1, r)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(x)


def shard_butterfly(bf: UniformButterfly, mesh: DeviceMesh) -> PlacedButterfly:
    """Place butterfly factors with per-level tensor-parallel placements."""
    return PlacedButterfly(bf, mesh)


def shard_table(ct: CompressedTable, mesh: DeviceMesh) -> CompressedTable:
    """This rank's piece of the table: the block axis over the model axis
    (the whole table where the blocks do not divide)."""
    n_model = mesh_axis(mesh, "model")[0]
    spec = Shard(0) if ct.Psi.shape[0] % n_model == 0 else Replicate()
    place = _on_axis(mesh, "model", spec)
    return CompressedTable(
        local_shard(ct.Psi.detach(), mesh, place).clone(),
        local_shard(ct.V.detach(), mesh, place).clone())


# -- rank programs (`launch.run_ranks` targets), numpy in and out ----------


def score_program(rank: int, world: int, device, Psi, V, queries) -> dict:
    """Sharded scoring on `make_mesh(world)`: the table's blocks over
    "model", the queries over "data"; returns this rank's mesh coordinate
    and its (rows, queries) block of the (n, q) scores."""
    mesh = make_mesh(world, device=device)
    ct = shard_table(CompressedTable(torch.as_tensor(Psi, device=device),
                                     torch.as_tensor(V, device=device)),
                     mesh)
    q = local_shard(torch.as_tensor(queries, device=device), mesh,
                    data_sharding(mesh))
    with torch.no_grad():
        scores = ct.score(q)
    return dict(coord=tuple(mesh.get_coordinate()),
                scores=scores.cpu().numpy())


def apply_program(rank: int, world: int, device, leaf, levels, x,
                  data: int | None = None, model: int | None = None) -> dict:
    """`shard_butterfly` on `make_mesh(world, data, model)` applied to x
    (rows over "model", whole on each data rank); returns this rank's
    coordinate, its canonical output rows and the all-to-alls of the
    apply."""
    mesh = make_mesh(world, data, model, device=device)
    bf = uniform_butterfly_from_numpy(leaf, levels, 2, device=device)
    pb = shard_butterfly(bf, mesh)
    xl = local_shard(torch.as_tensor(x, device=device), mesh,
                     _on_axis(mesh, "model", Shard(0)))
    A2A.reset()
    with torch.no_grad():
        y = pb.apply(xl)
    return dict(coord=tuple(mesh.get_coordinate()), y=y.cpu().numpy(),
                a2a_calls=A2A.calls)
