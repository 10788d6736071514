"""Block-sparse cell matmul on the K2 CUDA kernel: the partition apply's
assembly kernel.

Port counterpart of `butterfly_tpu/ops/cellsp.py` (`CellPlan`; the Pallas
kernel `_cell_kernel`, :95-130).

A *cell* is one contribution  y[dst : dst+GM] += W @ src[blk*GK : +GK]
(kind 0, a 128x128 matrix product) or  y[dst : dst+GM] += src[...]
(kind 1, a plain add that assembles another buffer's rows). `dst` is an
8-aligned row offset: callers place true (un-padded) block rows by
embedding the residual shift into the weight tile. Several input buffers
are allowed; `src_buf` picks one.

What `CellPlan` keeps of the TPU plan: the cells, the merge of matmul
cells that land on the same (dst, src_buf, src_blk), and one weight stack
holding the host tiles followed by the device-made tiles (`dev_tiles`).
What it re-derives for the card: in place of Hb-row output bands with a
128-row overlap fold, empty-band fillers, SMEM segments, VMEM and output
budgets, `dst // 8` storage and carry-last tile indices (:52-60,
:199-205, :259-411), it builds per 128-row output tile a CSR list of
*entries* (`_cell_tables`). A cell whose `dst` is not a multiple of 128
straddles two tiles and enters both lists, each time with the row
sub-range of its weight tile and its row offset inside the output tile.
A matmul entry is trimmed to the nonzero extent of its weight tile (rows
in groups of 8, depth in K2's K-chunks of 16; exact, since only zero
products are left out) and dropped if it holds none. The entries of a
tile that read one source block with disjoint rows are merged into
*groups*, which K2 stages as one chunk, and the tiles are launched in
order of decreasing work. K2 (`csrc/k2_cell.cu`) has two engines over
those tables, both summing in IEEE float32 and storing each tile once.
The tile engine runs one CTA per (output tile, 128-column tile) over its
tile's groups. The matrix-vector engine, for narrow operands (`k2_engine`:
r <= _MV_MAX_R), cuts each tile's chunks into *slices* of at most
_SLICE_CHUNKS (`_slice_tables`), runs one CTA per slice that streams its
weights once, and lets the last CTA of a tile add the slices' partials in
slice order. Source rows past the end of a buffer read as zero and ragged
columns are masked, so `apply` pads nothing (the TPU's `round_r` is gone)
and gives the same result at any r.

`CellPlan.apply` launches K2 for CUDA tensors and runs `cells_plain`
(gathered tiles, `torch.bmm` in IEEE float32, `index_add_`) for CPU
tensors. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from butterfly_tpu_torch.ops.butterfly import _f32_precision
from butterfly_tpu_torch.utils import profiling
from butterfly_tpu_torch.utils.device import resolve_device
from butterfly_tpu_torch.utils.errors import (
    InvalidArgumentsError,
    RuntimeButterflyError,
    check,
)
from butterfly_tpu_torch.utils.nvcc import load_kernel

__all__ = ["Cell", "CellPlan", "GM", "GK", "K2", "cells_from_dense_block",
           "cells_plain", "k2_engine"]

GM = 128  # output rows per cell
GK = 128  # input rows per cell (= source block granularity)

_MAX_BUFS = 4  # kMaxBufs of the kernel
_KC = 16          # K2's K-chunk: the depth step of an entry
_RG = 8           # K2's row step: entries start and end on 8-row groups
_NRG = GM // _RG  # row groups of an output tile
_GROUP_INTS = 4 + _NRG  # int32 of a group record (kGroupInts of the kernel)
# what a staged K-chunk costs beyond its products (its copies and
# barrier), in row groups of products: the rule that merges entries into
# groups
_CHUNK_COST_RG = 4
# bytes of gathered tiles per `cells_plain` chunk
_PLAIN_CHUNK_BYTES = 1 << 28
# K2's matrix-vector engine: the most K-chunks a slice (one CTA) walks
_SLICE_CHUNKS = 16
# the widest r that K2 runs on its matrix-vector engine; wider r takes the
# tile engine. The engines cross at r ~ 50 on the n=16384 BIE plan and
# above r = 128 on the n=2048 S' plan (csrc/k2_cell.cu's note): 32 is the
# widest power of two below both.
_MV_MAX_R = 32


@dataclasses.dataclass
class Cell:
    """One contribution to the output.

    dst: output row offset (must be 0 mod 8).
    src_buf: input buffer index.
    src_blk: GK-row block index into that buffer.
    w: (GM, GK) float32 weight tile; None for a plain add (GM == GK); or
       ("dev", stack_id, tile_idx) referencing a tile of one of the
       device-resident stacks passed to CellPlan(dev_tiles=...) — used when
       weights are produced on the device.
    """

    dst: int
    src_buf: int
    src_blk: int
    w: "np.ndarray | tuple | None"


def k2_engine(r: int) -> str:
    """The K2 engine that an operand of r columns takes: the matrix-vector
    engine ("mv") for 1 <= r <= _MV_MAX_R, the tile engine ("tile")
    above."""
    return "mv" if 1 <= r <= _MV_MAX_R else "tile"


class _K2Kernel:
    """ctypes binding of `csrc/k2_cell.cu`. `launches` counts the kernel
    launches made through this wrapper, `launches_mv` and `launches_tile`
    those of each engine; nothing else changes them."""

    engine = "FFMA"  # the arithmetic of both engines (IEEE float32)

    def __init__(self):
        self.launches = 0
        self.launches_mv = 0
        self.launches_tile = 0
        self._lib = None

    def load(self) -> ctypes.CDLL:
        """Build (at first use) and load the kernel library."""
        if self._lib is None:
            lib = load_kernel("k2_cell.cu")
            P, I = ctypes.c_void_p, ctypes.c_int
            lib.k2_cells.argtypes = [P, P, P, I, P, P, P, P, P, P, I, I, P]
            lib.k2_cells.restype = I
            lib.k2_cells_mv.argtypes = [P, P, P, I] + [P] * 10 + [I, I, I, P]
            lib.k2_cells_mv.restype = I
            lib.k2_mv_tile_cols.argtypes = [I]
            lib.k2_mv_tile_cols.restype = I
            lib.k2_error_string.argtypes = [I]
            lib.k2_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def __call__(self, plan: "CellPlan", bufs) -> torch.Tensor:
        """The plan's cell program on CUDA tensors: bufs[i] (rows_i, r)
        float32 with rows_i <= plan.buf_rows[i] -> (n_out, r), on the
        engine that `k2_engine(r)` names."""
        return self.launch(plan, bufs, None)

    def launch(self, plan: "CellPlan", bufs, engine) -> torch.Tensor:
        """As a call, on `engine` ("mv" or "tile"; None: `k2_engine(r)`).
        Naming the engine is for measurement: both compute the same
        program."""
        r = _check_bufs(plan, bufs)
        for b in bufs:
            check(b.is_cuda, "K2 takes CUDA tensors", InvalidArgumentsError)
        engine = engine or k2_engine(r)
        lib = self.load()
        n = len(bufs)
        y = torch.empty((plan.n_out, r), dtype=torch.float32,
                        device=bufs[0].device)
        ptrs = (ctypes.c_void_p * n)(*[b.data_ptr() for b in bufs])
        rows = (ctypes.c_int64 * n)(*[b.shape[0] for b in bufs])
        t = plan._tables
        stream = torch.cuda.current_stream(y.device).cuda_stream
        with torch.cuda.device(y.device):
            if engine == "mv":
                ws, arrivals = plan._mv_workspace.get(r) or \
                    plan._new_mv_workspace(r, lib.k2_mv_tile_cols(r))
                err = lib.k2_cells_mv(
                    plan._Wt.data_ptr(), ptrs, rows, n,
                    t["sorder"].data_ptr(), t["slices"].data_ptr(),
                    t["sptr"].data_ptr(), t["chunks"].data_ptr(),
                    t["grp"].data_ptr(), t["ptr1"].data_ptr(),
                    t["ent1"].data_ptr(), ws.data_ptr(), arrivals.data_ptr(),
                    y.data_ptr(), plan.n_out, r, plan.num_slices, stream)
            else:
                check(engine == "tile", f"K2 has no engine {engine!r}",
                      InvalidArgumentsError)
                err = lib.k2_cells(
                    plan._Wt.data_ptr(), ptrs, rows, n,
                    t["order"].data_ptr(), t["gptr"].data_ptr(),
                    t["grp"].data_ptr(), t["ptr1"].data_ptr(),
                    t["ent1"].data_ptr(), y.data_ptr(), plan.n_out, r,
                    stream)
        if err != 0:
            raise RuntimeButterflyError(
                f"K2 launch failed: {lib.k2_error_string(err).decode()}")
        self.launches += 1
        if engine == "mv":
            self.launches_mv += 1
            profiling.count("k2.mv")
        else:
            self.launches_tile += 1
        return y


K2 = _K2Kernel()


def _check_bufs(plan: "CellPlan", bufs) -> int:
    check(len(bufs) == len(plan.buf_rows),
          f"the plan reads {len(plan.buf_rows)} buffers, got {len(bufs)}",
          InvalidArgumentsError)
    r = bufs[0].shape[1] if bufs[0].ndim == 2 else -1
    for i, b in enumerate(bufs):
        check(b.ndim == 2 and b.shape[1] == r and r >= 1,
              "buffers must be 2-D with one common column count",
              InvalidArgumentsError)
        check(b.dtype == torch.float32 and b.is_contiguous(),
              "buffers must be contiguous float32", InvalidArgumentsError)
        check(b.device == plan.device,
              f"buffer on {b.device}, plan on {plan.device}",
              InvalidArgumentsError)
        check(b.shape[0] <= plan.buf_rows[i],
              f"buffer {i} has {b.shape[0]} rows, the plan allows "
              f"{plan.buf_rows[i]}", InvalidArgumentsError)
    return r


def cells_plain(plan: "CellPlan", bufs) -> torch.Tensor:
    """Plain PyTorch version of the cell program: the kind-0 cells' weight
    and source tiles gathered in chunks, one `torch.bmm` per chunk (IEEE
    float32) and `index_add_` into y; kind-1 source tiles added directly.
    Buffers are zero-padded to whole blocks, as the kernel reads them."""
    r = _check_bufs(plan, bufs)
    dev = bufs[0].device
    pad = [torch.zeros((p - b.shape[0], r), dtype=torch.float32, device=dev)
           for p, b in zip(plan.buf_rows_pad, bufs)]
    tiles = torch.cat([t for b, z in zip(bufs, pad) for t in (b, z)]
                      ).reshape(-1, GK, r)
    y = torch.zeros((plan.n_out_pad, r), dtype=torch.float32, device=dev)
    arange = torch.arange(GM, device=dev)
    c = plan._plain
    step = max(1, _PLAIN_CHUNK_BYTES // (4 * GK * r))
    with _f32_precision("highest"):
        for i in range(0, c["src0"].numel(), step):
            Y = torch.bmm(plan.W.index_select(0, c["widx0"][i:i + step]),
                          tiles.index_select(0, c["src0"][i:i + step]))
            rows = (c["dst0"][i:i + step, None] + arange).reshape(-1)
            y.index_add_(0, rows, Y.reshape(-1, r))
        for i in range(0, c["src1"].numel(), step):
            rows = (c["dst1"][i:i + step, None] + arange).reshape(-1)
            y.index_add_(0, rows, tiles.index_select(
                0, c["src1"][i:i + step]).reshape(-1, r))
    return y[:plan.n_out]


class CellPlan:
    """Executable block-sparse cell program.

    buf_rows[i] is the row extent of input buffer i that cells may address
    (cells read whole GK-row blocks of it); a buffer passed to `apply` may
    hold fewer rows, and the missing rows read as zero. The output has
    `n_out` rows; cell rows past it are dropped.
    """

    def __init__(self, n_out: int, buf_rows, cells, dev_tiles=None,
                 device=None):
        device = resolve_device(device)
        check(len(cells) > 0, "CellPlan needs at least one cell",
              InvalidArgumentsError)
        check(n_out >= 1, "CellPlan needs at least one output row",
              InvalidArgumentsError)
        nb = len(buf_rows)
        check(1 <= nb <= _MAX_BUFS,
              f"CellPlan takes 1 to {_MAX_BUFS} input buffers",
              InvalidArgumentsError)
        dev_tiles = list(dev_tiles or [])

        self.device = device
        self.n_out = int(n_out)
        self.buf_rows = [int(b) for b in buf_rows]
        self.buf_rows_pad = [-(-b // GK) * GK for b in self.buf_rows]
        self.n_out_pad = -(-(max([n_out] + [c.dst for c in cells]) + GM)
                           // GM) * GM

        # merge matmul cells landing on the same (dst, src) position —
        # adjacent blocks sharing a 128-boundary region produce them
        merged: dict = {}
        out: list = []
        for c in cells:
            if c.w is None or isinstance(c.w, tuple):
                out.append(c)
                continue
            key = (c.dst, c.src_buf, c.src_blk)
            if key in merged and not isinstance(out[merged[key]].w, tuple):
                prev = out[merged[key]]
                out[merged[key]] = Cell(c.dst, c.src_buf, c.src_blk,
                                        prev.w + c.w)
            else:
                merged[key] = len(out)
                out.append(c)
        cells = out

        # the weight stack is [host tiles | dev stack 0 | dev stack 1 | ...]
        stack_base = [sum(1 for c in cells if isinstance(c.w, np.ndarray))]
        for sdev in dev_tiles:
            check(sdev.ndim == 3 and tuple(sdev.shape[1:]) == (GM, GK),
                  "dev_tiles stacks must be (n, GM, GK)",
                  InvalidArgumentsError)
            stack_base.append(stack_base[-1] + sdev.shape[0])
        T = len(cells)
        dst = np.empty(T, np.int64)
        src_buf = np.empty(T, np.int64)
        src_blk = np.empty(T, np.int64)
        kind = np.empty(T, np.int64)
        widx = np.zeros(T, np.int64)
        wlist = []
        for t, c in enumerate(cells):
            check(c.dst % 8 == 0 and c.dst >= 0,
                  "cell dst must be 8-aligned and >= 0",
                  InvalidArgumentsError)
            check(0 <= c.src_buf < nb, "cell src_buf out of range",
                  InvalidArgumentsError)
            check(0 <= c.src_blk
                  and (c.src_blk + 1) * GK <= self.buf_rows_pad[c.src_buf],
                  "cell src_blk beyond padded buffer", InvalidArgumentsError)
            dst[t], src_buf[t], src_blk[t] = c.dst, c.src_buf, c.src_blk
            if c.w is None:
                kind[t] = 1
            elif isinstance(c.w, tuple):
                check(len(c.w) == 3 and c.w[0] == "dev",
                      "device tile ref must be ('dev', stack, idx)",
                      InvalidArgumentsError)
                _, sid, tidx = c.w
                check(0 <= sid < len(dev_tiles), "dev stack id out of range",
                      InvalidArgumentsError)
                check(0 <= tidx < dev_tiles[sid].shape[0],
                      "dev tile index out of range", InvalidArgumentsError)
                kind[t] = 0
                widx[t] = stack_base[sid] + tidx
            else:
                check(c.w.shape == (GM, GK), "weight tile must be (GM, GK)",
                      InvalidArgumentsError)
                kind[t] = 0
                widx[t] = len(wlist)
                wlist.append(np.asarray(c.w, np.float32))
        if not wlist and not dev_tiles:  # the kernel takes a weight pointer
            wlist.append(np.zeros((GM, GK), np.float32))
        # K2 reads every tile k-major: the stack is kept transposed, and
        # `W` is a view of it
        parts = []
        if wlist:
            parts.append(torch.from_numpy(np.stack(wlist)).to(device))
        parts += [s.to(device=device, dtype=torch.float32) for s in dev_tiles]
        self._Wt = torch.cat([w.transpose(1, 2) for w in parts])
        del parts
        dev_tiles.clear()  # free the pre-concat stacks

        blk_off = np.concatenate([[0], np.cumsum(self.buf_rows_pad)])[:-1]
        gsrc = blk_off[src_buf] // GK + src_blk  # block of the padded concat
        k0, k1 = kind == 0, kind == 1

        def dev(a):
            return torch.as_tensor(a, device=device)

        self._plain = {"widx0": dev(widx[k0]), "dst0": dev(dst[k0]),
                       "src0": dev(gsrc[k0]), "dst1": dev(dst[k1]),
                       "src1": dev(gsrc[k1])}
        lo, hi, useful = _tile_extents(self.W)
        tab = _cell_tables(self.n_out, dst, src_buf, src_blk, widx, kind,
                           lo, hi)
        # what K2 reads (an empty table still hands it a valid pointer)
        self._tables = {
            name: dev(np.ascontiguousarray(
                (a if a.size else np.full((1,) + a.shape[1:], -1))
                .astype(np.int32)))
            for name, a in tab.items()
            if name in ("order", "gptr", "grp", "ptr1", "ent1", "sorder",
                        "slices", "sptr", "chunks")}
        self.num_slices = tab["slices"].shape[0]
        # the matrix-vector engine's partials and arrival counters per r,
        # made at the first launch at that r; launches on one plan run in
        # stream order, as they share them
        self._mv_workspace: dict = {}
        # the trimmed matmul entries, CSR per output tile (host numpy)
        self.entries = (tab["ptr0"], tab["ent0"])
        self.num_cells = T
        self.num_matmul_cells = int(k0.sum())
        # matmul entries: pieces of cells per output tile before trimming,
        # entries left after it, and the groups K2 stages
        self.num_entries = (tab["split"], tab["ent0"].shape[0])
        self.num_groups = tab["grp"].shape[0]
        self.tile_work = tab["work"]
        self._flops = 2 * GM * GK * self.num_matmul_cells
        self._useful_flops = int(useful[widx[k0]].sum())
        self._executed_flops = int(tab["work"].sum())
        self._nbytes = self._Wt.numel() * 4

    def _new_mv_workspace(self, r: int, cols: int):
        """The matrix-vector engine's workspace at r, for column tiles of
        `cols`: the slices' partials and the tiles' arrival counters
        (zero; the last CTA of a tile resets its own)."""
        n_ctiles = -(-r // cols)
        n_tiles = self._tables["sptr"].numel() - 1
        ws = (torch.empty(self.num_slices * n_ctiles * GM * cols,
                          dtype=torch.float32, device=self.device),
              torch.zeros(n_tiles * n_ctiles, dtype=torch.int32,
                          device=self.device))
        self._mv_workspace[r] = ws
        return ws

    @property
    def W(self) -> torch.Tensor:
        """The weight stack (T, GM, GK), a view of the k-major copy that
        K2 reads."""
        return self._Wt.transpose(1, 2)

    def apply(self, bufs) -> torch.Tensor:
        """bufs: list of (rows_i, r) float32 tensors on the plan's device
        (rows_i <= buf_rows[i]). Returns (n_out, r). CUDA tensors run
        through K2, CPU tensors through `cells_plain`."""
        bufs = list(bufs)
        check(len(bufs) > 0, "apply needs the input buffers",
              InvalidArgumentsError)
        return (K2 if bufs[0].is_cuda else cells_plain)(self, bufs)

    def apply_plain(self, bufs) -> torch.Tensor:
        """The same apply through `cells_plain` on any device: the kernel's
        reference on the card."""
        return cells_plain(self, list(bufs))

    def flops_per_col(self) -> int:
        """Padded flops per column: every matmul cell as a full (GM, GK)
        product, zero padding included."""
        return self._flops

    def useful_flops_per_col(self) -> int:
        """Flops per column of the products without their zero padding:
        2 * nonzero rows * nonzero columns of each matmul cell's tile."""
        return self._useful_flops

    def executed_flops_per_col(self) -> int:
        """Flops per column that K2 executes: each group's covered rows
        times its depth, after trimming."""
        return self._executed_flops

    def nbytes(self) -> int:
        return self._nbytes


def _tile_extents(W: torch.Tensor):
    """One scan of the weight stack, in chunks, on its device. For every
    tile and each of its 8-row groups, the extent [lo, hi) of the columns
    holding a nonzero ((GK, 0) for a group of zeros), and the tile's useful
    flops per column: 2 * (rows holding a nonzero) * (columns holding a
    nonzero). Returns numpy arrays lo, hi (T, _NRG) and useful (T,)."""
    T = W.shape[0]
    lo = torch.empty((T, _NRG), dtype=torch.int64, device=W.device)
    hi = torch.empty_like(lo)
    useful = torch.empty(T, dtype=torch.int64, device=W.device)
    ar = torch.arange(GK, device=W.device)
    step = 4096
    for i in range(0, T, step):
        nz = W[i:i + step] != 0
        useful[i:i + step] = 2 * nz.any(2).sum(1) * nz.any(1).sum(1)
        g = nz.reshape(-1, _NRG, _RG, GK).any(2)
        lo[i:i + step] = torch.where(g, ar, GK).amin(2)
        hi[i:i + step] = torch.where(g, ar + 1, 0).amax(2)
    return lo.cpu().numpy(), hi.cpu().numpy(), useful.cpu().numpy()


def _split(n_out: int, dst):
    """The pieces of cells per 128-row output tile. A cell with
    dst % GM == off != 0 enters tile dst // GM with rows [off, GM) taking
    weight rows [0, GM - off), and the next tile with rows [0, off) taking
    weight rows [GM - off, GM). Returns (cell index, tile, out_row0,
    w_row0, nrows) of the pieces inside the output."""
    n_tiles = -(-n_out // GM)
    off = dst % GM
    s = off != 0
    idx = np.concatenate([np.arange(dst.size), np.flatnonzero(s)])
    tile = np.concatenate([dst // GM, dst[s] // GM + 1])
    o0 = np.concatenate([off, np.zeros(s.sum(), np.int64)])
    w0 = np.concatenate([np.zeros_like(off), GM - off[s]])
    nr = np.concatenate([GM - off, off[s]])
    keep = tile < n_tiles
    return idx[keep], tile[keep], o0[keep], w0[keep], nr[keep]


def _trim(widx, w0, nr, lo, hi):
    """Trim each matmul piece to the nonzero extent of its weight rows, in
    8-row groups, and to the columns holding a nonzero in those rows, in
    K2's K-chunks of _KC. Exact: only zero products are left out. Returns
    (keep, rows cut from the top, nrows, k0, k1); a piece whose rows hold
    no nonzero is not kept."""
    g = np.arange(_NRG)
    glo, ghi = lo[widx], hi[widx]
    nz = ((g >= (w0 // _RG)[:, None]) & (g < ((w0 + nr) // _RG)[:, None])
          & (glo < GK))
    first = nz.argmax(1)
    last = _NRG - 1 - nz[:, ::-1].argmax(1)
    k0 = np.where(nz, glo, GK).min(1) // _KC * _KC
    k1 = -(-np.where(nz, ghi, 0).max(1) // _KC) * _KC
    return (nz.any(1), first * _RG - w0, (last + 1 - first) * _RG, k0, k1)


def _group_ids(tile, src, row0, o0, nr, k0, k1) -> np.ndarray:
    """Group the sorted entries of each output tile that K2 stages as one
    chunk: consecutive entries of one source block with disjoint rows,
    merged while the merged group's work (row groups x K-chunks, each chunk
    also costing _CHUNK_COST_RG row groups of staging and barrier) is no
    more than the two groups' apart. Returns the group index of each
    entry."""
    gid = np.empty(tile.size, np.int64)
    g = -1
    key = None
    for e in range(tile.size):
        rg, c0, c1 = nr[e] // _RG, k0[e] // _KC, k1[e] // _KC
        if (key == (tile[e], src[e], row0[e]) and o0[e] >= end):
            u0, u1 = min(g0, c0), max(g1, c1)
            merged = (u1 - u0) * (_CHUNK_COST_RG + grg + rg)
            apart = ((g1 - g0) * (_CHUNK_COST_RG + grg)
                     + (c1 - c0) * (_CHUNK_COST_RG + rg))
            if merged <= apart:
                gid[e] = g
                g0, g1, grg, end = u0, u1, grg + rg, o0[e] + nr[e]
                continue
        g += 1
        gid[e] = g
        key = (tile[e], src[e], row0[e])
        g0, g1, grg, end = c0, c1, rg, o0[e] + nr[e]
    return gid


def _cell_tables(n_out: int, dst, src_buf, src_blk, widx, kind, lo, hi):
    """K2's input: the cells cut into per-tile entries, the matmul entries
    trimmed to their weight tiles' nonzero extent and grouped, and the
    output tiles in order of decreasing work.

    An entry is (widx, src_buf, first source row, out_row0 | w_row0 << 8 |
    nrows << 16 | (k0 / _KC) << 24 | (k1 / _KC) << 27): rows [out_row0,
    out_row0 + nrows) of its output tile take rows [w_row0, w_row0 + nrows)
    of the product of the weight tile's columns [k0, k1) with the source
    rows [first + k0, first + k1). A group (what K2 reads) is _GROUP_INTS
    int32: (src_buf, first source row, k0 / _KC | (k1 / _KC) << 8, mask of
    the row groups it covers, then per 8-row group of the output tile
    widx * _NRG + the weight tile's row group, or -1).

    Returns numpy arrays: ptr0/ent0 (the matmul entries' CSR per tile),
    gptr/grp (the groups' CSR), ptr1/ent1 (plain adds, untrimmed, depth
    [0, GK)), work (executed flops per column of each tile), order (tiles
    by decreasing work, stable), split (matmul pieces before trimming),
    and the matrix-vector engine's chunks, slices, sptr and sorder
    (`_slice_tables`)."""
    n_tiles = -(-n_out // GM)
    idx, tile, o0, w0, nr = _split(n_out, dst)
    mm = kind[idx] == 0
    k0 = np.zeros(idx.size, np.int64)
    k1 = np.full(idx.size, GK, np.int64)
    keep = np.ones(idx.size, bool)
    if mm.any():
        t_keep, cut, t_nr, t_k0, t_k1 = _trim(widx[idx[mm]], w0[mm], nr[mm],
                                              lo, hi)
        keep[mm] = t_keep
        o0[mm] += cut
        w0[mm] += cut
        nr[mm], k0[mm], k1[mm] = t_nr, t_k0, t_k1
    out = {"split": int(mm.sum())}

    def csr(sel):
        order = np.lexsort((o0[sel], src_blk[idx[sel]], src_buf[idx[sel]],
                            tile[sel]))
        s = np.flatnonzero(sel)[order]
        ent = np.stack([widx[idx[s]], src_buf[idx[s]], src_blk[idx[s]] * GK,
                        o0[s] | (w0[s] << 8) | (nr[s] << 16)
                        | (k0[s] // _KC << 24) | (k1[s] // _KC << 27)], 1)
        ptr = np.zeros(n_tiles + 1, np.int64)
        np.cumsum(np.bincount(tile[s], minlength=n_tiles), out=ptr[1:])
        return s, ptr, ent

    s0, out["ptr0"], ent0 = csr(keep & mm)
    _, out["ptr1"], out["ent1"] = csr(~mm)
    check(ent0.size == 0 or (ent0[:, 0].max() < 2 ** 27
                             and ent0[:, 2].max() < 2 ** 31),
          "cell tables exceed 32-bit indices", InvalidArgumentsError)
    out["ent0"] = ent0

    gid = _group_ids(tile[s0], src_buf[idx[s0]], src_blk[idx[s0]], o0[s0],
                     nr[s0], k0[s0], k1[s0])
    G = int(gid.max()) + 1 if gid.size else 0
    rgs = np.arange(_NRG)
    lo_rg, hi_rg = o0[s0] // _RG, (o0[s0] + nr[s0]) // _RG
    inside = (rgs >= lo_rg[:, None]) & (rgs < hi_rg[:, None])
    slots = np.where(inside, widx[idx[s0]][:, None] * _NRG
                     + (w0[s0] // _RG - lo_rg)[:, None] + rgs, -1)
    grp = np.full((G, _GROUP_INTS), -1, np.int64)
    np.maximum.at(grp[:, 4:], gid, slots)
    first = np.unique(gid, return_index=True)[1]
    c0 = np.full(G, _NRG, np.int64)
    c1 = np.zeros(G, np.int64)
    np.minimum.at(c0, gid, k0[s0] // _KC)
    np.maximum.at(c1, gid, k1[s0] // _KC)
    mask = np.zeros(G, np.int64)
    np.bitwise_or.at(mask, gid, (inside.astype(np.int64) << rgs).sum(1))
    rows = np.zeros(G, np.int64)
    np.add.at(rows, gid, nr[s0])
    grp[:, 0] = src_buf[idx[s0]][first]
    grp[:, 1] = src_blk[idx[s0]][first] * GK
    grp[:, 2] = c0 | (c1 << 8)
    grp[:, 3] = mask
    gtile = tile[s0][first]
    gptr = np.zeros(n_tiles + 1, np.int64)
    np.cumsum(np.bincount(gtile, minlength=n_tiles), out=gptr[1:])
    gwork = 2 * rows * _KC * (c1 - c0)
    out["work"] = np.bincount(gtile, weights=gwork,
                              minlength=n_tiles).astype(np.int64)
    out["order"] = np.argsort(-out["work"], kind="stable")
    out["gptr"], out["grp"] = gptr, grp
    out.update(_slice_tables(n_tiles, gtile, c0, c1, mask))
    return out


def _slice_tables(n_tiles: int, gtile, c0, c1, mask):
    """The matrix-vector engine's input: every chunk of every group, in
    group (so tile) order, and each tile's chunks cut into slices of at
    most _SLICE_CHUNKS chunks, as even as the count allows; a tile without
    chunks gets one empty slice, which stores it. Returns chunks (n, 2):
    (group, chunk); slices (S, 4): (tile, first chunk, end chunk, 0), in
    tile order; sptr, the slices' CSR per tile; sorder, the slices by
    decreasing work (covered row groups times chunks), stable."""
    nch = c1 - c0
    first = np.cumsum(nch) - nch
    total = int(nch.sum())
    cg = np.repeat(np.arange(nch.size), nch)
    chunks = np.stack([cg, c0[cg] + np.arange(total) - first[cg]], 1)
    per_tile = np.bincount(gtile, weights=nch, minlength=n_tiles
                           ).astype(np.int64)
    cptr = np.concatenate([[0], np.cumsum(per_tile)])
    ns = np.maximum(1, -(-per_tile // _SLICE_CHUNKS))
    sptr = np.concatenate([[0], np.cumsum(ns)])
    st = np.repeat(np.arange(n_tiles), ns)
    k = np.arange(st.size) - sptr[st]
    j0 = cptr[st] + per_tile[st] * k // ns[st]
    j1 = cptr[st] + per_tile[st] * (k + 1) // ns[st]
    rgs = sum((mask >> b) & 1 for b in range(_NRG))
    cw = np.concatenate([[0], np.cumsum(rgs[cg])])
    return {"chunks": chunks, "sptr": sptr,
            "slices": np.stack([st, j0, j1, np.zeros_like(st)], 1),
            "sorder": np.argsort(-(cw[j1] - cw[j0]), kind="stable")}


def cells_from_dense_block(W, i0: int, j0: int, out_cells: list) -> None:
    """Decompose one dense block (nr, nc) at row/col offset (i0, j0) into
    GM x GK cells appended to `out_cells`. The sub-8 row shift is embedded
    into the weight tiles, so `dst` stays 8-aligned with at most 7 rows of
    zero padding — no 128-row snapping inflation."""
    W = np.asarray(W, np.float32)
    nr, nc = W.shape
    shift_r = i0 % 8
    dst0 = i0 - shift_r
    c0 = j0 // GK
    shift_c = j0 % GK
    nrch = -(-(shift_r + nr) // GM)
    ncch = -(-(shift_c + nc) // GK)
    P = np.zeros((nrch * GM, ncch * GK), np.float32)
    P[shift_r:shift_r + nr, shift_c:shift_c + nc] = W
    for rch in range(nrch):
        for cch in range(ncch):
            tile = P[rch * GM:(rch + 1) * GM, cch * GK:(cch + 1) * GK]
            if not tile.any():
                continue
            out_cells.append(Cell(dst=dst0 + rch * GM, src_buf=0,
                                  src_blk=c0 + cch, w=tile))
