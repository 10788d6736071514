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
:199-205, :259-411), it builds one CSR list of *entries* per 128-row output
tile. A cell whose `dst` is not a multiple of 128 straddles two tiles and
enters both lists, each time with the row sub-range of its weight tile and
its row offset inside the output tile. K2 (`csrc/k2_cell.cu`) runs one CTA
per (output tile, 128-column tile) over that list, accumulates in
registers in IEEE float32 and stores each tile once. Source rows past the
end of a buffer read as zero and ragged columns are masked, so `apply`
pads nothing (the TPU's `round_r` is gone) and gives the same result at
any r.

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
from butterfly_tpu_torch.utils.device import resolve_device
from butterfly_tpu_torch.utils.errors import (
    InvalidArgumentsError,
    RuntimeButterflyError,
    check,
)
from butterfly_tpu_torch.utils.nvcc import load_kernel

__all__ = ["Cell", "CellPlan", "GM", "GK", "K2", "cells_from_dense_block",
           "cells_plain"]

GM = 128  # output rows per cell
GK = 128  # input rows per cell (= source block granularity)

_MAX_BUFS = 4  # kMaxBufs of the kernel
# bytes of gathered tiles per `cells_plain` chunk
_PLAIN_CHUNK_BYTES = 1 << 28


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


class _K2Kernel:
    """ctypes binding of `csrc/k2_cell.cu`. `launches` counts the kernel
    launches made through this wrapper; nothing else changes it."""

    def __init__(self):
        self.launches = 0
        self._lib = None

    def load(self) -> ctypes.CDLL:
        """Build (at first use) and load the kernel library."""
        if self._lib is None:
            lib = load_kernel("k2_cell.cu")
            P, I = ctypes.c_void_p, ctypes.c_int
            lib.k2_cells.argtypes = [P, P, P, I, P, P, P, P, P, I, I, P]
            lib.k2_cells.restype = I
            lib.k2_error_string.argtypes = [I]
            lib.k2_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def __call__(self, plan: "CellPlan", bufs) -> torch.Tensor:
        """The plan's cell program on CUDA tensors: bufs[i] (rows_i, r)
        float32 with rows_i <= plan.buf_rows[i] -> (n_out, r)."""
        r = _check_bufs(plan, bufs)
        for b in bufs:
            check(b.is_cuda, "K2 takes CUDA tensors", InvalidArgumentsError)
        lib = self.load()
        n = len(bufs)
        y = torch.empty((plan.n_out, r), dtype=torch.float32,
                        device=bufs[0].device)
        ptrs = (ctypes.c_void_p * n)(*[b.data_ptr() for b in bufs])
        rows = (ctypes.c_int64 * n)(*[b.shape[0] for b in bufs])
        t = plan._tables
        stream = torch.cuda.current_stream(y.device).cuda_stream
        with torch.cuda.device(y.device):
            err = lib.k2_cells(
                plan.W.data_ptr(), ptrs, rows, n, t["ptr0"].data_ptr(),
                t["ent0"].data_ptr(), t["ptr1"].data_ptr(),
                t["ent1"].data_ptr(), y.data_ptr(), plan.n_out, r, stream)
        if err != 0:
            raise RuntimeButterflyError(
                f"K2 launch failed: {lib.k2_error_string(err).decode()}")
        self.launches += 1
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
        parts = []
        if wlist:
            parts.append(torch.from_numpy(np.stack(wlist)).to(device))
        parts += [s.to(device=device, dtype=torch.float32) for s in dev_tiles]
        self.W = parts[0] if len(parts) == 1 else torch.cat(parts)
        dev_tiles.clear()  # free the pre-concat stacks

        blk_off = np.concatenate([[0], np.cumsum(self.buf_rows_pad)])[:-1]
        gsrc = blk_off[src_buf] // GK + src_blk  # block of the padded concat
        k0, k1 = kind == 0, kind == 1

        def dev(a):
            return torch.as_tensor(a, device=device)

        self._plain = {"widx0": dev(widx[k0]), "dst0": dev(dst[k0]),
                       "src0": dev(gsrc[k0]), "dst1": dev(dst[k1]),
                       "src1": dev(gsrc[k1])}
        self._tables = {
            name: dev(a) for name, a in zip(
                ("ptr0", "ent0", "ptr1", "ent1"),
                _entry_tables(self.n_out, dst[k0], src_buf[k0], src_blk[k0],
                              widx[k0])
                + _entry_tables(self.n_out, dst[k1], src_buf[k1],
                                src_blk[k1], widx[k1]))}
        self.num_cells = T
        self.num_matmul_cells = int(k0.sum())
        self._flops = 2 * GM * GK * self.num_matmul_cells
        self._useful_flops = _useful_flops(self.W, widx[k0])
        self._nbytes = self.W.numel() * 4

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
        """Executed flops per column: every matmul cell as a full
        (GM, GK) product, zero padding included."""
        return self._flops

    def useful_flops_per_col(self) -> int:
        """Flops per column of the products without their zero padding:
        2 * nonzero rows * nonzero columns of each matmul cell's tile."""
        return self._useful_flops

    def nbytes(self) -> int:
        return self._nbytes


def _useful_flops(W: torch.Tensor, widx: np.ndarray) -> int:
    """2 * sum over the cells' tiles W[widx] of (rows holding a nonzero) *
    (columns holding a nonzero), counted in chunks of the weight stack."""
    rows = torch.empty(W.shape[0], dtype=torch.int64, device=W.device)
    cols = torch.empty_like(rows)
    step = 4096
    for i in range(0, W.shape[0], step):
        nz = W[i:i + step] != 0
        rows[i:i + step] = nz.any(2).sum(1)
        cols[i:i + step] = nz.any(1).sum(1)
    per_tile = (rows * cols).cpu().numpy()
    return int(2 * per_tile[widx].sum())


def _entry_tables(n_out: int, dst, src_buf, src_blk, widx):
    """CSR entry lists per 128-row output tile (K2's input).

    Returns (ptr (n_tiles+1,) int32, ent (E, 4) int32). An entry is
    (widx, src_buf, first source row, out_row0 | w_row0 << 8 | nrows << 16):
    rows [out_row0, out_row0 + nrows) of the output tile take rows
    [w_row0, w_row0 + nrows) of the cell's product. A cell with
    dst % GM == off != 0 enters tile dst // GM with (off, 0, GM - off) and
    the next tile with (0, GM - off, off)."""
    n_tiles = -(-n_out // GM)
    off = dst % GM
    first = np.stack([dst // GM, off, np.zeros_like(off), GM - off], 1)
    s = off != 0
    second = np.stack([dst[s] // GM + 1, np.zeros(s.sum(), np.int64),
                       GM - off[s], off[s]], 1)
    idx = np.concatenate([np.arange(dst.size), np.flatnonzero(s)])
    geo = np.concatenate([first, second])  # (tile, out_row0, w_row0, nrows)
    keep = geo[:, 0] < n_tiles
    idx, geo = idx[keep], geo[keep]
    order = np.lexsort((src_blk[idx], src_buf[idx], geo[:, 0]))
    idx, geo = idx[order], geo[order]
    ent = np.stack([widx[idx], src_buf[idx], src_blk[idx] * GK,
                    geo[:, 1] | (geo[:, 2] << 8) | (geo[:, 3] << 16)], 1)
    check(ent.size == 0 or (ent[:, 0].max() < 2 ** 31
                            and ent[:, 2].max() < 2 ** 31),
          "cell tables exceed 32-bit indices", InvalidArgumentsError)
    ptr = np.zeros(n_tiles + 1, np.int64)
    np.cumsum(np.bincount(geo[:, 0], minlength=n_tiles), out=ptr[1:])
    # an empty list still hands the kernel a valid pointer
    ent = ent if ent.size else np.zeros((1, 4), np.int64)
    return ptr.astype(np.int32), np.ascontiguousarray(ent.astype(np.int32))


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
