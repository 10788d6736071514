"""The packed device runtime: LinOp trees -> level-synchronous batched GEMMs.

Port counterpart of `butterfly_tpu/ops/packed.py`. The planning is the
JAX package's host NumPy code, copied: the flattening of a LinOp tree into
chains of single-stage factors (`_single_stage`, `_expand_product`,
`_flatten`), the shape bucketing, and the per-stage exchange tables of
`StagePlan.__init__`. Only the executor changes: the
jitted `_apply_plan` becomes eager PyTorch on the plan's device
(`index_select` for the exchange takes, one batched `torch.bmm` per bucket
in IEEE float32, a take-sum where several units write one row). It is
plain tensor code: the JAX package runs it through XLA, not through a
Pallas kernel.

Left out: `params_on_host`, `pin_params` and `unpin_params` (:690-720),
which stream weights host-to-device for a 16 GB TPU v5e; the card holds
them. Also the group tiling (`_plan_group_tiling` and its cost model of the
TPU's matrix unit), which split ragged blocks onto one or two tile shapes
per stage to save the TPU's per-bucket dispatch cost: here every GEMM unit
keeps its own padded shape, one bucket per shape.

`real_embed` defaults to False and never depends on the backend: callers
that want the stacked 2x2 real embedding of a complex operator ask for it.

This is the replacement for the reference's interpreted apply path, where
every matvec walks a recursive object graph making one tiny BLAS call per
block (reference: bfMatBlockDenseMulVec src/mat_block_dense.c:574-630,
MatProduct apply src/fac.c:133-146). Here the graph is flattened ONCE at
pack time into a `StagePlan`:

- every leaf dense block becomes a GEMM *unit* with global gather (input) and
  scatter-add (output) index ranges;
- every Identity/Diag/Perm block becomes a *scale unit* (gather, multiply,
  scatter) with no FLOPs;
- units are scheduled into *stages* (factor k of a Product chain runs at
  stage k; different chains of a multilevel factorization overlap stages);
- within a (stage, output-buffer) group, units are *bucketed* by padded block
  shape: one bucket = one batched (B, m, k) x (B, k, r) product;
- the inter-level butterfly re-blocking is carried entirely by the gather /
  scatter index tables.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from butterfly_tpu_torch.ops import linop as L
from butterfly_tpu_torch.ops.butterfly import _f32_precision
from butterfly_tpu_torch.utils.device import resolve_device
from butterfly_tpu_torch.utils.errors import (
    InvalidArgumentsError,
    NotImplementedButterflyError,
    check,
)

__all__ = ["StagePlan", "pack", "PackedApplyStats"]

_TORCH_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.complex64): torch.complex64,
    np.dtype(np.complex128): torch.complex128,
}


def _np_dtype(dtype) -> np.dtype:
    """numpy dtype of a numpy- or torch-style dtype."""
    if isinstance(dtype, torch.dtype):
        for k, v in _TORCH_DTYPES.items():
            if v == dtype:
                return k
    dtype = np.dtype(dtype)
    check(dtype in _TORCH_DTYPES,
          f"packed plans take float32/64 or complex64/128, not {dtype}",
          InvalidArgumentsError)
    return dtype


# ---------------------------------------------------------------------------
# Flattening: LinOp tree -> chains of single-stage factors of units
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _GemmUnit:
    data: np.ndarray  # (m, k) dense block
    in_off: int  # offset into the chain-stage input vector
    out_off: int  # offset into the chain-stage output vector


@dataclasses.dataclass
class _ScaleUnit:
    weights: np.ndarray  # (L,) elementwise weights; in/out are index ARRAYS
    in_idx: np.ndarray  # (L,) chain-stage-relative input indices
    out_idx: np.ndarray  # (L,) chain-stage-relative output indices


@dataclasses.dataclass
class _Factor:
    in_dim: int
    out_dim: int
    gemms: list[_GemmUnit]
    scales: list[_ScaleUnit]


@dataclasses.dataclass
class _Chain:
    i0: int  # global output row offset
    j0: int  # global input col offset
    factors: list[_Factor]  # applied first-to-last
    src: object = None      # the Product LinOp this chain came from
    src_scale: complex | float = 1.0  # scale folded into the first factor


def _single_stage(op: L.LinOp, scale: complex | float = 1.0) -> _Factor:
    """Flatten `op` into ONE stage of units; raises if impossible."""
    m, n = op.shape
    f = _Factor(in_dim=n, out_dim=m, gemms=[], scales=[])

    def add(sub: L.LinOp, i0: int, j0: int, s) -> None:
        if isinstance(sub, L.Scaled):
            add(sub.op, i0, j0, s * sub.alpha)
        elif isinstance(sub, L.Dense):
            data = sub.data if s == 1.0 else s * sub.data
            f.gemms.append(_GemmUnit(np.asarray(data), j0, i0))
        elif isinstance(sub, L.Identity):
            k = sub.shape[0]
            f.scales.append(
                _ScaleUnit(
                    np.full(k, s), np.arange(j0, j0 + k), np.arange(i0, i0 + k)
                )
            )
        elif isinstance(sub, L.Diag):
            k = sub.diag.size
            f.scales.append(
                _ScaleUnit(
                    s * sub.diag, np.arange(j0, j0 + k), np.arange(i0, i0 + k)
                )
            )
        elif isinstance(sub, L.Perm):
            k = sub.perm.size
            f.scales.append(
                _ScaleUnit(np.full(k, s), j0 + sub.perm, i0 + np.arange(k))
            )
        elif isinstance(sub, L.Zero):
            pass
        elif isinstance(sub, L.BlockDiag):
            for kk, b in enumerate(sub.blocks):
                add(b, i0 + int(sub.row_offsets[kk]), j0 + int(sub.col_offsets[kk]), s)
        elif isinstance(sub, L.BlockCoo):
            for kk, b in enumerate(sub.blocks):
                bi, bj = int(sub.row_inds[kk]), int(sub.col_inds[kk])
                add(b, i0 + int(sub.row_offsets[bi]), j0 + int(sub.col_offsets[bj]), s)
        elif isinstance(sub, L.BlockDense):
            for bi, row in enumerate(sub.grid):
                for bj, b in enumerate(row):
                    add(
                        b,
                        i0 + int(sub.row_offsets[bi]),
                        j0 + int(sub.col_offsets[bj]),
                        s,
                    )
        else:
            raise NotImplementedButterflyError(
                f"cannot pack {type(sub).__name__} as a single stage"
            )

    add(op, 0, 0, scale)
    return f


def _expand_product(op: L.LinOp) -> list[L.LinOp]:
    """Application-order factor list with nested Products inlined."""
    if isinstance(op, L.Product):
        out: list[L.LinOp] = []
        for f in reversed(op.factors):
            out.extend(_expand_product(f))
        return out
    return [op]


def _flatten(op: L.LinOp, i0: int, j0: int, chains: list[_Chain],
             scale: complex | float = 1.0) -> None:
    """Flatten into chains (multi-stage leaf paths positioned at (i0, j0))."""
    if isinstance(op, L.Scaled):
        _flatten(op.op, i0, j0, chains, scale * op.alpha)
    elif isinstance(op, L.Product):
        factors = _expand_product(op)  # application order, nested flattened
        staged = []
        for idx, f in enumerate(factors):
            # fold the scalar into the first factor only
            staged.append(_single_stage(f, scale if idx == 0 else 1.0))
        chains.append(_Chain(i0, j0, staged, src=op, src_scale=scale))
    elif isinstance(op, L.BlockDense):
        for bi, row in enumerate(op.grid):
            for bj, b in enumerate(row):
                _flatten(
                    b,
                    i0 + int(op.row_offsets[bi]),
                    j0 + int(op.col_offsets[bj]),
                    chains,
                    scale,
                )
    elif isinstance(op, L.BlockDiag):
        for kk, b in enumerate(op.blocks):
            _flatten(
                b, i0 + int(op.row_offsets[kk]), j0 + int(op.col_offsets[kk]),
                chains, scale,
            )
    elif isinstance(op, L.BlockCoo):
        for kk, b in enumerate(op.blocks):
            bi, bj = int(op.row_inds[kk]), int(op.col_inds[kk])
            _flatten(
                b, i0 + int(op.row_offsets[bi]), j0 + int(op.col_offsets[bj]),
                chains, scale,
            )
    elif isinstance(op, L.Sum):
        for t in op.terms:
            _flatten(t, i0, j0, chains, scale)
    elif isinstance(op, L.Diff):
        _flatten(op.a, i0, j0, chains, scale)
        _flatten(op.b, i0, j0, chains, -scale)
    else:
        # single-stage leaf (Dense / Identity / Diag / Perm / Zero / nested
        # block-of-dense)
        chains.append(_Chain(i0, j0, [_single_stage(op, scale)]))


# ---------------------------------------------------------------------------
# Bucketing and the executable plan
# ---------------------------------------------------------------------------


def _round_up(x: int, align: int) -> int:
    if x <= align:
        # small dims: next power of two, at least 1
        p = 1
        while p < x:
            p <<= 1
        return p
    return -(-x // align) * align


@dataclasses.dataclass
class _GemmBucket:
    """Every GEMM unit reads/writes a CONTIGUOUS row range of its buffer in
    the op's LOGICAL coordinates; the executor compiles these into unrolled
    activation layouts + one exchange take per stage (see _apply_plan)."""

    weights: torch.Tensor  # (B, m_pad, k_pad) padded, pad entries zero
    in_start: np.ndarray  # (B,) int32 logical row starts (read side)
    out_start: np.ndarray  # (B,) int32 logical row starts (write side)
    mms: np.ndarray  # (B,) true (unpadded) output rows per unit
    kks: np.ndarray  # (B,) true (unpadded) input rows per unit
    read_buf: int
    write_buf: int
    flops_real: int  # unpadded useful flops per RHS column (x2 for mul-add)


@dataclasses.dataclass
class _ScaleBucket:
    weights: torch.Tensor  # (L,)
    in_idx: np.ndarray  # (L,) int64
    out_idx: np.ndarray  # (L,) int64
    read_buf: int
    write_buf: int


@dataclasses.dataclass
class PackedApplyStats:
    num_stages: int
    num_gemm_buckets: int
    num_scale_buckets: int
    useful_flops_per_col: int  # 2*m*k summed over gemm units
    padded_flops_per_col: int
    weight_bytes: int
    padding_waste: float  # 1 - useful/padded


class StagePlan:
    """Executable packed form of a LinOp: buffers + bucketed stages.

    `real_embed`: map a complex operator onto REAL buffers via the standard
    2x2 embedding — every buffer of size S becomes [Re; Im] of size 2S and a
    complex block Z = A + iB becomes four real GEMM units (A, -B, B, A) wired
    between the halves. The partition apply uses it: its buffers are real
    (the reference's zgemv hot loop, src/mat_dense_complex.c:1072, in real
    arithmetic). Flop accounting stays exact: 4 real (m, k) units = 8mk
    flops = one complex madd's true cost. Default: no embedding; a complex
    operator then applies in complex arithmetic. Weights and index tables
    live on `device` (default: the card).

    `chains`: pack only these positioned chains of `op` (from `_flatten`;
    the partition plan packs its oversized blocks together this way);
    default all of them.
    """

    def __init__(self, op: L.LinOp, dtype=None, block_align: int = 128,
                 real_embed: bool = False, device=None, chains=None):
        device = resolve_device(device)
        self.device = device

        def _dev(a):
            return torch.as_tensor(np.ascontiguousarray(a)).to(device)

        m, n = op.shape
        self.shape = (m, n)
        op_complex = np.issubdtype(op.dtype, np.complexfloating)
        if dtype is None:
            dtype = np.complex64 if op_complex else np.float32
        dtype = _np_dtype(dtype)
        self.real_embed = bool(real_embed) and np.issubdtype(
            dtype, np.complexfloating
        )
        if self.real_embed:
            # compute in the matching real dtype; split/recombine at the edges
            self._io_dtype = dtype
            dtype = np.zeros(0, dtype).real.dtype
        self.dtype = dtype

        if chains is None:
            chains = []
            _flatten(op, 0, 0, chains)
        num_stages = max(len(c.factors) for c in chains)

        # Assign global offsets for each chain's intermediate vectors.
        # Buffer 0 is the input (size n); buffer t in 1..num_stages-1 holds
        # intermediates of chains still in flight; the OUTPUT buffer is
        # addressed separately (write_buf == -1 means output).
        buf_sizes = [n] + [0] * (num_stages - 1)
        chain_offsets: list[list[int]] = []  # per chain: offset of stage-t input
        for c in chains:
            offs = [c.j0]  # stage-0 input is the global input at j0
            for t in range(1, len(c.factors)):
                offs.append(buf_sizes[t])
                buf_sizes[t] += c.factors[t].in_dim
            chain_offsets.append(offs)
        # Collect units with global indices (original, un-embedded buffers).
        raw_gemms: list[tuple] = []  # (t, write_buf, data, in_base, out_base)
        raw_scales: list[tuple] = []  # (t, write_buf, weights, in_idx, out_idx)
        for c, offs in zip(chains, chain_offsets):
            last = len(c.factors) - 1
            for t, f in enumerate(c.factors):
                in_base = offs[t]
                write_buf = -1 if t == last else t + 1
                out_base = c.i0 if t == last else offs[t + 1]
                for u in f.gemms:
                    raw_gemms.append(
                        (t, write_buf, u.data, in_base + u.in_off,
                         out_base + u.out_off)
                    )
                for u in f.scales:
                    raw_scales.append(
                        (t, write_buf, u.weights, in_base + u.in_idx,
                         out_base + u.out_idx)
                    )

        if self.real_embed:
            # Buffer convention: size-S complex buffer -> size-2S real buffer
            # holding [Re; Im]. Complex Z = A + iB becomes the 2x2 real block
            # [[A, -B], [B, A]]: four (m, k) units between the halves (real
            # data keeps just the two diagonal copies).
            def in_half(t):
                return buf_sizes[t]

            def out_half(wb):
                return m if wb == -1 else buf_sizes[wb]

            eg, es = [], []
            for (t, wb, data, jb, ib) in raw_gemms:
                si, so = in_half(t), out_half(wb)
                A = np.ascontiguousarray(data.real)
                eg.append((t, wb, A, jb, ib))
                eg.append((t, wb, A, si + jb, so + ib))
                if np.issubdtype(data.dtype, np.complexfloating):
                    B = np.ascontiguousarray(data.imag)
                    if np.any(B):
                        eg.append((t, wb, -B, si + jb, ib))
                        eg.append((t, wb, B, jb, so + ib))
            for (t, wb, w, iix, oix) in raw_scales:
                si, so = in_half(t), out_half(wb)
                wr = np.ascontiguousarray(np.asarray(w).real)
                es.append((t, wb, wr, iix, oix))
                es.append((t, wb, wr, si + iix, so + oix))
                if np.issubdtype(np.asarray(w).dtype, np.complexfloating):
                    wi = np.ascontiguousarray(np.asarray(w).imag)
                    if np.any(wi):
                        es.append((t, wb, -wi, si + iix, oix))
                        es.append((t, wb, wi, iix, so + oix))
            raw_gemms, raw_scales = eg, es
            buf_sizes = [2 * s for s in buf_sizes]
            m = 2 * m

        self.buf_sizes = buf_sizes
        self.out_size = m

        # Bucket the GEMM units: one bucket per (stage, write-buffer,
        # padded shape), each unit padded to `block_align` in both dims.
        gemm_groups: dict[tuple, list] = {}
        scale_groups: dict[tuple, list] = {}
        for (t, write_buf, data, jbase, ibase) in raw_gemms:
            mm, kk = data.shape
            key = (t, write_buf, _round_up(mm, block_align),
                   _round_up(kk, block_align))
            gemm_groups.setdefault(key, []).append((data, jbase, ibase))
        for (t, write_buf, w, iix, oix) in raw_scales:
            scale_groups.setdefault((t, write_buf), []).append((w, iix, oix))

        # Materialize buckets. Weights are zero-padded to the bucket tile, so
        # padded input rows multiply zero columns and padded output rows are
        # exact zeros — the executor's index tables exploit both.
        self._gemm_buckets: list[_GemmBucket] = []
        self._scale_buckets: list[_ScaleBucket] = []
        useful = 0
        padded = 0
        weight_bytes = 0
        for (t, wb, mp, kp), units in sorted(gemm_groups.items()):
            B = len(units)
            W = np.zeros((B, mp, kp), dtype=self.dtype)
            in_start = np.zeros(B, dtype=np.int64)
            out_start = np.zeros(B, dtype=np.int64)
            mms = np.zeros(B, dtype=np.int64)
            kks = np.zeros(B, dtype=np.int64)
            fl = 0
            for b, (data, jbase, ibase) in enumerate(units):
                mm, kk = data.shape
                W[b, :mm, :kk] = data
                in_start[b] = jbase
                out_start[b] = ibase
                mms[b] = mm
                kks[b] = kk
                fl += 2 * mm * kk
            useful += fl
            padded += 2 * B * mp * kp
            weight_bytes += W.nbytes
            self._gemm_buckets.append(
                _GemmBucket(_dev(W), in_start, out_start, mms, kks,
                            t, wb, fl)
            )
        for (t, wb), units in sorted(scale_groups.items()):
            wts = np.concatenate([np.asarray(w) for w, _, _ in units])
            iix = np.concatenate([np.asarray(i) for _, i, _ in units])
            oix = np.concatenate([np.asarray(o) for _, _, o in units])
            self._scale_buckets.append(
                _ScaleBucket(
                    _dev(wts.astype(self.dtype)),
                    iix.astype(np.int64), oix.astype(np.int64), t, wb,
                )
            )

        self.stats = PackedApplyStats(
            num_stages=num_stages,
            num_gemm_buckets=len(self._gemm_buckets),
            num_scale_buckets=len(self._scale_buckets),
            useful_flops_per_col=useful,
            padded_flops_per_col=padded,
            weight_bytes=weight_bytes,
            padding_waste=1.0 - useful / max(padded, 1),
        )
        self.num_stages = num_stages

        # -- compile the buckets into the exchange-table executor ----------
        # Per stage, activations live UNROLLED: every unit's (padded) input
        # window is a contiguous region, so reads are static slices and the
        # whole inter-stage re-blocking (the butterfly exchange) is ONE take
        # with a precomputed (rows, c_max) table into the previous stage's
        # concatenated outputs, followed by a length-c_max dense sum for rows
        # with multiple contributors. No scatter anywhere.

        # read_coords[t]: logical coordinate each unrolled activation row of
        #   stage t wants (-1 = guaranteed zero).
        # write maps[t][target]: per logical coordinate, the y_cat row ids
        #   produced at stage t that accumulate there.
        read_coords: list[np.ndarray] = []
        stage_metas = []
        stage_weights = []
        writer_lists: list[dict[int, tuple[np.ndarray, np.ndarray]]] = []
        for t in range(num_stages):
            coords_list: list[np.ndarray] = []
            gemm_metas: list[_StageGemm] = []
            Ws: list = []
            scale_metas: list[_StageScale] = []
            ws: list = []
            # (target) -> list of (y_row_ids, logical coords) contributions
            wl: dict[int, list[tuple[np.ndarray, np.ndarray]]] = {}
            in_off = 0
            y_off = 0
            for b in self._gemm_buckets:
                if b.read_buf != t:
                    continue
                B, mp, kp = b.weights.shape
                c = b.in_start[:, None] + np.arange(kp)[None, :]
                c[np.arange(kp)[None, :] >= b.kks[:, None]] = -1
                coords_list.append(c.reshape(-1))
                gemm_metas.append(_StageGemm(in_off, B, mp, kp, b.write_buf))
                in_off += B * kp
                Ws.append(b.weights)
                o = b.out_start[:, None] + np.arange(mp)[None, :]
                valid = np.arange(mp)[None, :] < b.mms[:, None]
                rid = y_off + np.arange(B * mp).reshape(B, mp)
                wl.setdefault(b.write_buf, []).append(
                    (rid[valid], o[valid])
                )
                y_off += B * mp
            for b in self._scale_buckets:
                if b.read_buf != t:
                    continue
                S = int(b.in_idx.shape[0])
                coords_list.append(b.in_idx)
                scale_metas.append(_StageScale(in_off, S, b.write_buf))
                in_off += S
                ws.append(b.weights)
                wl.setdefault(b.write_buf, []).append(
                    (y_off + np.arange(S), b.out_idx)
                )
                y_off += S
            read_coords.append(
                np.concatenate(coords_list)
                if coords_list else np.zeros(0, np.int64)
            )
            writer_lists.append(
                {wb: (np.concatenate([r for r, _ in ps]),
                      np.concatenate([c for _, c in ps]))
                 for wb, ps in wl.items()}
            )
            stage_metas.append(
                _StageMeta(gemms=tuple(gemm_metas), scales=tuple(scale_metas),
                           y_rows=y_off)
            )
            stage_weights.append((Ws, ws))

        def _build_map(rids, coords, size, zero_id):
            """(size, c_max) table of y_cat row ids per logical coordinate."""
            ok = (coords >= 0) & (coords < size)
            rids, coords = rids[ok], coords[ok]
            order = np.argsort(coords, kind="stable")
            rids, coords = rids[order], coords[order]
            counts = np.bincount(coords, minlength=size)
            c_max = max(1, int(counts.max(initial=0)))
            tab = np.full((size, c_max), zero_id, dtype=np.int64)
            slot = np.arange(rids.size) - np.repeat(
                np.concatenate([[0], np.cumsum(counts)[:-1]]), counts
            )
            tab[coords, slot] = rids
            return tab

        stage_params = []
        for t in range(num_stages):
            Ws, ws = stage_weights[t]
            zero_id = stage_metas[t].y_rows
            # out contribution table for this stage
            wmap = writer_lists[t]
            out_tab = None
            if -1 in wmap:
                rids, coords = wmap[-1]
                out_tab = _dev(_build_map(
                    rids, coords, self.out_size, zero_id))
            # next stage's unrolled read table (composed through this
            # stage's write map over buffer t+1's logical coordinates)
            next_tab = None
            if t + 1 < num_stages:
                size = self.buf_sizes[t + 1]
                M = _build_map(*wmap.get(t + 1, (np.zeros(0, np.int64),
                                                 np.zeros(0, np.int64))),
                               size=size, zero_id=zero_id)
                rc = read_coords[t + 1]
                ok = (rc >= 0) & (rc < size)
                F = np.full((rc.size, M.shape[1]), zero_id, dtype=np.int64)
                F[ok] = M[rc[ok]]
                next_tab = _dev(F)
            stage_params.append((Ws, ws, out_tab, next_tab))

        # stage-0 input table: unrolled read layout straight from x (whose
        # device length is buf_sizes[0] — 2n when real-embedded)
        n_in = self.buf_sizes[0]
        rc0 = read_coords[0] if num_stages else np.zeros(0, np.int64)
        idx0 = np.where((rc0 >= 0) & (rc0 < n_in), rc0, n_in)
        self._params = (_dev(idx0.astype(np.int64)), stage_params)

        self._meta = _PlanMeta(
            num_stages=num_stages,
            out_size=self.out_size,
            dtype=_TORCH_DTYPES[np.dtype(self.dtype)],
            stages=tuple(stage_metas),
        )

    # -- application ----------------------------------------------------

    def _as_tensor(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            check(x.device == self.device,
                  f"operand on {x.device}, plan on {self.device}",
                  InvalidArgumentsError)
            return x
        return torch.as_tensor(np.asarray(x)).to(self.device)

    def _run(self, x: torch.Tensor) -> torch.Tensor:
        was_vec = x.ndim == 1
        if was_vec:
            x = x[:, None]
        check(x.ndim == 2 and x.shape[0] == self.buf_sizes[0],
              f"operand of shape {tuple(x.shape)} does not match the plan's "
              f"input length {self.buf_sizes[0]}", InvalidArgumentsError)
        y = _apply_plan(self._meta, self._params, x)
        return y[:, 0] if was_vec else y

    def __call__(self, x) -> torch.Tensor:
        """Apply to (n,) or (n, r) (a tensor on the plan's device, or a
        numpy array); returns a tensor on the plan's device. A real_embed
        plan takes and returns complex values and computes on the stacked
        [Re; Im] real form."""
        x = self._as_tensor(x)
        if self.real_embed:
            was_vec = x.ndim == 1
            if was_vec:
                x = x[:, None]
            xr = torch.cat([x.real, x.imag] if x.is_complex()
                           else [x, torch.zeros_like(x)])
            yr = self.apply_stacked(xr)
            mh = self.shape[0]
            y = torch.complex(yr[:mh], yr[mh:]).to(
                _TORCH_DTYPES[np.dtype(self._io_dtype)])
            return y[:, 0] if was_vec else y
        return self._run(x)

    def apply_stacked(self, xr) -> torch.Tensor:
        """Apply in stacked-real form: (2n, r) -> (2m, r), for real_embed
        plans only — lets iterative solvers stay on the device across
        complex applies."""
        check(self.real_embed, "apply_stacked requires a real_embed plan",
              InvalidArgumentsError)
        return self._run(self._as_tensor(xr))

    def matmat(self, X) -> torch.Tensor:
        """Batched multi-RHS apply (alias of __call__ for solver interop)."""
        return self(X)

    def materialize(self) -> np.ndarray:
        """Dense matrix of the packed op (for oracle tests)."""
        dt = self._io_dtype if self.real_embed else self.dtype
        return self(np.eye(self.shape[1], dtype=dt)).cpu().numpy()


@dataclasses.dataclass(frozen=True)
class _StageGemm:
    """One GEMM bucket inside a stage program (static part)."""

    in_off: int   # row offset of this bucket's windows inside g_all
    B: int
    mp: int
    kp: int
    target: int   # -1 = output, else the next buffer id


@dataclasses.dataclass(frozen=True)
class _StageScale:
    in_off: int
    count: int
    target: int


@dataclasses.dataclass(frozen=True)
class _StageMeta:
    gemms: tuple    # tuple[_StageGemm, ...]
    scales: tuple   # tuple[_StageScale, ...]
    y_rows: int     # rows of this stage's concatenated output y_cat


@dataclasses.dataclass(frozen=True)
class _PlanMeta:
    """Static plan topology."""

    num_stages: int
    out_size: int
    dtype: torch.dtype
    stages: tuple  # tuple[_StageMeta, ...]


def _take_sum(y_ext: torch.Tensor, tab: torch.Tensor, r: int) -> torch.Tensor:
    """tab: (rows, c_max) ids into y_ext; rows with fewer contributors point
    at the trailing zero row. Returns the (rows, r) accumulation as a dense
    take (+ sum) — no scatter."""
    c = tab.shape[1]
    if c == 1:
        return y_ext.index_select(0, tab[:, 0])
    g = y_ext.index_select(0, tab.reshape(-1))
    return g.reshape(tab.shape[0], c, r).sum(dim=1)


def _apply_plan(meta: _PlanMeta, params, x: torch.Tensor) -> torch.Tensor:
    """The staged executor, eager on the plan's device.

    Activations live UNROLLED per stage: every GEMM unit's padded input
    window is a contiguous slice, so bucket reads are free, each bucket is
    one batched `torch.bmm`, and the entire inter-stage re-blocking (the
    butterfly exchange) is ONE precomputed take (+ a length-c_max dense sum
    where block rows genuinely accumulate). There is no scatter anywhere."""
    idx0, stage_params = params
    r = x.shape[1]
    dt = meta.dtype
    zero = torch.zeros((1, r), dtype=dt, device=x.device)
    x_ext = torch.cat([x.to(dt), zero])
    g = x_ext.index_select(0, idx0)
    out = torch.zeros((meta.out_size, r), dtype=dt, device=x.device)
    # the accuracy-critical factorized-operator path: IEEE float32 products
    # (no TF32), which the reference's rel-err budget needs
    with _f32_precision("highest"):
        for t, sm in enumerate(meta.stages):
            Ws, ws, out_tab, next_tab = stage_params[t]
            pieces = []
            for gm, W in zip(sm.gemms, Ws):
                gi = g[gm.in_off:gm.in_off + gm.B * gm.kp]
                y = torch.bmm(W, gi.reshape(gm.B, gm.kp, r))
                pieces.append(y.reshape(gm.B * gm.mp, r))
            for scm, w in zip(sm.scales, ws):
                pieces.append(g[scm.in_off:scm.in_off + scm.count]
                              * w[:, None])
            y_ext = torch.cat(pieces + [zero])
            if out_tab is not None:
                out = out + _take_sum(y_ext, out_tab, r)
            if next_tab is not None:
                g = _take_sum(y_ext, next_tab, r)
    return out


def pack(op: L.LinOp, dtype=None, block_align: int = 128,
         real_embed: bool = False, device=None, chains=None) -> StagePlan:
    """Compile a LinOp (or the `chains` of it) into its packed device plan
    on `device`."""
    return StagePlan(op, dtype=dtype, block_align=block_align,
                     real_embed=real_embed, device=device, chains=chains)
