"""Host-side packed apply: the NumPy twin of ops/packed.py.

Port counterpart of `butterfly_tpu/ops/hostpack.py`, copied (numpy only)
so that the port imports nothing of the JAX package. It reads the port's
`ops/packed.py` flattening (`_flatten`) and shape rounding (`_round_up`),
which are the JAX package's, copied.

Factorization-time math (solver builds, streamer sketches, oracle checks)
applies compressed LinOps thousands of times on the host in f64. Walking the
recursive LinOp graph per apply costs one tiny GEMM dispatch per block —
the exact pathology the reference has at src/mat_block_dense.c:574-630 and
that profiling showed dominating the fast-direct-solver build. `HostPlan`
flattens the operator ONCE through the same stage/bucket machinery as the
device plan (ops/packed.py) and applies it as a few batched numpy einsums
per stage, with contiguous-window gathers/scatter-adds.

The ADJOINT apply runs the same buckets in reverse stage order with
conjugate-transposed weights (gather from the output windows, scatter into
the input windows) — one pack serves both directions, which is what the
randomized sampler needs (matvec + rmatvec).
"""

from __future__ import annotations

import numpy as np

from butterfly_tpu_torch.ops import packed as packed_mod
from butterfly_tpu_torch.ops.linop import LinOp
from butterfly_tpu_torch.utils.errors import check

__all__ = ["HostPlan", "hostpack"]


class _HBucket:
    __slots__ = ("W", "in_start", "out_start", "kp", "mp", "read_buf",
                 "write_buf", "flops", "in_idx", "out_info", "in_info")

    def __init__(self, W, in_start, out_start, read_buf, write_buf, flops):
        self.W = W
        self.in_start = in_start
        self.out_start = out_start
        self.kp = W.shape[2]
        self.mp = W.shape[1]
        self.read_buf = read_buf
        self.write_buf = write_buf
        self.flops = flops
        # Vectorized index plans: gathers as one fancy index; scatters as
        # one fancy += when windows are pairwise disjoint-or-identical (the
        # block-structure common case), else a per-block loop fallback.
        self.in_idx = in_start[:, None] + np.arange(self.kp)[None, :]
        self.out_info = _scatter_plan(out_start, self.mp)
        self.in_info = _scatter_plan(in_start, self.kp)  # rmatmat scatter


class _ScatterPlan:
    __slots__ = ("mode", "idx", "uniq_idx", "inv")

    def __init__(self, mode, idx, uniq_idx=None, inv=None):
        self.mode, self.idx, self.uniq_idx, self.inv = mode, idx, uniq_idx, inv


def _scatter_plan(starts: np.ndarray, w: int) -> _ScatterPlan:
    """Scatter plan for (B,) window starts of width w: 'direct' fancy +=
    when all windows distinct and disjoint, 'reduce' (pre-sum duplicates)
    when identical windows repeat, 'loop' when windows partially overlap."""
    idx = starts[:, None] + np.arange(w)[None, :]
    uniq, inv = np.unique(starts, return_inverse=True)
    if uniq.size > 1 and np.any(np.diff(uniq) < w):
        return _ScatterPlan("loop", idx)
    if uniq.size == starts.size:
        return _ScatterPlan("direct", idx)
    return _ScatterPlan(
        "reduce", idx, uniq[:, None] + np.arange(w)[None, :], inv
    )


def _scatter_add(tgt: np.ndarray, plan: _ScatterPlan, starts, w, Y):
    r = Y.shape[2]
    if plan.mode == "direct":
        tgt[plan.idx.reshape(-1)] += Y.reshape(-1, r)
    elif plan.mode == "reduce":
        acc = np.zeros((plan.uniq_idx.shape[0], w, r), dtype=Y.dtype)
        np.add.at(acc, plan.inv, Y)
        tgt[plan.uniq_idx.reshape(-1)] += acc.reshape(-1, r)
    else:
        for b, s in enumerate(starts):
            tgt[s : s + w] += Y[b]


class _HScale:
    __slots__ = ("w", "in_idx", "out_idx", "read_buf", "write_buf")

    def __init__(self, w, in_idx, out_idx, read_buf, write_buf):
        self.w, self.in_idx, self.out_idx = w, in_idx, out_idx
        self.read_buf, self.write_buf = read_buf, write_buf


class HostPlan:
    """Batched-einsum host apply of a LinOp; supports matmat and rmatmat."""

    def __init__(self, op: LinOp, block_align: int = 8, dtype=None):
        self.shape = op.shape
        self.dtype = np.dtype(dtype) if dtype is not None else np.dtype(
            np.complex128 if np.issubdtype(op.dtype, np.complexfloating)
            else np.float64
        )
        m, n = op.shape
        chains: list = []
        packed_mod._flatten(op, 0, 0, chains)
        num_stages = max(len(c.factors) for c in chains)

        buf_sizes = [n] + [0] * (num_stages - 1)
        chain_offsets: list[list[int]] = []
        for c in chains:
            offs = [c.j0]
            for t in range(1, len(c.factors)):
                offs.append(buf_sizes[t])
                buf_sizes[t] += c.factors[t].in_dim
            chain_offsets.append(offs)
        self.buf_sizes = buf_sizes
        self.out_size = m
        self.num_stages = num_stages

        gemm_groups: dict[tuple, list] = {}
        scale_groups: dict[tuple, list] = {}
        for c, offs in zip(chains, chain_offsets):
            last = len(c.factors) - 1
            for t, f in enumerate(c.factors):
                in_base = offs[t]
                wb = -1 if t == last else t + 1
                out_base = c.i0 if t == last else offs[t + 1]
                for u in f.gemms:
                    mm, kk = u.data.shape
                    key = (t, wb, packed_mod._round_up(mm, block_align),
                           packed_mod._round_up(kk, block_align))
                    gemm_groups.setdefault(key, []).append(
                        (u.data, in_base + u.in_off, out_base + u.out_off)
                    )
                for u in f.scales:
                    scale_groups.setdefault((t, wb), []).append(
                        (u.weights, in_base + u.in_idx, out_base + u.out_idx)
                    )

        tails: dict[int, int] = {}
        self._buckets: list[_HBucket] = []
        self._scales: list[_HScale] = []
        self._weight_bytes = 0
        for (t, wb, mp, kp), units in sorted(gemm_groups.items()):
            B = len(units)
            W = np.zeros((B, mp, kp), dtype=self.dtype)
            ins = np.zeros(B, dtype=np.int64)
            outs = np.zeros(B, dtype=np.int64)
            fl = 0
            for b, (data, jb, ib) in enumerate(units):
                mm, kk = data.shape
                W[b, :mm, :kk] = data
                ins[b], outs[b] = jb, ib
                fl += 2 * mm * kk
            tails[t] = max(tails.get(t, 0), kp)
            tails[wb] = max(tails.get(wb, 0), mp)
            self._weight_bytes += W.nbytes
            self._buckets.append(_HBucket(W, ins, outs, t, wb, fl))
        for (t, wb), units in sorted(scale_groups.items()):
            w = np.concatenate([np.asarray(u[0]) for u in units]).astype(self.dtype)
            iix = np.concatenate([np.asarray(u[1]) for u in units])
            oix = np.concatenate([np.asarray(u[2]) for u in units])
            self._scales.append(_HScale(w, iix, oix, t, wb))
        self._tails = tails

    def nbytes(self) -> int:
        return self._weight_bytes

    # -- forward ----------------------------------------------------------

    def _buffers(self, r: int):
        return [
            np.zeros((s + self._tails.get(t, 0), r), dtype=self.dtype)
            for t, s in enumerate(self.buf_sizes)
        ]

    def matmat(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X)
        was_vec = X.ndim == 1
        if was_vec:
            X = X[:, None]
        check(X.shape[0] == self.shape[1], "hostplan shape mismatch")
        r = X.shape[1]
        bufs = self._buffers(r)
        bufs[0][: self.shape[1]] = X
        out = np.zeros((self.out_size + self._tails.get(-1, 0), r),
                       dtype=self.dtype)
        for t in range(self.num_stages):
            for bk in self._buckets:
                if bk.read_buf != t:
                    continue
                G = bufs[t][bk.in_idx]  # (B, kp, r) fancy gather
                Y = np.einsum("bmk,bkr->bmr", bk.W, G)
                tgt = out if bk.write_buf == -1 else bufs[bk.write_buf]
                _scatter_add(tgt, bk.out_info, bk.out_start, bk.mp, Y)
            for sc in self._scales:
                if sc.read_buf != t:
                    continue
                vals = bufs[t][sc.in_idx] * sc.w[:, None]
                tgt = out if sc.write_buf == -1 else bufs[sc.write_buf]
                np.add.at(tgt, sc.out_idx, vals)
        y = out[: self.out_size]
        return y[:, 0] if was_vec else y

    # -- adjoint ----------------------------------------------------------

    def rmatmat(self, X: np.ndarray) -> np.ndarray:
        """A^H X via the reversed stage schedule."""
        X = np.asarray(X)
        was_vec = X.ndim == 1
        if was_vec:
            X = X[:, None]
        check(X.shape[0] == self.shape[0], "hostplan adjoint shape mismatch")
        r = X.shape[1]
        bufs = self._buffers(r)
        outb = np.zeros((self.out_size + self._tails.get(-1, 0), r),
                        dtype=self.dtype)
        outb[: self.out_size] = X
        result = np.zeros(
            (self.buf_sizes[0] + self._tails.get(0, 0), r), dtype=self.dtype
        )
        for t in range(self.num_stages - 1, -1, -1):
            for bk in self._buckets:
                if bk.read_buf != t:
                    continue
                src = outb if bk.write_buf == -1 else bufs[bk.write_buf]
                G = src[bk.out_info.idx]  # (B, mp, r) fancy gather
                Y = np.einsum("bkm,bkr->bmr", np.conj(bk.W), G)
                tgt = result if t == 0 else bufs[t]
                _scatter_add(tgt, bk.in_info, bk.in_start, bk.kp, Y)
            for sc in self._scales:
                if sc.read_buf != t:
                    continue
                src = outb if sc.write_buf == -1 else bufs[sc.write_buf]
                vals = src[sc.out_idx] * np.conj(sc.w)[:, None]
                tgt = result if t == 0 else bufs[t]
                np.add.at(tgt, sc.in_idx, vals)
        y = result[: self.shape[1]]
        return y[:, 0] if was_vec else y

    def matvec(self, x):
        return self.matmat(x)


def hostpack(op: LinOp, block_align: int = 8, dtype=None) -> HostPlan:
    return HostPlan(op, block_align=block_align, dtype=dtype)
