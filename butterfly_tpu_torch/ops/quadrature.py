"""Kapur-Rokhlin singular-quadrature corrections for BIEs.

Port counterpart of `butterfly_tpu/ops/quadrature.py`, copied (host
float64/complex128, NumPy). The trapezoid rule applied to a periodic
singular kernel is corrected near the diagonal with the classical
Kapur-Rokhlin weights (orders 2/6/10, the published values hard-coded
exactly as in the reference's src/quadrature.c:13-40). Corrections are
returned as sparse `Coo` operators that compose lazily with dense or
butterfly-factorized system matrices (reference behaviors:
bfQuadKrApplyCorrection src/quadrature.c:103, bfQuadKrApplyCorrectionTree
:174, block variants :202-269), or as a matrix-free `KrAccumCorrector`.

What the port adds: `KrAccumCorrector.apply` also takes a torch tensor in
the interleaved real embedding of the partition plan (row 2i = Re_i, row
2i+1 = Im_i) and stays on that tensor's device. Its (n, 2*order) tables
are copied there once as complex64, the tensor is viewed as complex, and
the apply gathers, multiplies and sums with torch ops: no host round trip
and no kernel (the JAX package's apply is host NumPy, not Pallas).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from butterfly_tpu_torch.ops.linop import Coo
from butterfly_tpu_torch.utils import profiling
from butterfly_tpu_torch.utils.errors import InvalidArgumentsError, check

__all__ = ["KR_WEIGHTS", "KrAccumCorrector", "kr_accum_correction",
           "kr_correction", "kr_block_correction"]

#: Kapur-Rokhlin correction weights (reference: src/quadrature.c:13-40;
#: originally Kapur & Rokhlin, SIAM J. Numer. Anal. 34 (1997)).
KR_WEIGHTS = {
    2: np.array([1.825748064736159, -1.325748064736159]),
    6: np.array(
        [
            4.967362978287758,
            -16.20501504859126,
            25.85153761832639,
            -22.22599466791883,
            9.930104998037539,
            -1.817995878141594,
        ]
    ),
    10: np.array(
        [
            7.832432020568779,
            -4.565161670374749,
            1.452168846354677,
            -2.901348302886379,
            3.870862162579900,
            -3.523821383570681,
            2.172421547519342,
            -8.707796087382991,
            2.053584266072635,
            -2.166984103403823,
        ]
    ),
}
# NOTE: the order-10 weights above are the reference's table verbatim; like
# the reference we trust its source. Order-6 is the standard published row.


def _block_entries(order: int, i0: int, i1: int, kernel, out_rows, out_cols,
                   out_vals) -> None:
    """KR entries for one periodic diagonal block [i0, i1)
    (reference: bf_get_KR_corr_block_spmat, src/quadrature.c:126-168)."""
    w = KR_WEIGHTS[order]
    m = i1 - i0
    for i in range(i0, i1):
        for p in range(order):
            j = ((i + p + 1 - i0) % m) + i0
            out_rows.append(i)
            out_cols.append(j)
            out_vals.append(w[p] * kernel(i, j))
            j = (((i + m) - p - 1 - i0) % m) + i0
            out_rows.append(i)
            out_cols.append(j)
            out_vals.append(w[p] * kernel(i, j))


def kr_correction(
    order: int,
    n: int,
    kernel: Callable[[int, int], complex],
    perm: np.ndarray | None = None,
) -> Coo:
    """Sparse KR correction for one closed periodic boundary of n points.

    kernel(i, j) evaluates the (unweighted) kernel between boundary points i
    and j in ORIGINAL ordering. If `perm` (tree order -> original index) is
    given, the correction is permuted into tree order for composition with a
    butterfly-factorized operator (reference: bfQuadKrApplyCorrectionTree,
    src/quadrature.c:174-199).
    """
    check(order in KR_WEIGHTS, "KR order must be 2, 6, or 10",
          InvalidArgumentsError)
    check(n >= 2 * order + 1, "too few points for this KR order",
          InvalidArgumentsError)
    rows: list[int] = []
    cols: list[int] = []
    vals: list[complex] = []
    _block_entries(order, 0, n, kernel, rows, cols, vals)
    corr = Coo((n, n), rows, cols, np.asarray(vals))
    if perm is not None:
        corr = corr.permuted(np.asarray(perm))
    return corr


class KrAccumCorrector:
    """Matrix-free (apply-side) KR correction — the analogue of the
    reference's accumulate variant `bfQuadKrAccumCorrection`
    (src/quadrature.c:51-73), which adds the correction's contribution
    directly into an output vector instead of materializing a sparse matrix.

    Each row has exactly `2*order` corrected neighbors, so the whole
    correction is a static (n, 2*order) coefficient table plus a same-shape
    gather-index table; `apply` is one gather-multiply-reduce (no scatter,
    batched over right-hand sides).
    """

    def __init__(self, coef: np.ndarray, idx: np.ndarray):
        self.coef = coef        # (n, 2*order) kernel-weighted coefficients
        self.idx = idx          # (n, 2*order) source indices
        self.shape = (coef.shape[0], coef.shape[0])
        self._device_tables: dict = {}

    def apply(self, x):
        """Correction-only contribution C_kr @ x.

        numpy x: complex (n,) or (n, r), on the host; the dtype follows the
        inputs. torch x: the interleaved real embedding, (2n,) or (2n, r),
        on any device; the result is the same float32 embedding on the
        same device, computed there in complex64. Traced as `kr.apply`
        (`utils.profiling`)."""
        with profiling.span("kr.apply"):
            if isinstance(x, torch.Tensor):
                return self._apply_interleaved(x)
            x = np.asarray(x)
            gathered = x[self.idx]                 # (n, 2p) or (n, 2p, r)
            coef = (self.coef if gathered.ndim == 2
                    else self.coef[:, :, None])
            return (coef * gathered).sum(axis=1)

    def _tables(self, device: torch.device):
        """The coefficient (complex64) and index tables on `device`, copied
        there on first use."""
        key = str(device)
        if key not in self._device_tables:
            self._device_tables[key] = (
                torch.as_tensor(self.coef, dtype=torch.complex64,
                                device=device),
                torch.as_tensor(self.idx, dtype=torch.int64, device=device))
        return self._device_tables[key]

    def _apply_interleaved(self, x: torch.Tensor) -> torch.Tensor:
        n = self.shape[0]
        check(x.ndim in (1, 2) and x.shape[0] == 2 * n,
              f"operand of shape {tuple(x.shape)}, expected ({2 * n},) or "
              f"({2 * n}, r) interleaved real", InvalidArgumentsError)
        check(not x.is_complex(), "pass the interleaved real embedding",
              InvalidArgumentsError)
        coef, idx = self._tables(x.device)
        x = x.to(torch.float32)
        if x.ndim == 1:
            z = torch.view_as_complex(x.reshape(n, 2).contiguous())
            y = (coef * z[idx]).sum(dim=1)                 # (n,)
            return torch.view_as_real(y).reshape(2 * n)
        r = x.shape[1]
        z = torch.view_as_complex(
            x.reshape(n, 2, r).transpose(1, 2).contiguous())  # (n, r)
        y = (coef[:, :, None] * z[idx]).sum(dim=1)            # (n, r)
        return torch.view_as_real(y).transpose(1, 2).reshape(2 * n, r)

    def wrap(self, apply_fn: Callable):
        """Compose with any apply callable: returns x -> apply_fn(x) +
        correction (the accumulate composition of the reference)."""
        return lambda x: apply_fn(x) + self.apply(x)

    def permuted(self, perm: np.ndarray) -> "KrAccumCorrector":
        """Symmetric re-index into tree order (perm: tree pos -> original
        index), matching Coo.permuted / bfMatPermuteRows on the explicit
        correction (src/quadrature.c:180-184)."""
        perm = np.asarray(perm)
        rev = np.empty(self.shape[0], dtype=np.int64)
        rev[perm] = np.arange(self.shape[0])
        return KrAccumCorrector(self.coef[perm], rev[self.idx[perm]])


def kr_accum_correction(
    order: int,
    n: int,
    kernel: Callable[[int, int], complex],
    offsets: Sequence[int] | None = None,
    perm: np.ndarray | None = None,
) -> KrAccumCorrector:
    """Build the matrix-free KR corrector for one closed boundary (or, with
    `offsets`, several stacked boundaries — the block variant). Numerically
    identical to the explicit `kr_correction`/`kr_block_correction` Coo."""
    check(order in KR_WEIGHTS, "KR order must be 2, 6, or 10",
          InvalidArgumentsError)
    if offsets is None:
        offsets = [0, n]
    offsets = list(offsets)
    check(len(offsets) >= 2
          and all(a < b for a, b in zip(offsets, offsets[1:])),
          "offsets must be sorted with at least two entries",
          InvalidArgumentsError)
    w = KR_WEIGHTS[order]
    coef = np.zeros((n, 2 * order), dtype=np.complex128)
    idx = np.zeros((n, 2 * order), dtype=np.int64)
    for i0, i1 in zip(offsets[:-1], offsets[1:]):
        m = i1 - i0
        check(m >= 2 * order + 1, "block too small for KR order",
              InvalidArgumentsError)
        for i in range(i0, i1):
            for p in range(order):
                j_hi = ((i + p + 1 - i0) % m) + i0
                j_lo = (((i + m) - p - 1 - i0) % m) + i0
                idx[i, 2 * p] = j_hi
                coef[i, 2 * p] = w[p] * kernel(i, j_hi)
                idx[i, 2 * p + 1] = j_lo
                coef[i, 2 * p + 1] = w[p] * kernel(i, j_lo)
    out = KrAccumCorrector(coef, idx)
    if perm is not None:
        out = out.permuted(np.asarray(perm))
    return out


def kr_block_correction(
    order: int,
    n: int,
    offsets: Sequence[int],
    kernel: Callable[[int, int], complex],
    perm: np.ndarray | None = None,
) -> Coo:
    """KR correction for multiple closed boundaries stacked in one index
    space; `offsets` are the boundary start/end indices
    (reference: bfQuadKrApplyBlockCorrection[Tree], src/quadrature.c:202-269).
    """
    offsets = list(offsets)
    check(len(offsets) >= 2
          and all(a < b for a, b in zip(offsets, offsets[1:])),
          "offsets must be sorted with at least two entries",
          InvalidArgumentsError)
    rows: list[int] = []
    cols: list[int] = []
    vals: list[complex] = []
    for i0, i1 in zip(offsets[:-1], offsets[1:]):
        check(i1 - i0 >= 2 * order + 1, "block too small for KR order",
              InvalidArgumentsError)
        _block_entries(order, i0, i1, kernel, rows, cols, vals)
    corr = Coo((n, n), rows, cols, np.asarray(vals))
    if perm is not None:
        corr = corr.permuted(np.asarray(perm))
    return corr
