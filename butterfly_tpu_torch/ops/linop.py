"""Host-side structured linear-operator algebra (the oracle layer).

Port counterpart of `butterfly_tpu/ops/linop.py`, copied so that the port
imports nothing of the JAX package. It keeps only the operators the
streaming factorizer, the distiller and `UniformButterfly.to_linop` use:

- Dense           <- mat_dense_real.c / mat_dense_complex.c
- Diag            <- mat_diag_real.c
- Identity / Zero <- mat_identity.c / mat_zero.c
- Product         <- mat_product.c
- FuncOp          <- mat_func.c / mat_python.c (matrix-free callback operator)
- BlockDiag       <- mat_block_diag.c
- BlockCoo        <- mat_block_coo.c
- BlockDense      <- mat_block_dense.c

The rest of the reference algebra (Perm, Givens, Sum, Diff, Scaled, Coo,
indexed blocks) waits for the slices that use it.

This layer runs on the host in float64/complex128 and is used for
(a) factorization-time math (truncated SVDs, least squares, merges) and
(b) as the dense ground truth every compressed operator is tested against —
the reference's own strongest validation pattern (SURVEY.md §4).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from butterfly_tpu_torch.utils.errors import (
    IncompatibleShapeError,
    InvalidArgumentsError,
    check,
)

__all__ = [
    "LinOp",
    "Dense",
    "Diag",
    "Identity",
    "Zero",
    "Product",
    "FuncOp",
    "BlockDiag",
    "BlockCoo",
    "BlockDense",
    "hpad",
    "row_slice",
]


def _as2d(x: np.ndarray) -> tuple[np.ndarray, bool]:
    """Promote a vector to a single-column matrix; report if we did."""
    x = np.asarray(x)
    if x.ndim == 1:
        return x[:, None], True
    if x.ndim == 2:
        return x, False
    raise InvalidArgumentsError(f"operand must be 1-D or 2-D, got ndim={x.ndim}")


class LinOp:
    """Abstract structured linear operator with NumPy semantics."""

    _shape: tuple[int, int]
    _dtype: np.dtype

    @property
    def shape(self) -> tuple[int, int]:
        return self._shape

    @property
    def dtype(self) -> np.dtype:
        return self._dtype

    # -- core interface -------------------------------------------------

    def _matmat(self, X: np.ndarray) -> np.ndarray:
        """Apply to a (n, r) matrix, returning (m, r)."""
        raise NotImplementedError

    def _rmatmat(self, X: np.ndarray) -> np.ndarray:
        """Apply the (conjugate) transpose to a (m, r) matrix -> (n, r).

        Default: materialize. Subclasses override when structure permits.
        """
        return np.conj(self.materialize()).T @ X

    def materialize(self) -> np.ndarray:
        """Dense representation (reference: bfMatToType/...Dense conversions)."""
        return self._matmat(np.eye(self.shape[1], dtype=self.dtype))

    def nbytes(self) -> int:
        """Compressed storage footprint (reference: bfMatNumBytes)."""
        raise NotImplementedError

    def transpose(self) -> "LinOp":
        return _Adjoint(self, conjugate=False)

    def adjoint(self) -> "LinOp":
        return _Adjoint(self, conjugate=True)

    @property
    def T(self) -> "LinOp":
        return self.transpose()

    @property
    def H(self) -> "LinOp":
        return self.adjoint()

    # -- user-facing application ----------------------------------------

    def matmat(self, X: np.ndarray) -> np.ndarray:
        X2, was_vec = _as2d(X)
        if X2.shape[0] != self.shape[1]:
            raise IncompatibleShapeError(
                f"operator shape {self.shape} incompatible with operand {X.shape}"
            )
        Y = self._matmat(X2)
        return Y[:, 0] if was_vec else Y

    def matvec(self, x: np.ndarray) -> np.ndarray:
        return self.matmat(x)

    def rmatmat(self, X: np.ndarray) -> np.ndarray:
        X2, was_vec = _as2d(X)
        if X2.shape[0] != self.shape[0]:
            raise IncompatibleShapeError(
                f"adjoint of {self.shape} incompatible with operand {X.shape}"
            )
        Y = self._rmatmat(X2)
        return Y[:, 0] if was_vec else Y

    def __call__(self, x: np.ndarray) -> np.ndarray:
        return self.matmat(x)

    # -- operator algebra ------------------------------------------------

    def __matmul__(self, other):
        if isinstance(other, LinOp):
            return Product([self, other])
        return self.matmat(np.asarray(other))

    # -- introspection ----------------------------------------------------

    def children(self) -> tuple["LinOp", ...]:
        """Direct sub-operators, for tree walks (planner, nbytes, dumps)."""
        return ()

    def __repr__(self) -> str:
        return f"{type(self).__name__}{self.shape}"


class _Adjoint(LinOp):
    """Lazy (conjugate-)transpose view of another operator."""

    def __init__(self, op: LinOp, conjugate: bool):
        self.op = op
        self.conjugate = conjugate
        m, n = op.shape
        self._shape = (n, m)
        self._dtype = op.dtype

    def _matmat(self, X):
        if self.conjugate:
            return self.op._rmatmat(X)
        return np.conj(self.op._rmatmat(np.conj(X)))

    def _rmatmat(self, X):
        if self.conjugate:
            return self.op._matmat(X)
        return np.conj(self.op._matmat(np.conj(X)))

    def materialize(self):
        A = self.op.materialize()
        return np.conj(A).T if self.conjugate else A.T

    def nbytes(self):
        return self.op.nbytes()

    def transpose(self):
        if not self.conjugate:
            return self.op
        return super().transpose()

    def adjoint(self):
        if self.conjugate:
            return self.op
        return super().adjoint()

    def children(self):
        return (self.op,)


class Dense(LinOp):
    """Dense matrix operator (reference: mat_dense_real.c / mat_dense_complex.c)."""

    def __init__(self, data: np.ndarray):
        data = np.asarray(data)
        check(data.ndim == 2, "Dense expects a 2-D array", InvalidArgumentsError)
        self.data = data
        self._shape = data.shape
        self._dtype = data.dtype

    def _matmat(self, X):
        return self.data @ X

    def _rmatmat(self, X):
        return np.conj(self.data).T @ X

    def materialize(self):
        return self.data

    def nbytes(self):
        return self.data.nbytes

    def transpose(self):
        return Dense(self.data.T)

    def adjoint(self):
        return Dense(np.conj(self.data).T)


class Diag(LinOp):
    """(Possibly rectangular) diagonal operator (reference: mat_diag_real.c)."""

    def __init__(self, diag: np.ndarray, shape: tuple[int, int] | None = None):
        diag = np.asarray(diag)
        check(diag.ndim == 1, "Diag expects a 1-D array", InvalidArgumentsError)
        if shape is None:
            shape = (diag.size, diag.size)
        check(min(shape) == diag.size, "diag length must equal min(shape)")
        self.diag = diag
        self._shape = shape
        self._dtype = diag.dtype

    def _matmat(self, X):
        m, n = self.shape
        Y = np.zeros((m, X.shape[1]), dtype=np.result_type(self.dtype, X.dtype))
        k = self.diag.size
        Y[:k] = self.diag[:, None] * X[:k]
        return Y

    def _rmatmat(self, X):
        m, n = self.shape
        Y = np.zeros((n, X.shape[1]), dtype=np.result_type(self.dtype, X.dtype))
        k = self.diag.size
        Y[:k] = np.conj(self.diag)[:, None] * X[:k]
        return Y

    def nbytes(self):
        return self.diag.nbytes

    def transpose(self):
        return Diag(self.diag, (self.shape[1], self.shape[0]))

    def adjoint(self):
        return Diag(np.conj(self.diag), (self.shape[1], self.shape[0]))


class Identity(LinOp):
    """Symbolic identity (reference: mat_identity.c). Free to store/apply."""

    def __init__(self, n: int, dtype=np.float64):
        self._shape = (n, n)
        self._dtype = np.dtype(dtype)

    def _matmat(self, X):
        return X

    def _rmatmat(self, X):
        return X

    def materialize(self):
        return np.eye(self.shape[0], dtype=self.dtype)

    def nbytes(self):
        return 0

    def transpose(self):
        return self

    def adjoint(self):
        return self


class Zero(LinOp):
    """Symbolic zero operator (reference: mat_zero.c)."""

    def __init__(self, shape: tuple[int, int], dtype=np.float64):
        self._shape = tuple(shape)
        self._dtype = np.dtype(dtype)

    def _matmat(self, X):
        return np.zeros((self.shape[0], X.shape[1]), np.result_type(self.dtype, X.dtype))

    def _rmatmat(self, X):
        return np.zeros((self.shape[1], X.shape[1]), np.result_type(self.dtype, X.dtype))

    def nbytes(self):
        return 0

    def transpose(self):
        return Zero((self.shape[1], self.shape[0]), self.dtype)

    adjoint = transpose

class Product(LinOp):
    """Lazy operator product; factors applied right-to-left
    (reference: mat_product.c; apply loop src/fac.c:133-146).

    `Product([A, B, C]).matvec(x) == A @ (B @ (C @ x))`. A butterfly
    factorization *is* one of these.
    """

    def __init__(self, factors: Sequence[LinOp]):
        factors = list(factors)
        check(len(factors) > 0, "Product needs at least one factor")
        for a, b in zip(factors[:-1], factors[1:]):
            if a.shape[1] != b.shape[0]:
                raise IncompatibleShapeError(
                    f"cannot chain {a.shape} @ {b.shape} in Product"
                )
        self.factors = factors
        self._shape = (factors[0].shape[0], factors[-1].shape[1])
        self._dtype = np.result_type(*[f.dtype for f in factors])

    def _matmat(self, X):
        for f in reversed(self.factors):
            X = f._matmat(X)
        return X

    def _rmatmat(self, X):
        for f in self.factors:
            X = f._rmatmat(X)
        return X

    def nbytes(self):
        return sum(f.nbytes() for f in self.factors)

    def transpose(self):
        return Product([f.transpose() for f in reversed(self.factors)])

    def adjoint(self):
        return Product([f.adjoint() for f in reversed(self.factors)])

    def children(self):
        return tuple(self.factors)


class FuncOp(LinOp):
    """Matrix-free operator from callables (reference: mat_func.c:5-26,
    mat_python.c — the extension hooks that let the FMM and Python operators
    participate in the algebra)."""

    def __init__(
        self,
        shape: tuple[int, int],
        matmat: Callable[[np.ndarray], np.ndarray],
        rmatmat: Callable[[np.ndarray], np.ndarray] | None = None,
        dtype=np.float64,
    ):
        self._shape = tuple(shape)
        self._dtype = np.dtype(dtype)
        self._matmat_fn = matmat
        self._rmatmat_fn = rmatmat

    def _matmat(self, X):
        return np.asarray(self._matmat_fn(X))

    def _rmatmat(self, X):
        if self._rmatmat_fn is None:
            raise NotImplementedError("FuncOp has no rmatmat callback")
        return np.asarray(self._rmatmat_fn(X))

    def nbytes(self):
        return 0


def _offsets_from_sizes(sizes: Sequence[int]) -> np.ndarray:
    """Running sum with leading 0 (reference: bfSizeRunningSum, src/util.c)."""
    out = np.zeros(len(sizes) + 1, dtype=np.int64)
    np.cumsum(sizes, out=out[1:])
    return out


class BlockDiag(LinOp):
    """Block-diagonal operator (reference: mat_block_diag.c).

    Holds the leaf Psi factors and diagonal W factors of butterfly
    factorizations (reference: src/fac_helm2.c:70,431).
    """

    def __init__(self, blocks: Sequence[LinOp]):
        blocks = list(blocks)
        check(len(blocks) > 0, "BlockDiag needs at least one block")
        self.blocks = blocks
        self.row_offsets = _offsets_from_sizes([b.shape[0] for b in blocks])
        self.col_offsets = _offsets_from_sizes([b.shape[1] for b in blocks])
        self._shape = (int(self.row_offsets[-1]), int(self.col_offsets[-1]))
        self._dtype = np.result_type(*[b.dtype for b in blocks])

    def _matmat(self, X):
        Y = np.zeros((self.shape[0], X.shape[1]), np.result_type(self.dtype, X.dtype))
        for k, b in enumerate(self.blocks):
            i0, i1 = self.row_offsets[k], self.row_offsets[k + 1]
            j0, j1 = self.col_offsets[k], self.col_offsets[k + 1]
            Y[i0:i1] = b._matmat(X[j0:j1])
        return Y

    def _rmatmat(self, X):
        Y = np.zeros((self.shape[1], X.shape[1]), np.result_type(self.dtype, X.dtype))
        for k, b in enumerate(self.blocks):
            i0, i1 = self.row_offsets[k], self.row_offsets[k + 1]
            j0, j1 = self.col_offsets[k], self.col_offsets[k + 1]
            Y[j0:j1] = b._rmatmat(X[i0:i1])
        return Y

    def nbytes(self):
        return sum(b.nbytes() for b in self.blocks)

    def transpose(self):
        return BlockDiag([b.transpose() for b in self.blocks])

    def adjoint(self):
        return BlockDiag([b.adjoint() for b in self.blocks])

    def children(self):
        return tuple(self.blocks)


class BlockCoo(LinOp):
    """Sparse block matrix in block-COO layout (reference: mat_block_coo.c).

    The "butterfly pattern" container: `blocks[k]` sits at block-row
    `row_inds[k]`, block-col `col_inds[k]` of a grid whose block-row/col
    extents are given by `row_offsets`/`col_offsets`.
    """

    def __init__(
        self,
        row_offsets: np.ndarray,
        col_offsets: np.ndarray,
        row_inds: Sequence[int],
        col_inds: Sequence[int],
        blocks: Sequence[LinOp],
    ):
        self.row_offsets = np.asarray(row_offsets, dtype=np.int64)
        self.col_offsets = np.asarray(col_offsets, dtype=np.int64)
        self.row_inds = np.asarray(row_inds, dtype=np.int64)
        self.col_inds = np.asarray(col_inds, dtype=np.int64)
        self.blocks = list(blocks)
        check(
            len(self.blocks) == self.row_inds.size == self.col_inds.size,
            "BlockCoo: blocks/row_inds/col_inds must have equal length",
        )
        for k, b in enumerate(self.blocks):
            i, j = self.row_inds[k], self.col_inds[k]
            m = self.row_offsets[i + 1] - self.row_offsets[i]
            n = self.col_offsets[j + 1] - self.col_offsets[j]
            if b.shape != (m, n):
                raise IncompatibleShapeError(
                    f"BlockCoo block {k} at ({i},{j}) has shape {b.shape}, "
                    f"expected {(int(m), int(n))}"
                )
        self._shape = (int(self.row_offsets[-1]), int(self.col_offsets[-1]))
        self._dtype = np.result_type(*[b.dtype for b in self.blocks])

    def _matmat(self, X):
        Y = np.zeros((self.shape[0], X.shape[1]), np.result_type(self.dtype, X.dtype))
        for k, b in enumerate(self.blocks):
            i, j = self.row_inds[k], self.col_inds[k]
            i0, i1 = self.row_offsets[i], self.row_offsets[i + 1]
            j0, j1 = self.col_offsets[j], self.col_offsets[j + 1]
            Y[i0:i1] += b._matmat(X[j0:j1])
        return Y

    def _rmatmat(self, X):
        Y = np.zeros((self.shape[1], X.shape[1]), np.result_type(self.dtype, X.dtype))
        for k, b in enumerate(self.blocks):
            i, j = self.row_inds[k], self.col_inds[k]
            i0, i1 = self.row_offsets[i], self.row_offsets[i + 1]
            j0, j1 = self.col_offsets[j], self.col_offsets[j + 1]
            Y[j0:j1] += b._rmatmat(X[i0:i1])
        return Y

    def nbytes(self):
        return (
            sum(b.nbytes() for b in self.blocks)
            + self.row_inds.nbytes
            + self.col_inds.nbytes
        )

    def transpose(self):
        return BlockCoo(
            self.col_offsets,
            self.row_offsets,
            self.col_inds,
            self.row_inds,
            [b.transpose() for b in self.blocks],
        )

    def adjoint(self):
        return BlockCoo(
            self.col_offsets,
            self.row_offsets,
            self.col_inds,
            self.row_inds,
            [b.adjoint() for b in self.blocks],
        )

    def children(self):
        return tuple(self.blocks)


class BlockDense(LinOp):
    """Dense grid of heterogeneous sub-operators (reference: mat_block_dense.c).

    The recursive container for multilevel factorizations: `grid[i][j]` is any
    LinOp; block-row i has uniform row count, block-col j uniform col count.
    """

    def __init__(self, grid: Sequence[Sequence[LinOp]]):
        check(len(grid) > 0 and len(grid[0]) > 0, "BlockDense needs a nonempty grid")
        self.grid = [list(row) for row in grid]
        ncols = len(self.grid[0])
        for row in self.grid:
            check(len(row) == ncols, "BlockDense rows must have equal length")
        row_sizes = [row[0].shape[0] for row in self.grid]
        col_sizes = [b.shape[1] for b in self.grid[0]]
        for i, row in enumerate(self.grid):
            for j, b in enumerate(row):
                if b.shape != (row_sizes[i], col_sizes[j]):
                    raise IncompatibleShapeError(
                        f"BlockDense block ({i},{j}) has shape {b.shape}, expected "
                        f"{(row_sizes[i], col_sizes[j])}"
                    )
        self.row_offsets = _offsets_from_sizes(row_sizes)
        self.col_offsets = _offsets_from_sizes(col_sizes)
        self._shape = (int(self.row_offsets[-1]), int(self.col_offsets[-1]))
        self._dtype = np.result_type(*[b.dtype for row in self.grid for b in row])

    @classmethod
    def from_row(cls, blocks: Sequence[LinOp]) -> "BlockDense":
        """Horizontal concat (reference: bfMatBlockDenseNewRowFromBlocks)."""
        return cls([list(blocks)])

    @classmethod
    def from_col(cls, blocks: Sequence[LinOp]) -> "BlockDense":
        """Vertical concat (reference: bfMatBlockDenseNewColFromBlocks)."""
        return cls([[b] for b in blocks])

    def _matmat(self, X):
        Y = np.zeros((self.shape[0], X.shape[1]), np.result_type(self.dtype, X.dtype))
        for i, row in enumerate(self.grid):
            i0, i1 = self.row_offsets[i], self.row_offsets[i + 1]
            for j, b in enumerate(row):
                j0, j1 = self.col_offsets[j], self.col_offsets[j + 1]
                Y[i0:i1] += b._matmat(X[j0:j1])
        return Y

    def _rmatmat(self, X):
        Y = np.zeros((self.shape[1], X.shape[1]), np.result_type(self.dtype, X.dtype))
        for i, row in enumerate(self.grid):
            i0, i1 = self.row_offsets[i], self.row_offsets[i + 1]
            for j, b in enumerate(row):
                j0, j1 = self.col_offsets[j], self.col_offsets[j + 1]
                Y[j0:j1] += b._rmatmat(X[i0:i1])
        return Y

    def nbytes(self):
        return sum(b.nbytes() for row in self.grid for b in row)

    def transpose(self):
        grid_t = [
            [self.grid[i][j].transpose() for i in range(len(self.grid))]
            for j in range(len(self.grid[0]))
        ]
        return BlockDense(grid_t)

    def adjoint(self):
        grid_t = [
            [self.grid[i][j].adjoint() for i in range(len(self.grid))]
            for j in range(len(self.grid[0]))
        ]
        return BlockDense(grid_t)

    def children(self):
        return tuple(b for row in self.grid for b in row)


def hpad(op: LinOp, left: int, right: int) -> LinOp:
    """Embed `op` in a wider operator with zero column blocks either side."""
    if left == 0 and right == 0:
        return op
    m = op.shape[0]
    row = []
    if left:
        row.append(Zero((m, left), op.dtype))
    row.append(op)
    if right:
        row.append(Zero((m, right), op.dtype))
    return BlockDense.from_row(row)


def row_slice(op: LinOp, i0: int, i1: int) -> LinOp:
    """Rows [i0, i1) of `op`, preserving structural sparsity where possible
    (reference: row-range views bfMatGetRowRange + the W-sparsity
    exploitation via GetNonzeroColumnRanges, src/fac.c:805-851).

    Identity/Diag slices become zero-padded small blocks; BlockDiag and
    column-stacked BlockDense slices select covered blocks and recurse into
    partially covered ones. Falls back to a dense row copy.
    """
    m, n = op.shape
    check(0 <= i0 <= i1 <= m, "row_slice out of range", InvalidArgumentsError)
    if i0 == 0 and i1 == m:
        return op
    if isinstance(op, Identity):
        return hpad(Identity(i1 - i0, op.dtype), i0, n - i1)
    if isinstance(op, Diag) and op.shape[0] == op.shape[1]:
        return hpad(Diag(op.diag[i0:i1]), i0, n - i1)
    if isinstance(op, Zero):
        return Zero((i1 - i0, n), op.dtype)
    if isinstance(op, BlockDiag):
        offs = op.row_offsets
        k0 = int(np.searchsorted(offs, i0, side="right") - 1)
        k1 = int(np.searchsorted(offs, i1, side="left"))
        parts = []
        for k in range(k0, k1):
            a = max(i0, int(offs[k])) - int(offs[k])
            b = min(i1, int(offs[k + 1])) - int(offs[k])
            parts.append(row_slice(op.blocks[k], a, b))
        body = BlockDiag(parts) if len(parts) > 1 else parts[0]
        left = int(op.col_offsets[k0])
        right = n - int(op.col_offsets[k1])
        return hpad(body, left, right)
    if isinstance(op, BlockDense) and len(op.grid[0]) == 1:
        # column stack: slice across the stacked blocks
        offs = op.row_offsets
        k0 = int(np.searchsorted(offs, i0, side="right") - 1)
        k1 = int(np.searchsorted(offs, i1, side="left"))
        parts = []
        for k in range(k0, k1):
            a = max(i0, int(offs[k])) - int(offs[k])
            b = min(i1, int(offs[k + 1])) - int(offs[k])
            parts.append(row_slice(op.grid[k][0], a, b))
        return BlockDense.from_col(parts) if len(parts) > 1 else parts[0]
    if isinstance(op, Dense):
        return Dense(op.data[i0:i1])
    return Dense(op.materialize()[i0:i1])
