"""Host-side structured linear-operator algebra (the oracle layer).

Port counterpart of `butterfly_tpu/ops/linop.py`, copied so that the port
imports nothing of the JAX package. It keeps only the operators the
streaming factorizer, the distiller, `UniformButterfly.to_linop`, the
Helmholtz factorization and the packed planner use:

- Dense           <- mat_dense_real.c / mat_dense_complex.c
- Diag            <- mat_diag_real.c
- Identity / Zero <- mat_identity.c / mat_zero.c
- Perm            <- mat_perm.c
- Givens          <- mat_givens.c
- Product         <- mat_product.c
- Sum / Diff      <- mat_sum.c / mat_diff.c
- Scaled          <- bfMatScale
- FuncOp          <- mat_func.c / mat_python.c (matrix-free callback operator)
- BlockDiag       <- mat_block_diag.c
- BlockCoo        <- mat_block_coo.c
- BlockDense      <- mat_block_dense.c
- Coo             <- mat_coo_real.c / mat_coo_complex.c
- IndexedBlock, block_coo_from_indexed <- indexed_mat.c,
  bfMatBlockCooNewFromIndexedBlocks

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
    "Perm",
    "Givens",
    "Product",
    "Sum",
    "Diff",
    "Scaled",
    "FuncOp",
    "BlockDiag",
    "BlockCoo",
    "BlockDense",
    "Coo",
    "IndexedBlock",
    "aslinop",
    "block_coo_from_indexed",
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


class Perm(LinOp):
    """Permutation operator (reference: mat_perm.c, perm.c).

    `Perm(p).matvec(x)[i] == x[p[i]]` — i.e. row i of the permutation matrix
    has its 1 in column p[i]. The inverse permutation gives the adjoint
    (reference: bfPermGetReversePerm).
    """

    def __init__(self, perm: np.ndarray, dtype=np.float64):
        perm = np.asarray(perm)
        check(perm.ndim == 1, "Perm expects a 1-D index array", InvalidArgumentsError)
        self.perm = perm
        self._shape = (perm.size, perm.size)
        self._dtype = np.dtype(dtype)

    def _matmat(self, X):
        return X[self.perm]

    def _rmatmat(self, X):
        Y = np.empty_like(X)
        Y[self.perm] = X
        return Y

    def inverse(self) -> "Perm":
        inv = np.empty_like(self.perm)
        inv[self.perm] = np.arange(self.perm.size)
        return Perm(inv, self.dtype)

    def materialize(self):
        A = np.zeros(self.shape, dtype=self.dtype)
        A[np.arange(self.perm.size), self.perm] = 1
        return A

    def nbytes(self):
        return self.perm.nbytes

    def transpose(self):
        return self.inverse()

    adjoint = transpose


class Givens(LinOp):
    """Single Givens rotation in the (i, j) plane (reference: mat_givens.c:12-19).

    Used by GMRES's least-squares update. Acts as identity except on rows
    i and j:  y_i = c x_i + s x_j ;  y_j = -conj(s) x_i + c x_j.
    """

    def __init__(self, n: int, i: int, j: int, c, s):
        check(0 <= i < n and 0 <= j < n and i != j, "bad Givens indices")
        self.i, self.j, self.c, self.s = i, j, c, s
        self._shape = (n, n)
        self._dtype = np.result_type(type(c), type(s), np.float64)

    def _matmat(self, X):
        Y = X.astype(np.result_type(self.dtype, X.dtype), copy=True)
        xi, xj = X[self.i], X[self.j]
        Y[self.i] = self.c * xi + self.s * xj
        Y[self.j] = -np.conj(self.s) * xi + self.c * xj
        return Y

    def _rmatmat(self, X):
        Y = X.astype(np.result_type(self.dtype, X.dtype), copy=True)
        xi, xj = X[self.i], X[self.j]
        Y[self.i] = np.conj(self.c) * xi - self.s * xj
        Y[self.j] = np.conj(self.s) * xi + np.conj(self.c) * xj
        return Y

    def nbytes(self):
        return 32


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


class Sum(LinOp):
    """Lazy sum of conforming operators (reference: mat_sum.c)."""

    def __init__(self, terms: Sequence[LinOp]):
        terms = list(terms)
        check(len(terms) > 0, "Sum needs at least one term")
        shape = terms[0].shape
        for t in terms[1:]:
            if t.shape != shape:
                raise IncompatibleShapeError("Sum terms must have equal shapes")
        self.terms = terms
        self._shape = shape
        self._dtype = np.result_type(*[t.dtype for t in terms])

    def _matmat(self, X):
        Y = self.terms[0]._matmat(X)
        for t in self.terms[1:]:
            Y = Y + t._matmat(X)
        return Y

    def _rmatmat(self, X):
        Y = self.terms[0]._rmatmat(X)
        for t in self.terms[1:]:
            Y = Y + t._rmatmat(X)
        return Y

    def nbytes(self):
        return sum(t.nbytes() for t in self.terms)

    def transpose(self):
        return Sum([t.transpose() for t in self.terms])

    def adjoint(self):
        return Sum([t.adjoint() for t in self.terms])

    def children(self):
        return tuple(self.terms)


class Diff(LinOp):
    """Lazy difference A - B (reference: mat_diff.c). This is the Schur
    complement node in the fast direct solver
    (reference: examples/fast_direct_solver/fast_direct_solver.py:702)."""

    def __init__(self, a: LinOp, b: LinOp):
        if a.shape != b.shape:
            raise IncompatibleShapeError("Diff operands must have equal shapes")
        self.a, self.b = a, b
        self._shape = a.shape
        self._dtype = np.result_type(a.dtype, b.dtype)

    def _matmat(self, X):
        return self.a._matmat(X) - self.b._matmat(X)

    def _rmatmat(self, X):
        return self.a._rmatmat(X) - self.b._rmatmat(X)

    def nbytes(self):
        return self.a.nbytes() + self.b.nbytes()

    def transpose(self):
        return Diff(self.a.transpose(), self.b.transpose())

    def adjoint(self):
        return Diff(self.a.adjoint(), self.b.adjoint())

    def children(self):
        return (self.a, self.b)


class Scaled(LinOp):
    """alpha * A (reference: bfMatScale)."""

    def __init__(self, alpha, op: LinOp):
        self.alpha = alpha
        self.op = op
        self._shape = op.shape
        self._dtype = np.result_type(type(alpha), op.dtype)

    def _matmat(self, X):
        return self.alpha * self.op._matmat(X)

    def _rmatmat(self, X):
        return np.conj(self.alpha) * self.op._rmatmat(X)

    def nbytes(self):
        return self.op.nbytes() + 16

    def transpose(self):
        return Scaled(self.alpha, self.op.transpose())

    def adjoint(self):
        return Scaled(np.conj(self.alpha), self.op.adjoint())

    def children(self):
        return (self.op,)


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


class Coo(LinOp):
    """Element-sparse COO operator (reference: mat_coo_real.c /
    mat_coo_complex.c). Used for quadrature corrections added on top of
    factorized operators."""

    def __init__(self, shape: tuple[int, int], row_inds, col_inds, values):
        self.row_inds = np.asarray(row_inds, dtype=np.int64)
        self.col_inds = np.asarray(col_inds, dtype=np.int64)
        self.values = np.asarray(values)
        check(
            self.row_inds.shape == self.col_inds.shape == self.values.shape,
            "Coo: inds/values must have equal length",
        )
        self._shape = tuple(shape)
        self._dtype = self.values.dtype

    def _matmat(self, X):
        Y = np.zeros((self.shape[0], X.shape[1]),
                     np.result_type(self.dtype, X.dtype))
        np.add.at(Y, self.row_inds, self.values[:, None] * X[self.col_inds])
        return Y

    def _rmatmat(self, X):
        Y = np.zeros((self.shape[1], X.shape[1]),
                     np.result_type(self.dtype, X.dtype))
        np.add.at(Y, self.col_inds,
                  np.conj(self.values)[:, None] * X[self.row_inds])
        return Y

    def materialize(self):
        A = np.zeros(self.shape, dtype=self.dtype)
        np.add.at(A, (self.row_inds, self.col_inds), self.values)
        return A

    def nbytes(self):
        return (self.values.nbytes + self.row_inds.nbytes
                + self.col_inds.nbytes)

    def transpose(self):
        return Coo((self.shape[1], self.shape[0]), self.col_inds,
                   self.row_inds, self.values)

    def adjoint(self):
        return Coo((self.shape[1], self.shape[0]), self.col_inds,
                   self.row_inds, np.conj(self.values))

    def permuted(self, perm: np.ndarray) -> "Coo":
        """Apply a symmetric row/col permutation: entry (i, j) moves to
        (p^-1(i), p^-1(j)) where perm maps tree position -> original index
        (reference: bfMatPermuteRows/Cols on the correction,
        src/quadrature.c:180-184)."""
        rev = np.empty(self.shape[0], dtype=np.int64)
        rev[perm] = np.arange(self.shape[0])
        return Coo(self.shape, rev[self.row_inds], rev[self.col_inds],
                   self.values)


class IndexedBlock:
    """A positioned block {i0, j0, op} (reference: indexed_mat.c,
    include/bf/types.h:7-12)."""

    __slots__ = ("i0", "j0", "op")

    def __init__(self, i0: int, j0: int, op: LinOp):
        self.i0, self.j0, self.op = int(i0), int(j0), op

    def __repr__(self):
        return f"IndexedBlock(i0={self.i0}, j0={self.j0}, op={self.op!r})"


def block_coo_from_indexed(
    shape: tuple[int, int], indexed: Sequence[IndexedBlock]
) -> BlockCoo:
    """Assemble a BlockCoo from positioned blocks
    (reference: bfMatBlockCooNewFromIndexedBlocks, src/fac.c:835).

    Block row/col boundaries are derived from the distinct i0/j0 extents;
    every block must align with that grid (no block is split).
    """
    check(len(indexed) > 0, "need at least one indexed block")
    row_edges = sorted({ib.i0 for ib in indexed}
                       | {ib.i0 + ib.op.shape[0] for ib in indexed}
                       | {0, shape[0]})
    col_edges = sorted({ib.j0 for ib in indexed}
                       | {ib.j0 + ib.op.shape[1] for ib in indexed}
                       | {0, shape[1]})
    row_offsets = np.asarray(row_edges, dtype=np.int64)
    col_offsets = np.asarray(col_edges, dtype=np.int64)
    row_lookup = {int(v): i for i, v in enumerate(row_offsets[:-1])}
    col_lookup = {int(v): j for j, v in enumerate(col_offsets[:-1])}
    row_inds, col_inds, blocks = [], [], []
    for ib in indexed:
        i = row_lookup[ib.i0]
        j = col_lookup[ib.j0]
        check(
            int(row_offsets[i + 1] - row_offsets[i]) == ib.op.shape[0]
            and int(col_offsets[j + 1] - col_offsets[j]) == ib.op.shape[1],
            "indexed block does not align with derived block grid",
        )
        row_inds.append(i)
        col_inds.append(j)
        blocks.append(ib.op)
    return BlockCoo(row_offsets, col_offsets, row_inds, col_inds, blocks)


def aslinop(x) -> LinOp:
    """Coerce an array or LinOp to a LinOp."""
    if isinstance(x, LinOp):
        return x
    return Dense(np.asarray(x))


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
