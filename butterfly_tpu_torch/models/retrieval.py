"""Butterfly-compressed embedding retrieval, in PyTorch.

Port counterpart of `butterfly_tpu/models/retrieval.py`. An n x d
embedding table is stored as structured factors instead of dense rows:

    T  ~=  Psi @ V                      (one-level block-diagonal row basis;
                                         `CompressedTable`, tall tables)
    T  ~=  Psi . W0 . ... . W_{numW-1}  (multilevel streamed butterfly;
                                         `DeepTable`, wide structured tables)

For the one-level format Psi is a uniform block-diagonal (NB, s, rank)
factor from per-row-block truncated SVDs and V stacks the right factors;
rows are first permuted into tree order (`tree_order_rows`) so blocks
compress. The reference's analogue is the algebraic fac engine compressing
row blocks by truncated SVD (getPsiAndW, src/fac.c:717-777).

- `score(queries)`: scores = Psi @ (V @ q), two batched products in IEEE
  float32 (the TPU ran them at its default one-pass bf16 precision). The
  second product writes the scores query-major, (q, n), and `score`
  returns the (n, q) view of them: top-k then reads contiguous rows
  (`torch.topk` over a transposed view of row-major scores, or a
  transposing copy first, costs several times the top-k itself on the
  card).
- `lookup(ids)`: row gather INTO the factors + one (rank, d) matvec per id.
- `topk(queries, k)`: scoring + `torch.topk`. Always exact: the JAX
  package's `approx=True` takes the TPU's `approx_max_k`, which has no
  counterpart here (off the TPU it takes exact `lax.top_k` too).
- `train_step`: a functional distillation step through autograd.

The host NumPy parts (`compress_table`'s batched SVD, `tree_order_rows`,
`exact_topk`, the recall measures) are the JAX package's code, copied, so
both packages build identical factors and permutations. None of this
module's device work runs a hand-written kernel: it is plain batched
products, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from butterfly_tpu_torch.ops.butterfly import _f32_precision
from butterfly_tpu_torch.utils.device import resolve_device
from butterfly_tpu_torch.utils.errors import InvalidArgumentsError, check

__all__ = [
    "CompressedTable",
    "DeepTable",
    "compress_table",
    "compress_table_deep",
    "exact_topk",
    "recall_at_k",
    "recall_with_tolerance",
    "train_step",
    "tree_order_rows",
]


def _lookup(Psi: torch.Tensor, V: torch.Tensor,
            ids: torch.Tensor) -> torch.Tensor:
    s = Psi.shape[1]
    ids = ids.to(Psi.device)
    blk, pos = ids // s, ids % s
    with _f32_precision("highest"):
        return torch.einsum("mr,mrd->md", Psi[blk, pos], V[blk])


class CompressedTable(nn.Module):
    """Uniform blocked low-rank table: T[i] ~= Psi[blk(i), pos(i)] @ V[blk(i)].

    Psi: (NB, s, rank)  — per-block row basis (left factors, U*S from SVD)
    V:   (NB, rank, d)  — per-block right factors (V^T)
    """

    def __init__(self, Psi: torch.Tensor, V: torch.Tensor):
        super().__init__()
        check(Psi.ndim == 3 and V.ndim == 3, "bad factor ranks",
              InvalidArgumentsError)
        check(Psi.shape[0] == V.shape[0] and Psi.shape[2] == V.shape[1],
              "Psi/V shapes incompatible", InvalidArgumentsError)
        check(Psi.device == V.device, "Psi and V on different devices",
              InvalidArgumentsError)
        self.Psi = nn.Parameter(Psi)
        self.V = nn.Parameter(V)

    # properties ----------------------------------------------------------
    @property
    def num_rows(self) -> int:
        return self.Psi.shape[0] * self.Psi.shape[1]

    @property
    def dim(self) -> int:
        return self.V.shape[2]

    @property
    def rank(self) -> int:
        return self.Psi.shape[2]

    def nbytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in (self.Psi, self.V))

    # ops -----------------------------------------------------------------
    def _scores_qn(self, queries: torch.Tensor) -> torch.Tensor:
        """(q, n) scores, contiguous: the second product's batched output
        goes straight into its query-major slots (a strided `out=` that
        cuBLAS writes through its leading dimension), except where autograd
        needs the graph, which `out=` does not record."""
        NB, s, _ = self.Psi.shape
        q = queries.shape[0]
        with _f32_precision("highest"):
            mid = torch.einsum("brd,qd->brq", self.V,
                               queries.to(self.V.dtype)).to(self.Psi.dtype)
            if torch.is_grad_enabled() and (self.Psi.requires_grad
                                            or mid.requires_grad):
                out = torch.einsum("brq,bsr->qbs", mid, self.Psi)
            else:
                out = torch.empty((q, NB, s), dtype=self.Psi.dtype,
                                  device=self.Psi.device)
                torch.bmm(mid.transpose(1, 2), self.Psi.transpose(1, 2),
                          out=out.permute(1, 0, 2))
        return out.reshape(q, NB * s)

    def score(self, queries: torch.Tensor) -> torch.Tensor:
        """Scores of every row against every query: (n, q), the transposed
        view of query-major scores.

        queries: (q, d) on the table's device. Two batched products."""
        return self._scores_qn(queries).T

    def forward(self, queries: torch.Tensor) -> torch.Tensor:
        return self.score(queries)

    def lookup(self, ids: torch.Tensor) -> torch.Tensor:
        """Reconstruct embedding rows for `ids`: gather into the factors and
        apply the per-id block matvec (BASELINE: 'lookup is a gather into
        butterfly factors followed by fused block-matvec')."""
        return _lookup(self.Psi, self.V, ids)

    def topk(self, queries: torch.Tensor, k: int, approx: bool = False):
        """(values, indices) of the top-k rows per query: (q, k) each.
        `approx` is accepted for the JAX signature and ignored: the top-k
        is always exact."""
        return torch.topk(self._scores_qn(queries), k)

    def materialize(self) -> torch.Tensor:
        """Dense (n, d) table (oracle for tests)."""
        with _f32_precision("highest"):
            out = torch.bmm(self.Psi, self.V)
        return out.reshape(self.num_rows, self.dim)


def compress_table(
    table: np.ndarray,
    rank: int,
    block_rows: int = 128,
    dtype=torch.float32,
    svd_dtype=np.float64,
    device=None,
) -> CompressedTable:
    """Compress a dense (n, d) table by per-row-block truncated SVD with a
    UNIFORM rank (the reference's tol-adaptive getPsiAndW truncation,
    src/fac.c:680-714, made uniform), on the host, then put the factors on
    `device` (default: the card) as `dtype`.

    svd_dtype=np.float32 halves setup time at configs[1] scale (1M x 128)
    with negligible factor error for f32 output."""
    device = resolve_device(device)
    table = np.asarray(table)
    n, d = table.shape
    check(n % block_rows == 0, "n must be divisible by block_rows",
          InvalidArgumentsError)
    check(rank <= min(block_rows, d), "rank too large", InvalidArgumentsError)
    NB = n // block_rows
    blocks = table.reshape(NB, block_rows, d)
    # batched SVD on host (setup time)
    U, S, Vt = np.linalg.svd(blocks.astype(svd_dtype), full_matrices=False)
    Psi = (U[:, :, :rank] * S[:, None, :rank]).astype(np.float32)
    V = Vt[:, :rank, :].astype(np.float32)
    return CompressedTable(torch.from_numpy(Psi).to(device, dtype),
                           torch.from_numpy(V).to(device, dtype))


def tree_order_rows(
    table: np.ndarray,
    leaf_size: int = 256,
    max_depth: int = 24,
    seed: int = 0,
) -> np.ndarray:
    """Row permutation from recursive PCA bisection — the retrieval analogue
    of the reference's row-tree point permutation (the quadtree perm sift,
    src/quadtree_node.c:123-199): rows that are close in embedding space
    become close in tree order, so per-block truncated SVDs compress harder.

    Returns `perm` with table[perm] in tree order. O(n d log(n/leaf)) via
    power-iteration PCA per node; fine at 1M x 128 on the host.
    """
    table = np.asarray(table, dtype=np.float32)
    rng = np.random.default_rng(seed)
    n = table.shape[0]
    out: list[np.ndarray] = []
    stack: list[tuple[np.ndarray, int]] = [(np.arange(n), 0)]
    while stack:
        idx, depth = stack.pop()
        if depth >= max_depth or idx.size <= leaf_size:
            out.append(idx)
            continue
        # PCA direction from a row subsample (the split only needs the
        # dominant direction, not per-row precision)
        sub = idx if idx.size <= 8192 else rng.choice(idx, 8192, replace=False)
        Xs = table[sub]
        mu = Xs.mean(axis=0)
        Xc = Xs - mu
        v = rng.standard_normal(table.shape[1]).astype(np.float32)
        for _ in range(4):  # power iteration on the covariance
            v = Xc.T @ (Xc @ v)
            nv = np.linalg.norm(v)
            if nv == 0:
                break
            v /= nv
        s = (table[idx] - mu) @ v
        med = np.median(s)
        left, right = idx[s <= med], idx[s > med]
        if left.size == 0 or right.size == 0:  # degenerate: split by count
            half = idx.size // 2
            left, right = idx[:half], idx[half:]
        # LIFO stack: push right first so left comes out first
        stack.append((right, depth + 1))
        stack.append((left, depth + 1))
    return np.concatenate(out)


class DeepTable:
    """A table compressed into a genuine multilevel butterfly by the
    streaming factorizer, applied through its packed `StagePlan`.

    T ~= Psi . W0 . ... . W_{numW-1} (reference: the streamed row-tree
    compression, src/fac.c:717-777) — scoring T @ q^T is one packed
    device apply per query batch.

    Scope, as the JAX package measured it: this wins over the one-level
    `CompressedTable` for WIDE structured tables (d comparable to n) and
    for tables with highly variable per-block ranks; for tall smooth
    tables the hierarchy's transfer matrices cost more than they save.
    """

    def __init__(self, fac, plan, shape: tuple[int, int]):
        self.fac = fac  # PartialFac (host oracle)
        self.plan = plan  # StagePlan (device apply)
        self.shape = shape

    @property
    def num_rows(self) -> int:
        return self.shape[0]

    @property
    def dim(self) -> int:
        return self.shape[1]

    def nbytes(self) -> int:
        """Device-resident compressed size (padded plan weights)."""
        return self.plan.stats.weight_bytes

    def nbytes_logical(self) -> int:
        """Unpadded factor size (reference: bfFacGetNumBytes, src/fac.c:77)."""
        return self.fac.nbytes()

    def score(self, queries) -> torch.Tensor:
        """(q, d) queries (a tensor on the plan's device, or numpy) ->
        (n, q) scores, on the plan's device."""
        q = torch.as_tensor(queries).to(self.plan.device)
        return self.plan(q.T)

    def topk(self, queries, k: int, approx: bool = False):
        """Exact top-k, as `CompressedTable.topk`."""
        return torch.topk(self.score(queries).T, k)

    def materialize(self) -> np.ndarray:
        """Host oracle reconstruction."""
        return self.fac.as_linop().materialize()


def compress_table_deep(
    table: np.ndarray,
    tol: float = 1e-4,
    col_depth: int = 2,
    row_leaf: int = 128,
    min_block: int = 8,
    dtype=torch.float32,
    block_align: int | None = None,
    device=None,
) -> DeepTable:
    """Stream a table through the algebraic butterfly factorizer (host,
    float64) and pack the result for scoring on `device` (default: the
    card): bfFacStreamerFeed src/fac_streamer.c:386 -> merge/split
    src/fac.c:1080 -> `uniformize`."""
    from butterfly_tpu_torch.config import FacSpec
    from butterfly_tpu_torch.fac.streamer import FacStreamer
    from butterfly_tpu_torch.fac.uniformize import uniformize
    from butterfly_tpu_torch.trees import uniform_tree

    device = resolve_device(device)
    table = np.asarray(table, dtype=np.float64)
    n, d = table.shape
    row_depth = max(1, int(np.ceil(np.log2(max(n // row_leaf, 2)))))
    col_depth = max(1, min(col_depth, int(np.log2(max(d // min_block, 2)))))
    spec = FacSpec(
        row_tree=uniform_tree(n, 2, row_depth),
        col_tree=uniform_tree(d, 2, col_depth),
        row_tree_init_depth=min(4, row_depth),
        tol=tol,
        min_num_rows=min_block,
        min_num_cols=min_block,
    )
    streamer = FacStreamer(spec)
    for leaf in spec.col_tree.nodes_at_depth(col_depth):
        if leaf.num_points:
            streamer.feed(table[:, leaf.i0 : leaf.i1])
    fac = streamer.get_fac()
    plan = uniformize(fac, dtype=dtype, block_align=block_align,
                      device=device)
    return DeepTable(fac, plan, (n, d))


def exact_topk(table: np.ndarray, queries: np.ndarray, k: int) -> np.ndarray:
    """Host oracle: exact dense top-k indices (q, k)."""
    scores = queries @ table.T  # (q, n)
    return np.argsort(-scores, axis=1)[:, :k]


def recall_at_k(pred_idx: np.ndarray, true_idx: np.ndarray) -> float:
    """Mean fraction of true top-k recovered (strict set recall)."""
    hits = 0
    for p, t in zip(pred_idx, true_idx):
        hits += len(set(p.tolist()) & set(t.tolist()))
    return hits / true_idx.size


def recall_with_tolerance(
    pred_idx: np.ndarray,
    true_scores: np.ndarray,
    k: int,
    tol: float = 1e-3,
) -> float:
    """Tolerance recall@k: a predicted id counts as a hit if its TRUE score is
    within `tol * score_range` of the k-th best true score. This is the
    standard ANN-benchmark treatment of near-ties: strict set recall is
    ill-posed when many rows score within numerical noise of the cutoff.

    true_scores: (q, n) exact scores; pred_idx: (q, k) predicted ids.
    """
    q = true_scores.shape[0]
    hits = 0
    for i in range(q):
        s = true_scores[i]
        cutoff = np.partition(s, -k)[-k]
        eps = tol * (s.max() - s.min())
        hits += int(np.sum(s[pred_idx[i]] >= cutoff - eps))
    return hits / (q * k)


def train_step(ct: CompressedTable, rows: torch.Tensor, ids: torch.Tensor,
               lr: float = 1e-2) -> tuple[CompressedTable, torch.Tensor]:
    """One distillation step: fit the compressed factors to exact table rows
    (refines compression / supports downstream fine-tuning). Functional, as
    the JAX step: `ct` is left as it is. Returns (new_table, loss)."""
    Psi = ct.Psi.detach().requires_grad_(True)
    V = ct.V.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = torch.mean((_lookup(Psi, V, ids) - rows.to(Psi.device)) ** 2)
        gPsi, gV = torch.autograd.grad(loss, (Psi, V))
    return (CompressedTable(Psi.detach() - lr * gPsi, V.detach() - lr * gV),
            loss.detach())
