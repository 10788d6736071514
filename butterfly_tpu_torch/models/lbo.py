"""Streaming compression of Laplace-Beltrami eigenvector matrices.

Replacement for the reference's LBO pipeline (src/lbo.c +
examples/lbo/bf_lbo.c): eigenbands of the FEM-discretized LBO are computed
one frequency-interval-tree leaf at a time, row-permuted into the row tree's
order, attached to the deferred frequency tree, and fed to the streaming
factorizer — producing the "frequency-domain butterfly" compression of the
full eigenvector matrix Phi.

Call stack parity (SURVEY.md §3.3):
  compress_lbo_eigenfunctions
  ├─ Trimesh.lbo_fem                 <- bfTrimeshGetLboFemDiscretization
  ├─ get_max_eigenvalue              <- bfGetMaxEigenvalue
  ├─ IntervalTree (deferred)         <- bfIntervalTreeInitEmpty
  └─ per leaf: bracket -> eigenband -> permute -> attach -> feed
                                     <- bfLboFeedFacStreamerNextEigenband
                                        (src/lbo.c:70-150)

Port counterpart of `butterfly_tpu/models/lbo.py`, copied. The streaming
factorization is host float64 (`fac/streamer.py`), as in the JAX package;
`eigensolver="device"` computes the bands on the card
(`ops/device_eigs.DeviceEigSession`, float64), `"scipy"` on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from butterfly_tpu_torch.config import FacSpec
from butterfly_tpu_torch.fac.streamer import FacStreamer, PartialFac
from butterfly_tpu_torch.geom.trimesh import Trimesh
from butterfly_tpu_torch.ops.device_eigs import DeviceEigSession
from butterfly_tpu_torch.ops.linalg import get_eigenband, get_max_eigenvalue
from butterfly_tpu_torch.trees import IntervalTree, Octree, Tree
from butterfly_tpu_torch.trees.fiedler_tree import FiedlerTree
from butterfly_tpu_torch.utils.errors import InvalidArgumentsError, check
from butterfly_tpu_torch.utils.logging import log_info

__all__ = ["lbo_eigs_to_freqs", "LboCompression", "compress_lbo_eigenfunctions"]


def lbo_eigs_to_freqs(lam: np.ndarray) -> np.ndarray:
    """Eigenvalue -> frequency conversion omega = sqrt(lambda)
    (reference: bfLboEigsToFreqs, src/lbo.c:15-39)."""
    return np.sqrt(np.maximum(np.asarray(lam), 0.0))


def _bracket_from_node(node) -> tuple[float, float]:
    """Eigenvalue bracket of a frequency-tree leaf: [a^2, b^2), opened to
    +/-inf at the extreme leaves (reference: getBracketFromNode,
    src/lbo.c:41-68)."""
    lo = -np.inf if node.is_leftmost else node.a**2
    hi = np.inf if node.is_rightmost else node.b**2
    return lo, hi


@dataclasses.dataclass
class LboCompression:
    fac: PartialFac
    freqs: np.ndarray  # sorted frequencies (sqrt of eigenvalues)
    row_tree: Tree
    col_tree: IntervalTree
    dense_bytes: int

    @property
    def compressed_bytes(self) -> int:
        return self.fac.nbytes()

    @property
    def compression_rate(self) -> float:
        """(reference: compression-rate printout, examples/lbo/bf_lbo.c:343-348)"""
        return self.dense_bytes / max(self.compressed_bytes, 1)


def compress_lbo_eigenfunctions(
    mesh: Trimesh,
    tol: float = 1e-8,
    row_tree: Tree | None = None,
    col_tree_depth: int = 3,
    min_num_rows: int = 16,
    min_num_cols: int = 16,
    row_tree_init_depth: int = 1,
    use_fiedler_tree: bool = False,
    freq_margin: float = 1.001,
    eigensolver: str = "scipy",
    device=None,
) -> LboCompression:
    """Compute and butterfly-compress the full LBO eigenvector matrix.

    Returns the compressed factorization of Phi in ROW-TREE order and
    COLUMN-FREQUENCY order: Phi_compressed ~= Phi[row_perm][:, freq_order].

    eigensolver:
      "scipy"  — host ARPACK shift-invert bands (get_eigenband), the f64
                 certified path (reference: bfGetEigenband + UMFPACK,
                 src/linalg.c:748-1000).
      "device" — bands on `device` (default: the card;
                 ops/device_eigs.DeviceEigSession in float64): dense
                 generalized eigh for small meshes, constrained generalized
                 LOBPCG (no inner solves) at scale.
    """
    L, M = mesh.lbo_fem()
    n = mesh.num_verts

    if row_tree is None:
        row_tree = (
            FiedlerTree(mesh, leaf_size=max(16, n // 64))
            if use_fiedler_tree
            else Octree(mesh.verts, leaf_size=max(16, n // 64))
        )
    check(row_tree.num_points == n, "row tree must span the mesh vertices")

    lam_max = get_max_eigenvalue(L, M)
    freq_max = float(lbo_eigs_to_freqs(np.array([lam_max]))[0]) * freq_margin
    col_tree = IntervalTree(0.0, freq_max, arity=2, depth=col_tree_depth)

    spec = FacSpec(
        row_tree=row_tree,
        col_tree=col_tree,
        row_tree_init_depth=row_tree_init_depth,
        tol=tol,
        min_num_rows=min_num_rows,
        min_num_cols=min_num_cols,
    )
    streamer = FacStreamer(spec, auto_skip_empty_leaves=False)

    check(eigensolver in ("scipy", "device"),
          f"unknown eigensolver {eigensolver!r}", InvalidArgumentsError)
    session = None
    if eigensolver == "device":
        session = DeviceEigSession(L, M, device=device)

    freqs = np.empty(0)
    leaves = col_tree.nodes_at_depth(col_tree_depth)
    for leaf in leaves:
        lo, hi = _bracket_from_node(leaf)
        if session is not None:
            lam, Phi = session.next_band(lo, hi)
        else:
            lam, Phi = get_eigenband(
                L, M, lo, hi,
                method="doubling"
                if not np.isfinite(lo) or not np.isfinite(hi)
                else "covering",
            )
        band_freqs = lbo_eigs_to_freqs(lam)
        # permute eigenvectors into row-tree order
        # (reference: bfMatPermuteRows(Phi, revRowPerm), src/lbo.c:109)
        Phi_t = Phi[row_tree.perm]
        # attach the new frequencies WITHOUT rebuilding the tree
        # (reference: bfIntervalTreeSetPoints, src/lbo.c:127)
        freqs = np.concatenate([freqs, band_freqs])
        col_tree.set_points(freqs)
        log_info(
            "lbo band [%s, %s): %d eigenpairs (total %d)",
            f"{lo:.4g}", f"{hi:.4g}", len(lam), freqs.size,
        )
        streamer.feed(Phi_t)

    check(streamer.is_done(), "column tree not exhausted")
    fac = streamer.get_fac()
    dense_bytes = n * freqs.size * 8
    return LboCompression(
        fac=fac, freqs=freqs, row_tree=row_tree, col_tree=col_tree,
        dense_bytes=dense_bytes,
    )
