"""Truncated SVD utilities.

Replacement for the reference's LAPACK-based truncated SVD
(bfGetTruncatedSvd src/linalg.c:1002-1082, truncation rule
bfTruncSpecGetNumTerms src/linalg.c:26-35): keep singular values
sigma_k >= tol * sigma_0. Host path is f64 numpy (factorization-time
accuracy); a batched device path serves uniform-block compression.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as sla

from butterfly_tpu_torch.utils.logging import log_info

__all__ = ["truncated_svd", "svd_rank"]


def svd_rank(s: np.ndarray, tol: float) -> int:
    """Number of terms kept: sigma_k >= tol * sigma_0
    (reference: bfTruncSpecGetNumTerms, src/linalg.c:26-35)."""
    if s.size == 0 or s[0] == 0:
        return 0
    return int(np.sum(s >= tol * s[0]))


def truncated_svd(A: np.ndarray, tol: float):
    """(U, s, Vt, truncated): the rank-r factors with r chosen by `tol`.

    `truncated` mirrors the reference's success flag — True iff terms were
    actually dropped (r < min(m, n)), which is what the epsilon-rank-cut
    descent keys on (src/fac.c:977-983).

    The SVD is LAPACK's divide and conquer (gesdd), as numpy's. Where
    gesdd does not converge, which it did on a core of the streamed LBO
    eigenvector table of icosphere(5), it is computed again by QR
    iteration (gesvd), which raises in turn if it fails.
    """
    A = np.asarray(A)
    try:
        U, s, Vt = np.linalg.svd(A, full_matrices=False)
    except np.linalg.LinAlgError:
        log_info("truncated_svd: gesdd did not converge on a %s matrix; "
                 "using gesvd", A.shape)
        U, s, Vt = sla.svd(A, full_matrices=False, lapack_driver="gesvd")
    r = svd_rank(s, tol)
    r = max(r, 1) if min(A.shape) > 0 else 0
    truncated = r < min(A.shape)
    return U[:, :r], s[:r], Vt[:r], truncated
