"""Iterative solvers: restarted GMRES on the host and on the device.

Port counterpart of `butterfly_tpu/ops/linalg.py:47-449` (reference:
bfSolveGMRES, src/linalg.c:47-317):

- `solve_gmres`         host GMRES, numpy: modified Gram-Schmidt, Givens
                        least squares, multi-RHS, GMRES(m) restarts. A plain
                        copy of the JAX package's.
- `solve_gmres_device`  the whole restart cycle on the device: CGS2 against
                        the basis, the rotations applied in order, a
                        fixed-length back substitution. The JAX package runs
                        it in one `lax.while_loop`; here a Python loop over
                        cycles reads the residual to the host once a cycle.
- `solve_gmres_plan`    the Krylov basis on the device, the Givens
                        recurrence on the host in float64 (complex128 for a
                        complex system); one Hessenberg column comes to the
                        host per iteration; on a card, CGS2 and the
                        column are one CUDA graph replay. The operator
                        may be any Python callable on device tensors, e.g.
                        a `PartitionPlan.apply`: this is the large-N Helmholtz
                        BIE solve (`examples/helm2_scale.py`). The JAX
                        drivers are real-only (its TPU backend has no
                        complex); this one takes a complex right-hand side
                        and runs a complex basis, which needs about half the
                        iterations of the interleaved real embedding.

Every product with the basis runs in IEEE float32 (no TF32, see
`ops/butterfly.py::_f32_precision`): a TF32 basis cannot reach the 3e-7
tolerance of the BIE solve. These are plain matrix-vector products, which
the JAX package also computes outside any Pallas kernel.

A tensor right-hand side keeps its device; a numpy one goes to `device`
(default: the card).

The host eigensolvers of the JAX module (`butterfly_tpu/ops/linalg.py:457-625`)
are copied as they are: `get_max_eigenvalue`, `get_shifted_eigs` and
`get_eigenband` (doubling and covering), scipy ARPACK with shift-invert.
Their device counterpart is `ops/device_eigs.py`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from butterfly_tpu_torch.ops.butterfly import _f32_precision
from butterfly_tpu_torch.utils import profiling
from butterfly_tpu_torch.utils.device import resolve_device
from butterfly_tpu_torch.utils.errors import InvalidArgumentsError, check
from butterfly_tpu_torch.utils.logging import log_debug

__all__ = [
    "GmresResult",
    "get_eigenband",
    "get_max_eigenvalue",
    "get_shifted_eigs",
    "solve_gmres",
    "solve_gmres_device",
    "solve_gmres_plan",
]


@dataclasses.dataclass
class GmresResult:
    x: np.ndarray
    num_iter: int
    residuals: list[float]
    converged: bool


def _as_matop(A) -> Callable[[np.ndarray], np.ndarray]:
    """(n, k) -> (m, k) apply for arrays, LinOps, plans, or callables.

    Plain callables keep their historical PER-VECTOR contract (they are
    applied column by column); pass an object with `.matmat` (LinOp,
    StagePlan, ndarray) to get genuinely batched multi-RHS applies."""
    if hasattr(A, "matmat"):
        return lambda V: np.asarray(A.matmat(V))
    if callable(A) and not hasattr(A, "matvec"):
        def apply(V):
            cols = [np.asarray(A(V[:, j])) for j in range(V.shape[1])]
            return np.stack(cols, axis=1)

        return apply
    if hasattr(A, "matvec"):
        def apply_mv(V):
            cols = [np.asarray(A.matvec(V[:, j])) for j in range(V.shape[1])]
            return np.stack(cols, axis=1)

        return apply_mv
    return lambda V: np.asarray(A @ V)


def _gmres_cycle(matop, prec, X, B, m, tol, bnorm):
    """One batched restart cycle of length m on all RHS columns.

    Returns (X_new, residual_history, converged_mask). Batched over the k
    columns: V (m+1, n, k), H (m+1, m, k); converged columns keep iterating
    harmlessly behind division guards."""
    n, k = B.shape
    R = prec(B - matop(X))
    beta = np.linalg.norm(R, axis=0)  # (k,)
    dtype = np.result_type(B.dtype, R.dtype, np.float64)
    V = np.zeros((m + 1, n, k), dtype=dtype)
    H = np.zeros((m + 1, m, k), dtype=dtype)
    cs = np.zeros((m, k), dtype=dtype)
    sn = np.zeros((m, k), dtype=dtype)
    g = np.zeros((m + 1, k), dtype=dtype)
    safe_beta = np.where(beta > 0, beta, 1.0)
    V[0] = R / safe_beta
    g[0] = beta
    history = [np.abs(beta) / bnorm]
    j_used = 0
    for j in range(m):
        W = prec(matop(V[j]))
        # batched modified Gram-Schmidt (reference: src/linalg.c:154-193)
        for i in range(j + 1):
            hij = np.einsum("nk,nk->k", np.conj(V[i]), W)
            H[i, j] = hij
            W = W - hij[None, :] * V[i]
        h = np.linalg.norm(W, axis=0)
        H[j + 1, j] = h
        V[j + 1] = np.where(h > 0, W / np.where(h > 0, h, 1.0), 0.0)
        # accumulated Givens rotations on the new column
        for i in range(j):
            t = cs[i] * H[i, j] + sn[i] * H[i + 1, j]
            H[i + 1, j] = -np.conj(sn[i]) * H[i, j] + cs[i] * H[i + 1, j]
            H[i, j] = t
        a, bb = H[j, j], H[j + 1, j]
        denom = np.sqrt(np.abs(a) ** 2 + np.abs(bb) ** 2)
        safe_d = np.where(denom > 0, denom, 1.0)
        phase = np.where(np.abs(a) > 0,
                         a / np.where(np.abs(a) > 0, np.abs(a), 1.0), 1.0)
        cs[j] = np.where(denom > 0, np.abs(a) / safe_d, 1.0)
        sn[j] = np.where(denom > 0, phase * np.conj(bb) / safe_d, 0.0)
        H[j, j] = cs[j] * H[j, j] + sn[j] * H[j + 1, j]
        H[j + 1, j] = 0.0
        g[j + 1] = -np.conj(sn[j]) * g[j]
        g[j] = cs[j] * g[j]
        res = np.abs(g[j + 1]) / bnorm
        history.append(res)
        j_used = j + 1
        if np.all(res < tol):
            break
    # batched back substitution
    j = j_used
    y = np.zeros((j, k), dtype=dtype)
    for i in range(j - 1, -1, -1):
        num = g[i] - np.einsum("mk,mk->k", H[i, i + 1 : j], y[i + 1 :])
        y[i] = num / np.where(np.abs(H[i, i]) > 0, H[i, i], 1.0)
    X = X + np.einsum("mnk,mk->nk", V[:j], y)
    return X, history, history[-1] < tol


def solve_gmres(
    A,
    b: np.ndarray,
    tol: float = 1e-10,
    max_iter: int | None = None,
    M=None,
    x0: np.ndarray | None = None,
    restart: int | None = None,
) -> GmresResult:
    """Left-preconditioned restarted GMRES with modified Gram-Schmidt +
    Givens least-squares, MULTI-RHS (reference: bfSolveGMRES,
    src/linalg.c:47-317). All RHS columns iterate together as batched
    vector ops — one matop per iteration regardless of k.

    A and M may be LinOps, packed plans, arrays, or callables. b may be
    (n,) or (n, k). `restart` enables GMRES(m) cycles (default: one full
    cycle of max_iter steps, the reference's behavior).
    """
    matop = _as_matop(A)
    prec = _as_matop(M) if M is not None else (lambda V: V)
    b = np.asarray(b)
    was_vec = b.ndim == 1
    B = b[:, None] if was_vec else b
    check(B.ndim == 2, "b must be (n,) or (n, k)", InvalidArgumentsError)
    n, k = B.shape
    if max_iter is None:
        max_iter = min(n, 256)
    m = restart if restart is not None else max_iter

    X = np.zeros_like(B) if x0 is None else (
        x0[:, None] if x0.ndim == 1 else x0
    ).astype(B.dtype, copy=True)
    bnorm = np.linalg.norm(prec(B), axis=0)
    if np.all(bnorm == 0):
        x = X[:, 0] if was_vec else X
        return GmresResult(x, 0, [0.0], True)
    bnorm = np.where(bnorm > 0, bnorm, 1.0)

    residuals: list[float] = []
    total = 0
    converged = np.zeros(k, dtype=bool)
    while total < max_iter:
        steps = min(m, max_iter - total)
        X, hist, converged = _gmres_cycle(matop, prec, X, B, steps, tol, bnorm)
        residuals.extend(float(np.max(h)) for h in hist[1:])
        total += len(hist) - 1
        if np.all(converged):
            break
    log_debug("gmres: %d iters (k=%d rhs), final rel res %.3e",
              total, k, residuals[-1] if residuals else 0.0)
    x = X[:, 0] if was_vec else X
    return GmresResult(x, total, residuals or [0.0], bool(np.all(converged)))


def _on_device(b, device, complex_ok: bool = False) -> torch.Tensor:
    """`b` as a tensor: a tensor keeps its device, numpy goes to `device`
    (default: the card). Complex only where `complex_ok`."""
    if not isinstance(b, torch.Tensor):
        b = torch.as_tensor(np.asarray(b)).to(resolve_device(device))
    check(complex_ok or not b.is_complex(), "real dtypes only: run a "
          "complex system through `solve_gmres_plan` or its 2x2 real "
          "embedding", InvalidArgumentsError)
    return b


def _as_device_op(A, like: torch.Tensor):
    """A callable stays; a matrix (tensor or numpy) becomes `A @ V` on the
    right-hand side's device and dtype."""
    if callable(A):
        return A
    At = torch.as_tensor(A).to(device=like.device, dtype=like.dtype)
    return lambda V: At @ V


def solve_gmres_device(
    matvec,
    b,
    tol: float = 1e-6,
    restart: int = 32,
    max_cycles: int = 8,
    M=None,
    device=None,
):
    """Device-resident restarted GMRES: the Krylov basis, the Givens
    recurrence and the back substitution stay on b's device; the host reads
    one residual per restart cycle.

    Real dtypes only: nothing on the card path calls it with a complex
    system (`solve_gmres_plan` takes one; Helmholtz can also run through
    the 2x2 real-embedded stacked system, `StagePlan.apply_stacked`).
    matvec/M: (n, k) -> (n, k)
    callables on device tensors, or matrices. Every cycle runs all
    `restart` steps. Returns (x, total_iters, rel_res): x a tensor on b's
    device, total_iters = cycles * restart, rel_res the largest column's
    Givens residual estimate after the last cycle.
    """
    B = _on_device(b, device)
    was_vec = B.ndim == 1
    if was_vec:
        B = B[:, None]
    check(B.ndim == 2, "b must be (n,) or (n, k)", InvalidArgumentsError)
    apply_a = _as_device_op(matvec, B)
    apply_m = _as_device_op(M, B) if M is not None else (lambda V: V)
    n, k = B.shape
    m = int(restart)

    def nonzero(v):
        return torch.where(v > 0, v, torch.ones_like(v))

    bnorm = nonzero(torch.linalg.vector_norm(B, dim=0))

    def cycle(X):
        R = apply_m(B - apply_a(X))
        beta = torch.linalg.vector_norm(R, dim=0)
        V = B.new_zeros((m + 1, n, k))
        V[0] = R / nonzero(beta)
        H = B.new_zeros((m + 1, m, k))
        cs = B.new_zeros((m, k))
        sn = B.new_zeros((m, k))
        g = B.new_zeros((m + 1, k))
        g[0] = beta
        for j in range(m):
            W = apply_m(apply_a(V[j]))
            # classical Gram-Schmidt with one reorthogonalization pass
            # against V[0..j] (the JAX package's fixed-shape CGS2)
            Vj = V[: j + 1]
            proj = torch.einsum("ink,nk->ik", Vj, W)
            W = W - torch.einsum("ink,ik->nk", Vj, proj)
            proj2 = torch.einsum("ink,nk->ik", Vj, W)
            W = W - torch.einsum("ink,ik->nk", Vj, proj2)
            hcol = B.new_zeros((m + 1, k))
            hcol[: j + 1] = proj + proj2
            h = torch.linalg.vector_norm(W, dim=0)
            V[j + 1] = torch.where(h > 0, W / nonzero(h), 0.0)
            hcol[j + 1] = h
            # the accumulated rotations, in order
            for i in range(j):
                t = cs[i] * hcol[i] + sn[i] * hcol[i + 1]
                hcol[i + 1] = -sn[i] * hcol[i] + cs[i] * hcol[i + 1]
                hcol[i] = t
            a, bb = hcol[j].clone(), hcol[j + 1].clone()
            denom = torch.sqrt(a ** 2 + bb ** 2)
            cj = torch.where(denom > 0, a.abs() / nonzero(denom), 1.0)
            sj = torch.where(denom > 0, torch.sign(a) * bb / nonzero(denom),
                             0.0)
            hcol[j] = cj * a + sj * bb
            hcol[j + 1] = 0.0
            cs[j] = cj
            sn[j] = sj
            g[j + 1] = -sj * g[j]
            g[j] = cj * g[j]
            H[:, j] = hcol
        # back substitution over all m steps
        y = B.new_zeros((m, k))
        for i in range(m - 1, -1, -1):
            num = g[i] - (H[i] * y).sum(dim=0)
            hii = H[i, i]
            y[i] = num / torch.where(hii.abs() > 0, hii, torch.ones_like(hii))
        Xn = X + torch.einsum("mnk,mk->nk", V[:m], y)
        return Xn, float((g[m].abs() / bnorm).max())

    X = torch.zeros_like(B)
    res, cycles = float("inf"), 0
    with _f32_precision("highest"):
        while res >= tol and cycles < max_cycles:
            X, res = cycle(X)
            cycles += 1
    return (X[:, 0] if was_vec else X), cycles * m, res


def solve_gmres_plan(
    apply_fn,
    b,
    tol: float = 1e-6,
    restart: int = 60,
    max_iter: int = 240,
    device=None,
) -> GmresResult:
    """Restarted GMRES DRIVEN FROM PYTHON with the vectors on the device:
    the Krylov basis (CGS2), and the solution update stay on b's device;
    the host receives one Hessenberg column per iteration and runs the
    Givens recurrence in float64 (complex128).

    `apply_fn` maps an (n,) device tensor to an (n,) or (n, 1) one: any
    Python-level callable, e.g. the BIE system around
    `PartitionPlan.apply`. Solve wall time is then about iterations times
    the apply.

    `b` may be real or complex (complex64 or complex128). A complex `b`
    runs a complex Krylov basis on the device (CGS2 with `V.conj() @ w`)
    and complex Givens rotations on the host in complex128 (real cosine,
    complex sine); `apply_fn` then maps complex tensors to complex ones.
    A float32 basis floors the relative residual around 1e-6..1e-7; a
    `tol` below that runs to max_iter and reports the floor. `converged` is
    the true final residual under 10 * tol.

    On a card, CGS2 and the packing of the Hessenberg column run as one
    CUDA graph replay an iteration, over the power of two of the basis's
    rows that holds the rows in use (the rows past them are zero). The
    graphs are captured at a process's first solve of each (device, dtype,
    n, restart); `apply_fn` stays eager. Solves of one such shape share
    the graphs' buffers, so they run one at a time. On the CPU the same
    step runs eagerly on the rows in use.

    With `utils.profiling.tracing` on, a solve is the span `gmres.solve`
    over `gmres.residual` (each true residual and its norm read), and per
    iteration `gmres.apply`, `gmres.orth` (CGS2), `gmres.read` (the
    Hessenberg column to the host) and `gmres.givens` (the rotations and
    the residual estimate), then `gmres.update` (back substitution and the
    update of x) a cycle; it counts `gmres.iters`, and on a card
    `gmres.cgs2_replay` (the graphs' replays) and `gmres.cgs2_capture`
    (their captures). On a card, the event pairs `gmres.gap` time the
    card's idle from each CGS2's end to the cycle's next apply.
    """
    with profiling.span("gmres.solve", root=True):
        return _gmres_plan(apply_fn, b, tol, restart, max_iter, device)


def _vh(V: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """V^H w as conj(V conj(w)): no conjugate copy of V."""
    if V.is_complex():
        return torch.mv(V, w.conj()).conj_physical()
    return torch.mv(V, w)


def _cgs2(V: torch.Tensor, w: torch.Tensor, hdtype: torch.dtype):
    """Classical Gram-Schmidt of `w` against the rows of `V` with one
    reorthogonalisation pass (CGS2). Returns (q, col): `q` the normalised
    remainder (zero where the remainder is zero) and `col` = [beta, h],
    beta its norm and h = V^H w over both passes, in `hdtype`.

    Rows of `V` that are zero add exact zeros: on a basis whose rows past
    j are zero, `q` and `col[: j + 2]` are those of `V[: j + 1]` up to the
    order of the sums, and the rest of `col` is zero."""
    h1 = _vh(V, w)
    w = w - V.T @ h1
    h2 = _vh(V, w)
    w = w - V.T @ h2
    beta = torch.linalg.vector_norm(w)
    q = w / torch.where(beta > 0, beta, 1.0)
    col = torch.empty(V.shape[0] + 1, dtype=hdtype, device=V.device)
    col[0] = beta
    torch.add(h1, h2, out=col[1:])
    return q, col


def _rows(j: int, m: int) -> int:
    """The rows of the basis CGS2 runs over at iteration j on a card: the
    power of two that holds V[0..j], at most m."""
    return min(1 << j.bit_length(), m)


class _CardStep:
    """`_cgs2` as CUDA graphs on fixed buffers: `V` the basis (m + 1 rows,
    zero past the rows in use) and `w` the vector to orthogonalise. One
    graph for each bucket of rows `_rows(j, m)`: iteration j replays the
    smallest that holds V[0..j], since a gemv over all m + 1 rows is slow
    on the card (~73 us a replay at m = 400, n = 2048 on an H100, ~36 us at
    32 rows). All are captured at once a process for each (device, dtype,
    n, m) and shared by the solves of that shape, so one such solve runs
    at a time. The graphs share one memory pool, and their warm-ups one
    side stream (cuBLAS keeps a workspace for each stream): a replay's `q`
    and `col` are read before the next replay on the same stream."""

    def __init__(self, device, dtype, hdtype, n: int, m: int):
        self.m = m
        self.pool = torch.cuda.graph_pool_handle()
        self.side = torch.cuda.Stream(device)
        with torch.cuda.device(device), _f32_precision("highest"):
            self.V = torch.zeros((m + 1, n), dtype=dtype, device=device)
            self.w = torch.zeros(n, dtype=dtype, device=device)
            self.graphs = {rows: self._capture(self.V[:rows], hdtype)
                           for rows in sorted({_rows(j, m)
                                               for j in range(m)})}

    def _capture(self, V: torch.Tensor, hdtype: torch.dtype):
        # warm-up on a side stream, as capture requires
        self.side.wait_stream(torch.cuda.current_stream(V.device))
        with torch.cuda.stream(self.side):
            _cgs2(V, self.w, hdtype)
        torch.cuda.current_stream(V.device).wait_stream(self.side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool):
            q, col = _cgs2(V, self.w, hdtype)
        profiling.count("gmres.cgs2_capture")
        return graph, q, col

    def replay(self, j: int):
        """CGS2 of `w` against V[0..j]: returns (q, col) with col[: j + 2]
        = [beta, h[0..j]]."""
        graph, q, col = self.graphs[_rows(j, self.m)]
        graph.replay()
        profiling.count("gmres.cgs2_replay")
        return q, col


_card_steps: dict = {}


def _card_step(device, dtype, hdtype, n: int, m: int) -> _CardStep:
    key = (device, dtype, n, m)
    step = _card_steps.get(key)
    if step is None:
        step = _card_steps[key] = _CardStep(device, dtype, hdtype, n, m)
    return step


def _gmres_plan(apply_fn, b, tol, restart, max_iter, device) -> GmresResult:
    span = profiling.span
    b = _on_device(b, device, complex_ok=True)
    check(b.ndim == 1, "solve_gmres_plan is single-RHS ((n,) vector)",
          InvalidArgumentsError)
    n = b.shape[0]
    m = int(restart)
    cplx = b.is_complex()
    hdt, tdt = ((np.complex128, torch.complex128) if cplx
                else (np.float64, torch.float64))

    x = torch.zeros_like(b)
    bnorm = float(torch.linalg.vector_norm(b))
    if bnorm == 0:
        return GmresResult(np.zeros(n, hdt), 0, [0.0], True)

    def resid(x):
        return b - apply_fn(x).reshape(n)

    # on a card, CGS2 and the column are one graph replay an iteration
    step = (_card_step(b.device, b.dtype, tdt, n, m)
            if b.device.type == "cuda" else None)
    gaps = profiling.device_gaps("gmres.gap", b.device)
    residuals: list[float] = []
    total = 0
    converged = False
    with _f32_precision("highest"):
        while total < max_iter and not converged:
            with span("gmres.residual"):
                r = resid(x)
                rnorm = float(torch.linalg.vector_norm(r))
            residuals.append(rnorm / bnorm)
            if rnorm / bnorm < tol:
                converged = True
                break
            if step is None:
                V = b.new_zeros((m + 1, n))
            else:
                V = step.V.zero_()
            V[0] = r / (rnorm if rnorm > 0 else 1.0)
            # host-side Givens recurrence state, float64 or complex128
            Hr = np.zeros((m + 1, m), hdt)
            cs = np.zeros(m)
            sn = np.zeros(m, hdt)
            g = np.zeros(m + 1, hdt)
            g[0] = rnorm
            j_used = 0
            for j in range(m):
                if total >= max_iter:
                    break
                with span("gmres.apply"):
                    if j:   # closes the pair the last CGS2 opened
                        gaps.stop()
                    w = apply_fn(V[j]).reshape(n)
                    if step is not None:
                        step.w.copy_(w)
                with span("gmres.orth"):
                    if step is None:
                        q, col = _cgs2(V[: j + 1], w, tdt)
                    else:
                        q, col = step.replay(j)
                    V[j + 1] = q
                gaps.start()
                with span("gmres.read"):
                    # the iteration's one fetch: the new norm and h[0..j]
                    got = col[: j + 2].cpu().numpy()
                    hcol = np.zeros(m + 1, hdt)
                    hcol[: j + 1] = got[1:]
                    hcol[j + 1] = got[0]
                with span("gmres.givens"):
                    for i in range(j):
                        t = cs[i] * hcol[i] + sn[i] * hcol[i + 1]
                        hcol[i + 1] = (-np.conj(sn[i]) * hcol[i]
                                       + cs[i] * hcol[i + 1])
                        hcol[i] = t
                    a, bb = hcol[j], hcol[j + 1]
                    if cplx:
                        # [c s; -conj(s) c] with c real takes (a, bb) to
                        # (a/|a| d, 0), d = ||(a, bb)||
                        d = np.hypot(abs(a), abs(bb))
                        if d == 0:
                            cs[j], sn[j] = 1.0, 0.0
                        elif a == 0:
                            cs[j], sn[j] = 0.0, np.conj(bb) / abs(bb)
                        else:
                            cs[j] = abs(a) / d
                            sn[j] = a / abs(a) * np.conj(bb) / d
                    else:
                        d = np.hypot(a, bb)
                        cs[j], sn[j] = ((1.0, 0.0) if d == 0
                                        else (a / d, bb / d))
                    hcol[j] = cs[j] * a + sn[j] * bb
                    hcol[j + 1] = 0.0
                    g[j + 1] = -np.conj(sn[j]) * g[j]
                    g[j] = cs[j] * g[j]
                    Hr[:, j] = hcol
                    total += 1
                    j_used = j + 1
                    res = abs(g[j + 1]) / bnorm
                    residuals.append(res)
                if res < tol:
                    converged = True
                    break
            if j_used:
                with span("gmres.update"):
                    y = np.zeros(j_used, hdt)
                    for i in range(j_used - 1, -1, -1):
                        y[i] = (g[i] - Hr[i, i + 1:j_used] @ y[i + 1:]) / (
                            Hr[i, i] if Hr[i, i] != 0 else 1.0)
                    x = x + V[:j_used].T @ torch.as_tensor(
                        y, dtype=V.dtype, device=V.device)
        # true residual check (the Givens estimate drifts at the f32 floor)
        with span("gmres.residual"):
            final = float(torch.linalg.vector_norm(resid(x))) / bnorm
    gaps.flush()
    profiling.count("gmres.iters", total)
    residuals.append(final)
    log_debug("gmres_plan: %d iters, rel res %.3e (givens est %.3e)",
              total, final, residuals[-2] if len(residuals) > 1 else 0.0)
    return GmresResult(x.cpu().numpy(), total, residuals,
                       bool(final < 10 * tol))


# ---------------------------------------------------------------------------
# Eigen solves (host, setup-time)
# ---------------------------------------------------------------------------


def _as_sparse(A) -> sp.spmatrix:
    if sp.issparse(A):
        return A.tocsc()
    if hasattr(A, "materialize"):
        return sp.csc_matrix(A.materialize())
    return sp.csc_matrix(np.asarray(A))


def _v0(n: int) -> np.ndarray:
    """Deterministic Lanczos start vector: ARPACK otherwise seeds from the
    global legacy RNG, making eigensolves depend on unrelated code having
    drawn random numbers (observed as test-order-dependent eigenband
    results)."""
    return np.random.default_rng(0x5EED).standard_normal(n)


def get_max_eigenvalue(L, M) -> float:
    """Largest eigenvalue of the generalized problem L x = lam M x
    (reference: bfGetMaxEigenvalue, src/linalg.c:328-470)."""
    Ls, Ms = _as_sparse(L), _as_sparse(M)
    vals = spla.eigsh(
        Ls, k=1, M=Ms, which="LA", return_eigenvectors=False, tol=1e-9,
        v0=_v0(Ls.shape[0]),
    )
    return float(vals[0])


def get_shifted_eigs(L, M, sigma: float, k: int):
    """k eigenpairs of (L, M) nearest `sigma` via shift-invert Lanczos,
    sorted ascending (reference: bfGetShiftedEigs, src/linalg.c:472-746)."""
    Ls, Ms = _as_sparse(L), _as_sparse(M)
    vals, vecs = spla.eigsh(Ls, k=k, M=Ms, sigma=sigma, which="LM",
                            v0=_v0(Ls.shape[0]))
    order = np.argsort(vals)
    return vals[order], vecs[:, order]


def _cluster_edges(vals: np.ndarray) -> np.ndarray:
    """Indices where a new distinct eigenvalue cluster starts."""
    if vals.size == 0:
        return np.empty(0, dtype=np.int64)
    tol = 1e-9 * max(1.0, np.abs(vals).max())
    return np.concatenate([[0], np.flatnonzero(np.diff(vals) > tol) + 1])


def _covering_probe(L, M, sigma: float, k: int, n: int):
    """One COVERING probe: eigenpairs around sigma plus a certified covered
    bracket (reference: getPairsCoveringInterval, src/linalg.c:818-899).

    The certified interval's endpoints are placed strictly BETWEEN distinct
    eigenvalue clusters so multiplets are never split between probes; the
    outermost clusters are discarded (they may be incomplete)."""
    kk = k + 2
    while True:
        kk = min(kk, n - 2)
        vals, vecs = get_shifted_eigs(L, M, sigma, kk)
        starts = _cluster_edges(vals)
        if starts.size >= 3 or kk >= n - 2:
            break
        kk *= 2
    if starts.size < 3:
        # whole reachable spectrum is (at most) two clusters: certify all
        return vals, vecs, (-np.inf, np.inf)
    c0_end = starts[1]  # first kept index
    cm_start = starts[-1]  # first discarded index
    lo = 0.5 * (vals[c0_end - 1] + vals[c0_end])
    hi = 0.5 * (vals[cm_start - 1] + vals[cm_start])
    keep = slice(c0_end, cm_start)
    return vals[keep], vecs[:, keep], (float(lo), float(hi))


def get_eigenband(L, M, lam0: float, lam1: float, method: str = "covering",
                  k_init: int = 8):
    """All eigenpairs with lam in [lam0, lam1]
    (reference: bfGetEigenband, src/linalg.c:969-1000).

    method="doubling": shift-invert at the midpoint, doubling k until the
      returned spectrum covers the band (src/linalg.c:748-816).
    method="covering": maintain a worklist of uncovered subintervals; probe
      each at its midpoint with k_init+2 eigenpairs, certify the midpoint
      bracket, subtract it from the worklist (src/linalg.c:901-967).

    Handles half-open bands: lam0=-inf or lam1=+inf take everything on that
    side reachable from the probes (used by the LBO streamer's brackets,
    src/lbo.c:41-68).
    """
    check(lam0 < lam1, "empty band", InvalidArgumentsError)
    n = _as_sparse(L).shape[0]

    # Resolve half-open bands to the actual spectrum edge first — a shifted
    # probe alone cannot certify that nothing lies further out.
    if not np.isfinite(lam0):
        Ls, Ms = _as_sparse(L), _as_sparse(M)
        # shift-invert just below the spectrum: (L - sigma M) is definite for
        # sigma < lam_min, so this is robust even for singular L (lam_min=0),
        # where plain Lanczos which='SA' can silently miss the kernel.
        scale = abs(Ls.diagonal()).sum() / max(abs(Ms.diagonal()).sum(), 1e-300)
        sigma_probe = -1e-6 * max(scale, 1e-300)
        lam_min = float(
            spla.eigsh(Ls, k=1, M=Ms, sigma=sigma_probe, which="LM",
                       return_eigenvectors=False, v0=_v0(Ls.shape[0]))[0]
        )
        lam0 = lam_min - max(1e-8, 1e-8 * abs(lam_min))
    if not np.isfinite(lam1):
        lam_max = get_max_eigenvalue(L, M)
        lam1 = lam_max + max(1e-8, 1e-8 * abs(lam_max))

    finite_lo = np.isfinite(lam0)
    finite_hi = np.isfinite(lam1)

    if method == "doubling":
        sigma = (
            0.5 * (lam0 + lam1)
            if finite_lo and finite_hi
            else (lam1 - 1.0 if finite_hi else lam0 + 1.0)
        )
        k = k_init
        while True:
            k = min(k, n - 2)
            vals, vecs = get_shifted_eigs(L, M, sigma, k)
            lo_ok = (not finite_lo) or vals[0] < lam0
            hi_ok = (not finite_hi) or vals[-1] > lam1
            if (lo_ok and hi_ok) or k >= n - 2:
                keep = np.ones_like(vals, dtype=bool)
                if finite_lo:
                    keep &= vals >= lam0
                if finite_hi:
                    keep &= vals < lam1
                return vals[keep], vecs[:, keep]
            k *= 2

    check(method == "covering", f"unknown method {method}", InvalidArgumentsError)
    check(finite_lo and finite_hi,
          "covering method needs a finite band; use doubling for half-open",
          InvalidArgumentsError)

    all_vals: list[np.ndarray] = []
    all_vecs: list[np.ndarray] = []
    # worklist of disjoint uncovered intervals (reference: disjoint interval
    # list, src/disjoint_interval_list.c)
    work = [(lam0, lam1)]
    guard = 0
    while work:
        guard += 1
        check(guard <= 1000, "eigenband covering failed to converge")
        a, b = work.pop()
        sigma = 0.5 * (a + b)
        vals, vecs, (lo, hi) = _covering_probe(L, M, sigma, k_init, n)
        if lo >= b or hi <= a:
            # certified interval fell outside the work interval: nothing in
            # (a, b) near sigma was certified — enlarge the probe instead of
            # looping forever
            vals, vecs, (lo, hi) = _covering_probe(L, M, sigma, 4 * k_init, n)
            if lo >= b or hi <= a:
                lo, hi = a, b  # accept what we have for this interval
        keep = (vals >= a) & (vals < b) & (vals >= lo) & (vals < hi)
        all_vals.append(vals[keep])
        all_vecs.append(vecs[:, keep])
        if lo > a:
            work.append((a, min(lo, b)))
        if hi < b:
            work.append((max(hi, a), b))
        log_debug("eigenband covering: probe sigma=%.4g covered (%.4g, %.4g)",
                  sigma, lo, hi)

    vals = np.concatenate(all_vals)
    vecs = np.concatenate(all_vecs, axis=1) if all_vecs else np.zeros((n, 0))
    order = np.argsort(vals)
    return vals[order], vecs[:, order]
