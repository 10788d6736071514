"""Compressed retrieval on the card: three formats of one table, and
BASELINE config 2 at 1M x 128.

Twin of the JAX package's `examples/retrieval_lbo.py`, with its three
tables:

- the LBO table (the default): `icosphere(--subdiv)` (7: 163,842
  vertices), its FEM Laplace-Beltrami pencil (`Trimesh.lbo_fem`), the
  `--num-eigs` lowest eigenvectors by host shift-invert
  `eigsh(L, k, M=M, sigma=0)` from a seeded start vector, so that the
  table is repeatable although the sphere's eigenvalues are multiple (or
  loaded from `--phi`; computed, they are saved there), rows in octree
  order (`Octree(verts, leaf_size=64)`, the reference's bf_lbo row tree);
- `--synthetic`: a 4096 x 256 DCT table (the LBO-eigenvector analogue).

Either table goes through the same three formats, rows scaled to unit RMS,
256 unit queries, each recall-checked against exact dense scoring:
    one_level   `compress_table` (rank 64)
    deep        `compress_table_deep` (tol 1e-3, col_depth 3, leaf 128),
                scored through its packed `StagePlan`
    deep_fused  `distill_butterfly` of the deep fac (NB the largest power
                of two up to n/1024, at least 16; rank d/NB + 64), scored
                through `FusedButterflyPlan` on the fused pass kernel K1
                (plain passes on the CPU); ids are mapped back to table
                rows through `dist.row_perm`.

- `--config1m`: BASELINE config 2, a 1M x 128 table of per-block rank-8
  rows plus 1e-3 noise (`default_rng(7)`), compressed at rank 32: lookup
  against the dense rows and against the factors multiplied out in float64
  on the host, serving rate of scoring + top-100, strict and tolerance
  recall@100 against exact scoring on the card, the two-stage re-rank (1024
  candidates, gather, exact rescoring) and, unless `--skip-deep-1m`, the
  deep format at 1M.

Scoring runs in IEEE float32 and top-k is exact (`torch.topk`): the TPU's
`approx_max_k` and its one-pass bf16 products have no counterpart, so
recall may differ from the TPU record either way.

Usage:
  python -m butterfly_tpu_torch.examples.retrieval_lbo --subdiv 7 \
      --num-eigs 1024 --phi /path/lbo_phi1024.npy
  python -m butterfly_tpu_torch.examples.retrieval_lbo --synthetic
  python -m butterfly_tpu_torch.examples.retrieval_lbo --config1m

Prints one JSON list of rows. Times are means of a batch of calls between
CUDA events on the card; on the CPU (`--device cpu`) they are None (not
measured).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import scipy.sparse.linalg as spla
import torch

from butterfly_tpu_torch.examples.retrieval import (
    _device_name,
    _qps,
    _timed,
    dct_table,
    log,
)
from butterfly_tpu_torch.fac.distill import distill_butterfly
from butterfly_tpu_torch.geom.trimesh import icosphere
from butterfly_tpu_torch.models.retrieval import (
    compress_table,
    compress_table_deep,
    recall_at_k,
    recall_with_tolerance,
)
from butterfly_tpu_torch.ops.butterfly import _f32_precision
from butterfly_tpu_torch.ops.fused_butterfly import FusedButterflyPlan
from butterfly_tpu_torch.ops.linalg import _v0
from butterfly_tpu_torch.trees import Octree
from butterfly_tpu_torch.utils.device import resolve_device
from butterfly_tpu_torch.utils.errors import InvalidArgumentsError, check

# candidates the compressed scan keeps for exact re-ranking (config1m)
RERANK_K = 1024


def top100(scores_qn: torch.Tensor) -> torch.Tensor:
    """Exact top-100 ids of (q, n) scores."""
    return torch.topk(scores_qn, 100).indices


def synthetic_table() -> np.ndarray:
    """The 4096 x 256 DCT table of the JAX script's `--synthetic` path."""
    return dct_table(4096, 256).astype(np.float32)


def lbo_table(subdiv: int, num_eigs: int, phi: str | None = None):
    """The LBO eigenvector table of `icosphere(subdiv)`: the `num_eigs`
    lowest eigenvectors of its FEM pencil by host shift-invert `eigsh`, or
    those saved at `phi`, float32, rows in octree order. Returns (table,
    eigsh seconds or None when loaded)."""
    mesh = icosphere(subdiv)
    if phi and os.path.exists(phi):
        Phi = np.load(phi).astype(np.float32)
        check(Phi.shape == (mesh.num_verts, num_eigs),
              f"--phi {phi} holds a table of shape {Phi.shape}; "
              f"icosphere({subdiv}) with {num_eigs} eigenvectors needs "
              f"{(mesh.num_verts, num_eigs)}", InvalidArgumentsError)
        log(f"loaded Phi {Phi.shape} from {phi}")
        eig_s = None
    else:
        L, M = mesh.lbo_fem()
        t0 = time.perf_counter()
        _, Phi = spla.eigsh(L, k=num_eigs, M=M, sigma=0.0, which="LM",
                            v0=_v0(mesh.num_verts))
        eig_s = time.perf_counter() - t0
        log(f"eigsh k={num_eigs} on {mesh.num_verts} vertices: "
            f"{eig_s:.1f} s")
        Phi = Phi.astype(np.float32)
        if phi:
            np.save(phi, Phi)
    # octree row order (reference: bf_lbo's octree row tree,
    # examples/lbo/bf_lbo.c:223)
    return Phi[Octree(mesh.verts, leaf_size=64).perm], eig_s


def prepare_table(Phi: np.ndarray) -> np.ndarray:
    """The table as every format scores it: rows scaled to unit RMS (scores
    are O(1)), zero rows padded to a multiple of 128 (256 above n=16384),
    float32."""
    n, d = Phi.shape
    Phi = Phi * (np.sqrt(n / max(np.linalg.norm(Phi) ** 2, 1e-30))
                 * np.sqrt(d))
    # one_level's blocks are 128 rows (the JAX script pads to 16 up to
    # n=16384, which leaves the LBO tables of icosphere(3) to (6) a ragged
    # last block)
    NBpad = 256 if n > 16384 else 128
    n_pad = -(-n // NBpad) * NBpad
    if n_pad != n:
        Phi = np.concatenate([Phi, np.zeros((n_pad - n, d), Phi.dtype)],
                             axis=0)
    return Phi.astype(np.float32)


def fused_shape(n_pad: int, d: int, rank=None) -> tuple[int, int]:
    """(NB, rank) of the deep_fused format: NB the largest power of two up
    to n_pad/1024 (at least 16) that divides both dims, rank d/NB + 64
    unless given."""
    NBf = 1 << max(4, int(np.log2(max(16, n_pad // 1024))))
    while NBf > 2 and (n_pad % NBf or d % NBf or d // NBf < 2):
        NBf //= 2
    return NBf, rank or min(d // NBf + 64, d)


def run_table(Phi: np.ndarray, args, dev):
    """The three formats of one table. Returns (rows, fused): fused holds
    the deep_fused plan, its distillation, the queries on the device
    (transposed, `x`), the exact scores and top-100 and the prepared table,
    or None when that format did not run."""
    n, d = Phi.shape
    Phi = prepare_table(Phi)
    n_pad = Phi.shape[0]
    log(f"table: {n} rows (padded {n_pad}) x {d}, "
        f"dense {Phi.nbytes/1e6:.0f} MB")
    dense_mb = n_pad * d * 4 / 1e6

    rng = np.random.default_rng(0)
    q = args.queries
    Q = rng.standard_normal((q, d)).astype(np.float32)
    Q /= np.linalg.norm(Q, axis=1, keepdims=True)
    exact_scores = Q @ Phi.T                       # (q, n_pad) host oracle
    true100 = np.argsort(-exact_scores, axis=1)[:, :100]
    Qd = torch.from_numpy(Q).to(dev)
    dev_name = _device_name(dev)

    def row(fmt, ids, t, **kw):
        r = {"format": fmt, "n": n, "d": d, **kw,
             "dense_mb": round(dense_mb, 1),
             "ms_per_batch": None if t is None else 1e3 * t,
             "queries_per_s": _qps(q, t),
             "recall_at_100_strict": round(recall_at_k(ids, true100), 4),
             "recall_at_100_tol1e-3": round(
                 recall_with_tolerance(ids, exact_scores, 100), 4),
             "device": dev_name}
        log(json.dumps(r))
        return r

    results = []
    formats = set(args.formats.split(","))
    if "fused" in formats:
        formats.add("deep")  # the fused format distills the deep fac

    if "one_level" in formats:
        t0 = time.time()
        ct = compress_table(Phi, rank=args.rank_one_level, block_rows=128,
                            svd_dtype=np.float32, device=dev)
        setup_s = time.time() - t0
        with torch.no_grad():
            t = _timed(lambda: ct.topk(Qd, 100), dev)
            ids = ct.topk(Qd, 100).indices.cpu().numpy()
        mb_ct = ct.nbytes() / 1e6
        results.append(row("one_level", ids, t, rank=args.rank_one_level,
                           mb=round(mb_ct, 1),
                           compression_ratio=round(mb_ct / dense_mb, 3),
                           setup_s=setup_s))
        del ct

    fused = None
    if "deep" in formats:
        t0 = time.time()
        dt = compress_table_deep(Phi, tol=args.deep_tol, col_depth=3,
                                 row_leaf=128, device=dev)
        setup_s = time.time() - t0
        log(f"deep setup {setup_s:.1f} s; logical "
            f"{dt.nbytes_logical()/1e6:.1f} MB, device "
            f"{dt.nbytes()/1e6:.1f} MB, buckets "
            f"{dt.plan.stats.num_gemm_buckets}")
        t = _timed(lambda: dt.topk(Qd, 100), dev)
        ids = dt.topk(Qd, 100).indices.cpu().numpy()
        mb_dt = dt.nbytes_logical() / 1e6
        extra = {}
        if "one_level" in formats:
            extra["vs_one_level_storage"] = round(mb_dt / mb_ct, 3)
        results.append(row("deep_butterfly", ids, t, tol=args.deep_tol,
                           mb_logical=round(mb_dt, 1),
                           mb_device=round(dt.nbytes() / 1e6, 1),
                           compression_ratio=round(mb_dt / dense_mb, 3),
                           setup_s=setup_s, **extra))

    if "fused" in formats:
        t0 = time.time()
        NBf, rank_fused = fused_shape(n_pad, d, args.rank_fused)
        dist = distill_butterfly(dt.fac.as_linop(), NBf, rank=rank_fused,
                                 dtype=torch.float32, device=dev)
        plan = FusedButterflyPlan(dist.bf, fuse=8, device=dev)
        setup_s = time.time() - t0
        log(f"fused setup {setup_s:.1f} s; NB={NBf} rank={dist.rank} "
            f"{dist.nbytes()/1e6:.1f} MB; passes "
            f"{[(p.k, p.r_tile, p.engine) for p in plan.passes]}")
        x = Qd.T.contiguous()
        # scores in butterfly row order; ids go back through row_perm
        t = _timed(lambda: top100(plan.apply(x).T), dev)
        ids = dist.row_perm[top100(plan.apply(x).T).cpu().numpy()]
        mb_fp = dist.nbytes() / 1e6
        results.append(row("deep_fused", ids, t, rank=dist.rank,
                           mb=round(mb_fp, 1),
                           compression_ratio=round(mb_fp / dense_mb, 3),
                           setup_s=setup_s))
        fused = {"plan": plan, "dist": dist, "x": x, "true100": true100,
                 "exact_scores": exact_scores, "table": Phi}
    return results, fused


def config1m_table(n: int) -> np.ndarray:
    """BASELINE config 2's table: n x 128, each 128-row block near an
    8-dimensional subspace, plus 1e-3 noise (`default_rng(7)`; the JAX
    script's construction, n = 2^20 there)."""
    d, br, sig_rank, noise = 128, 128, 8, 1e-3
    NBb = n // br
    rng0 = np.random.default_rng(7)
    U = rng0.standard_normal((NBb, br, sig_rank), dtype=np.float32)
    V = rng0.standard_normal((NBb, sig_rank, d), dtype=np.float32)
    Phi = (U @ V) / np.float32(np.sqrt(sig_rank * d))
    Phi += noise * rng0.standard_normal((NBb, br, d), dtype=np.float32)
    return np.ascontiguousarray(Phi.reshape(n, d))


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                    1e-30))


def run_config1m(args, dev) -> list:
    """BASELINE config 2: compress, look up, score, top-100, recall@100
    against exact dense scoring, re-rank, and (unless skipped) the deep
    format (reference apply analogue: blockwise MulVec,
    src/mat_block_dense.c:574-630)."""
    n, d, br = args.rows, 128, 128
    rank = args.rank_one_level // 2
    q = args.queries
    t0 = time.time()
    Phi = config1m_table(n)
    log(f"config1m table: {n} x {d}, dense {Phi.nbytes/1e6:.0f} MB "
        f"({time.time()-t0:.1f} s)")
    dev_name = _device_name(dev)

    t0 = time.time()
    ct = compress_table(Phi, rank=rank, block_rows=br, svd_dtype=np.float32,
                        device=dev)
    setup_s = time.time() - t0
    mb, dense_mb = ct.nbytes() / 1e6, Phi.nbytes / 1e6
    log(f"config1m compress: rank={rank} {mb:.0f} MB "
        f"({mb/dense_mb:.3f} of dense) in {setup_s:.1f} s")

    rng = np.random.default_rng(0)
    Q = rng.standard_normal((q, d)).astype(np.float32)
    Q /= np.linalg.norm(Q, axis=1, keepdims=True)
    Qd = torch.from_numpy(Q).to(dev)
    Phi_dev = torch.from_numpy(Phi).to(dev)

    def exact_scores():
        with _f32_precision("highest"):
            return Qd @ Phi_dev.T                  # (q, n), IEEE float32

    def dense_top100():
        return top100(exact_scores())

    true100 = dense_top100().cpu().numpy()

    # the factors multiplied out in float64 on the host: the oracle of the
    # card's lookup and scoring (the compression error left out)
    Psi64 = ct.Psi.detach().double().cpu().numpy()
    V64 = ct.V.detach().double().cpu().numpy()

    def rows64(ids):
        return np.einsum("mr,mrd->md", Psi64[ids // br, ids % br],
                         V64[ids // br])

    ids = rng.integers(0, n, size=4096)
    with torch.no_grad():
        rows_c = ct.lookup(torch.from_numpy(ids)).cpu().numpy()
        sample = rng.choice(n, size=min(512, n), replace=False)
        scores_c = ct.score(Qd)[torch.from_numpy(sample).to(dev)]
        scores_c = scores_c.cpu().numpy()
    lookup_rel = _rel(rows_c, Phi[ids])
    lookup_rel_f64 = _rel(rows_c, rows64(ids))
    score_rel_f64 = _rel(scores_c, rows64(sample) @ Q.astype(np.float64).T)
    log(f"config1m lookup rel err: {lookup_rel:.2e} vs the dense rows, "
        f"{lookup_rel_f64:.2e} vs the factors in float64; scores (512 rows) "
        f"{score_rel_f64:.2e}")

    with torch.no_grad():
        t = _timed(lambda: ct.topk(Qd, 100), dev)
        # where a batch's time goes: the two products, then the top-k
        t_score = _timed(lambda: ct.score(Qd), dev)
        scores_qn = ct.score(Qd).T
        t_topk = _timed(lambda: top100(scores_qn), dev)
        del scores_qn
        t_dense = _timed(dense_top100, dev)
        idx = ct.topk(Qd, 100).indices

        def tol_recall(pred):
            s = exact_scores()
            cutoff = torch.topk(s, 100).values[:, -1]
            eps = 1e-3 * (s.max(dim=1).values - s.min(dim=1).values)
            sp = torch.take_along_dim(s, pred, dim=1)
            return float((sp >= (cutoff - eps)[:, None]).float().mean())

        rec = recall_at_k(idx.cpu().numpy(), true100)
        rec_tol = tol_recall(idx)
    # the least time of one batch: its products over the float32 peak, or
    # the factors read, the (n, q) scores written and read back by top-k
    flops = 2 * rank * q * (n // br * d + n)   # V @ q, then Psi @ mid
    nbytes = ct.nbytes() + 2 * n * q * 4 + Q.nbytes + 2 * q * 100 * 8
    bound_s = max(flops / 67e12, nbytes / 3.35e12)
    out = [{
        "format": "one_level_1m", "n": n, "d": d, "rank": rank,
        "block_rows": br, "mb": round(mb, 1), "dense_mb": round(dense_mb, 1),
        "compression_ratio": round(mb / dense_mb, 3),
        "setup_s": setup_s,
        "lookup_rel_err": lookup_rel,
        "lookup_rel_err_vs_f64": lookup_rel_f64,
        "score_rel_err_vs_f64": score_rel_f64,
        "ms_per_batch": None if t is None else 1e3 * t,
        "queries_per_s": _qps(q, t),
        "score_ms": None if t_score is None else 1e3 * t_score,
        "topk_ms": None if t_topk is None else 1e3 * t_topk,
        "bound_ms": 1e3 * bound_s, "bound_queries_per_s": int(q / bound_s),
        "dense_ms_per_batch": None if t_dense is None else 1e3 * t_dense,
        "dense_queries_per_s": _qps(q, t_dense),
        "recall_at_100_strict": round(rec, 4),
        "recall_at_100_tol1e-3": round(rec_tol, 4),
        "device": dev_name,
    }]
    log(json.dumps(out[-1]))

    # ---- two-stage: compressed scan -> exact re-rank of the candidates --
    # the compressed table prunes n rows to RERANK_K candidates, then one
    # gather + one small product re-scores them against the exact rows
    K2 = min(RERANK_K, n)

    def rerank_idx():
        cand = ct.topk(Qd, K2).indices
        rows = Phi_dev.index_select(0, cand.reshape(-1)).reshape(q, K2, d)
        with _f32_precision("highest"):
            s2 = torch.einsum("qkd,qd->qk", rows, Qd)
        return torch.take_along_dim(cand, top100(s2), dim=1)

    with torch.no_grad():
        t_rr = _timed(rerank_idx, dev)
        idx_rr = rerank_idx()
        row_rr = {
            "format": "one_level_1m_rerank", "n": n, "d": d, "rank": rank,
            "rerank_k": K2, "mb_compressed": round(mb, 1),
            "exact_bytes_per_query": K2 * d * 4,
            "ms_per_batch": None if t_rr is None else 1e3 * t_rr,
            "queries_per_s": _qps(q, t_rr),
            "recall_at_100_strict": round(
                recall_at_k(idx_rr.cpu().numpy(), true100), 4),
            "recall_at_100_tol1e-3": round(tol_recall(idx_rr), 4),
            "device": dev_name,
        }
    log(json.dumps(row_rr))
    out.append(row_rr)
    del ct, Phi_dev

    # ---- the deep format at 1M --------------------------------------------
    if not args.skip_deep_1m:
        t0 = time.time()
        dt = compress_table_deep(Phi, tol=args.deep_tol, col_depth=3,
                                 row_leaf=256, device=dev)
        deep_setup = time.time() - t0
        log(f"deep 1m setup {deep_setup:.1f} s; "
            f"logical {dt.nbytes_logical()/1e6:.0f} MB")
        t_dt = _timed(lambda: dt.topk(Qd, 100), dev)
        idx_dt = dt.topk(Qd, 100).indices.cpu().numpy()
        row_dt = {
            "format": "deep_1m", "n": n, "d": d, "tol": args.deep_tol,
            "mb_logical": round(dt.nbytes_logical() / 1e6, 1),
            "mb_device": round(dt.nbytes() / 1e6, 1),
            "dense_mb": round(dense_mb, 1),
            "compression_ratio": round(
                dt.nbytes_logical() / 1e6 / dense_mb, 3),
            "setup_s": deep_setup,
            "ms_per_batch": None if t_dt is None else 1e3 * t_dt,
            "queries_per_s": _qps(q, t_dt),
            "recall_at_100_strict": round(recall_at_k(idx_dt, true100), 4),
            "device": dev_name,
        }
        log(json.dumps(row_dt))
        out.append(row_dt)
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--rank-one-level", type=int, default=64)
    ap.add_argument("--formats", default="one_level,deep,fused",
                    help="comma list: one_level,deep,fused")
    ap.add_argument("--rank-fused", type=int, default=None)
    ap.add_argument("--deep-tol", type=float, default=1e-3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--phi", default=None,
                    help=".npy eigenvector table: loaded if it exists, "
                         "else computed and saved there")
    ap.add_argument("--subdiv", type=int, default=7)
    ap.add_argument("--num-eigs", type=int, default=1024)
    ap.add_argument("--synthetic", action="store_true",
                    help="the 4096 x 256 DCT table instead of the LBO table")
    ap.add_argument("--config1m", action="store_true",
                    help="BASELINE config 2: compressed lookup + scoring "
                         "on a 1M x 128 table")
    ap.add_argument("--rows", type=int, default=1 << 20,
                    help="rows of the --config1m table")
    ap.add_argument("--skip-deep-1m", action="store_true",
                    help="skip the deep-format row in --config1m")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap.parse_args(argv)


def main(argv=None) -> list:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    if args.config1m:
        out = run_config1m(args, dev)
    elif args.synthetic:
        out, _ = run_table(synthetic_table(), args, dev)
    else:
        Phi, eig_s = lbo_table(args.subdiv, args.num_eigs, args.phi)
        out, _ = run_table(Phi, args, dev)
        for r in out:
            r.update(table=f"lbo icosphere({args.subdiv})", eigsh_s=eig_s)
    if args.out:
        if os.path.exists(args.out):  # merge: replace same-format rows
            with open(args.out) as f:
                old = json.load(f)
            new_fmts = {r["format"] for r in out}
            out = [r for r in old if r.get("format") not in new_fmts] + out
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        log(f"wrote {args.out}")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
