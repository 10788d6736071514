"""Butterfly-compressed embedding retrieval on the card.

Twin of the JAX package's `examples/retrieval.py`: compress an embedding
table, score query batches against it, take the exact top-100 on the card,
and report recall@100 against exact dense scoring plus throughput.

Two formats (see butterfly_tpu_torch/models/retrieval.py):
- one-level `CompressedTable` (tall tables; default): rows are PCA
  tree-ordered, then per-block truncated SVD at uniform rank;
- `--deep`: the streamed multilevel butterfly (`DeepTable`) on a wide DCT
  table, scored through its packed `StagePlan`; reports its storage against
  the one-level format at the same accuracy.

Usage:
  python -m butterfly_tpu_torch.examples.retrieval --n 1048576 --d 128
  python -m butterfly_tpu_torch.examples.retrieval --deep --n 8192

Each run prints one JSON row with the JAX script's keys. Times are means
of a batch of scoring + top-100 calls between CUDA events on the card;
where the run lies on the CPU (`--device cpu`), they are None (not
measured).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from butterfly_tpu_torch.models.retrieval import (
    compress_table,
    compress_table_deep,
    exact_topk,
    recall_at_k,
    recall_with_tolerance,
    tree_order_rows,
)
from butterfly_tpu_torch.utils.device import resolve_device
from butterfly_tpu_torch.utils.timer import device_time


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_tall_table(n: int, d: int, rng) -> np.ndarray:
    """Clustered + smooth-latent + popularity-skewed rows (ANN-benchmark
    style)."""
    z = np.sort(rng.random(n))
    comps = np.stack([np.cos(2 * np.pi * (j + 1) * z + rng.random() * 6)
                      for j in range(16)])
    table = comps.T @ rng.standard_normal((16, d))
    table += 0.001 * rng.standard_normal((n, d))
    table *= (1.0 + rng.pareto(2.0, n)).clip(None, 50.0)[:, None]
    return table


def dct_table(n: int, m: int) -> np.ndarray:
    """The wide structured table: an n x m DCT-II basis (the
    LBO-eigenvector analogue)."""
    x = (np.arange(n) + 0.5) / n
    return np.cos(np.pi * np.outer(x, np.arange(m))) * np.sqrt(2.0 / n)


def _timed(fn, dev) -> float | None:
    """Median seconds of `fn` on the card; None on the CPU."""
    return device_time(fn, warmup=2, iters=10) if dev.type == "cuda" else None


def _qps(queries: int, t: float | None) -> int | None:
    return None if t is None else round(queries / t)


def _device_name(dev) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)


def run_one_level(args, rng, dev) -> dict:
    n, d = args.n, args.d
    table = make_tall_table(n, d, rng)
    t0 = time.time()
    perm = tree_order_rows(table)
    table = table[perm]
    log(f"tree-ordered rows [{time.time()-t0:.1f}s]")

    t0 = time.time()
    ct = compress_table(table, rank=args.rank, block_rows=128,
                        svd_dtype=np.float32 if n > 262144 else np.float64,
                        device=dev)
    dense = table.astype(np.float32).nbytes
    log(f"compressed {n}x{d} table: {dense/1e6:.0f} MB -> "
        f"{ct.nbytes()/1e6:.1f} MB (ratio {ct.nbytes()/dense:.3f}) "
        f"[{time.time()-t0:.1f}s]")

    q = rng.standard_normal((args.queries, d)).astype(np.float32)
    qd = torch.from_numpy(q).to(dev)
    with torch.no_grad():
        t = _timed(lambda: ct.topk(qd, 100), dev)
        _, idx = ct.topk(qd, 100)
    log(f"scoring+top-100 for {args.queries} queries: "
        f"{'not measured' if t is None else f'{t*1e3:.3f} ms'}")

    idx = idx.cpu().numpy()
    true_scores = q @ table.T
    strict = recall_at_k(idx, exact_topk(table, q, 100))
    tolr = recall_with_tolerance(idx, true_scores, 100, tol=1e-3)
    log(f"recall@100: strict {strict:.4f}, tolerance {tolr:.4f}")
    return {
        "format": "one_level", "n": n, "d": d, "rank": args.rank,
        "compression_ratio": round(ct.nbytes() / dense, 4),
        "ms_per_batch": None if t is None else 1e3 * t,
        "queries_per_s": _qps(args.queries, t),
        "recall_at_100_strict": round(float(strict), 4),
        "recall_at_100_tol1e3": round(float(tolr), 4),
        "device": _device_name(dev),
    }


def run_deep(args, rng, dev) -> dict:
    n = args.n
    table = dct_table(n, n)
    log(f"wide structured table {n}x{n} "
        f"({table.astype(np.float32).nbytes/1e6:.0f} MB dense f32)")

    t0 = time.time()
    dt_table = compress_table_deep(table, tol=args.tol,
                                   col_depth=max(2, int(np.log2(n)) - 7),
                                   device=dev)
    log(f"deep (streamed butterfly): logical "
        f"{dt_table.nbytes_logical()/1e6:.1f} MB, device "
        f"{dt_table.nbytes()/1e6:.1f} MB "
        f"(numW={dt_table.fac.num_w}) [{time.time()-t0:.1f}s]")

    # one-level storage at the same accuracy (uniform rank = max tol-rank)
    blocks = table.reshape(n // 128, 128, n)
    S = np.linalg.svd(blocks, compute_uv=False)
    r = int((S >= args.tol * S[:, :1]).sum(1).max())
    one_bytes = (n * r + (n // 128) * r * n) * 4
    log(f"one-level at same tol: rank {r} -> {one_bytes/1e6:.1f} MB; "
        f"deep/one-level ratio {dt_table.nbytes()/one_bytes:.2f}")

    q = rng.standard_normal((args.queries, n)).astype(np.float32)
    qd = torch.from_numpy(q).to(dev)
    t = _timed(lambda: dt_table.topk(qd, 100), dev)
    _, idx = dt_table.topk(qd, 100)
    rec = recall_at_k(idx.cpu().numpy(), exact_topk(table, q, 100))
    log(f"deep scoring+top-100 for {args.queries} queries: "
        f"{'not measured' if t is None else f'{t*1e3:.3f} ms'}; "
        f"recall@100 {rec:.4f}")
    return {
        "format": "deep_butterfly", "n": n, "tol": args.tol,
        "device_mb": round(dt_table.nbytes() / 1e6, 1),
        "one_level_mb_same_tol": round(one_bytes / 1e6, 1),
        "deep_over_one_level": round(dt_table.nbytes() / one_bytes, 3),
        "ms_per_batch": None if t is None else 1e3 * t,
        "queries_per_s": _qps(args.queries, t),
        "recall_at_100_strict": round(float(rec), 4),
        "device": _device_name(dev),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=131072)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--rank", type=int, default=32)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--deep", action="store_true")
    ap.add_argument("--tol", type=float, default=1e-4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--json", type=str, default=None,
                    help="append the run's metrics to this JSON file")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    if args.deep:
        if args.n > 65536:
            args.n = 8192  # wide table is n x n; keep the dense oracle sane
        rec = run_deep(args, rng, dev)
    else:
        rec = run_one_level(args, rng, dev)
    print(json.dumps(rec), flush=True)
    if args.json:
        records = []
        if os.path.exists(args.json):
            with open(args.json) as f:
                records = json.load(f)
        records.append(rec)
        with open(args.json, "w") as f:
            json.dump(records, f, indent=1)
    return rec


if __name__ == "__main__":
    main()
