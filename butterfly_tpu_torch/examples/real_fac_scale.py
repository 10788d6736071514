"""A real streamed factorization at scale on the card: a 16384 x 4096 DCT
matrix streamed -> distilled to FFT form -> applied through K1, with the
float32 accuracy clause checked against the dense product in float64.

Twin of the JAX package's `examples/real_fac_scale.py` (the run behind
`REAL_FAC_r05.json`): the same matrix, the same `FacSpec` (uniform trees,
tol 1e-7, at least 8 rows and columns a block) and the same
`uniformize_fused(tol=1e-7, float32)`. What differs: the apply is timed as
the mean of a batch of calls between CUDA events on the card (the JAX
script's dispatch-chained slope is a TPU host-link workaround), and its
TFLOP/s is set against the card's own float32 peak outside the tensor
cores, 67 TFLOP/s for an H100 SXM, not read from `BENCH_CONSTANTS.json`
(a TPU figure).

Usage:
  python -m butterfly_tpu_torch.examples.real_fac_scale [--n 16384]
      [--m 4096] [--r 1024] [--device cpu] [--out FILE]

Prints the JAX script's JSON keys on one line, `device` set to the card's
name, plus `plain_ms` (the same plan through its plain passes),
`library_ms` (the distilled butterfly's per-level einsums,
`UniformButterfly.apply`), `dense_ms` (Phi @ x in float32 on the card),
`bound_ms` and `bound_by` (the larger of the flops over the peak and the
bytes moved over the HBM rate), `passes`
(depth, column tile and engine of each K1 pass) and `k1_launches` (K1
launches of the timed apply's first call). On the CPU the times are None
(not measured).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from butterfly_tpu_torch.config import FacSpec
from butterfly_tpu_torch.fac.streamer import FacStreamer
from butterfly_tpu_torch.fac.uniformize import uniformize_fused
from butterfly_tpu_torch.ops.fused_butterfly import K1
from butterfly_tpu_torch.trees import uniform_tree
from butterfly_tpu_torch.utils.device import resolve_device
from butterfly_tpu_torch.utils.timer import device_time

# float32 FLOP/s of one H100 SXM outside the tensor cores, and its HBM
# rate (data sheet, dense, 700 W)
PEAK_F32_TFLOPS = 67.0
HBM_BYTES_PER_S = 3.35e12


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def dct_matrix(n: int, m: int) -> np.ndarray:
    """The JAX script's Phi: cos(pi (i + 1/2) j / n) sqrt(2 / n)."""
    xg = (np.arange(n) + 0.5) / n
    return np.cos(np.pi * np.outer(xg, np.arange(m))) * np.sqrt(2.0 / n)


def run(n: int, m: int, r: int, device=None) -> dict:
    device = resolve_device(device)
    on_card = device.type == "cuda"
    Phi = dct_matrix(n, m)
    rec = {"n": n, "m": m}

    t0 = time.perf_counter()
    spec = FacSpec(
        row_tree=uniform_tree(n, 2, 7),
        col_tree=uniform_tree(m, 2, 3),
        row_tree_init_depth=2, tol=1e-7,
        min_num_rows=8, min_num_cols=8,
    )
    streamer = FacStreamer(spec)
    for leaf in spec.col_tree.nodes_at_depth(3):
        if leaf.num_points:
            streamer.feed(Phi[:, leaf.i0:leaf.i1])
    fac = streamer.get_fac()
    rec["stream_s"] = round(time.perf_counter() - t0, 1)
    log(f"stream: {rec['stream_s']} s")

    t0 = time.perf_counter()
    fp = uniformize_fused(fac, tol=1e-7, dtype=torch.float32, fuse=8,
                          device=device)
    rec["distill_s"] = round(time.perf_counter() - t0, 1)
    rec["rank"] = fp.rank
    rec["weights_mb"] = round(fp.nbytes() / 1e6, 1)
    rec["dense_mb"] = round(n * m * 8 / 1e6, 1)
    rec["compression_ratio"] = round(fp.nbytes() / (n * m * 4), 3)
    rec["passes"] = [[p.k, p.r_tile, p.engine] for p in fp.plan.passes]
    log(f"distill: {rec['distill_s']} s, rank {fp.rank}, "
        f"{rec['weights_mb']} MB")

    # ---- fused apply time (CUDA events on the card) ---------------------
    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.randn((m, r), generator=gen, device=device)
    flops = fp.flops_per_col() * r
    launches = K1.launches
    fp.apply(x)
    rec["k1_launches"] = K1.launches - launches
    if on_card:
        per = device_time(lambda: fp.apply(x), warmup=3, iters=20)
        rec["apply_ms"] = per * 1e3
        rec["apply_tflops"] = flops / per / 1e12
        rec["plain_ms"] = 1e3 * device_time(lambda: fp.plan.apply_plain(x),
                                            warmup=1, iters=10)
        rec["library_ms"] = 1e3 * device_time(lambda: fp.dist.bf.apply(x),
                                              warmup=1, iters=10)
        Phi_d = torch.as_tensor(Phi, dtype=torch.float32, device=device)
        rec["dense_ms"] = 1e3 * device_time(lambda: Phi_d @ x, warmup=2,
                                            iters=10)
        del Phi_d
        rec["sol_frac_vs_f32_peak"] = rec["apply_tflops"] / PEAK_F32_TFLOPS
        rec["peak_f32_tflops"] = PEAK_F32_TFLOPS
        # the least time: the flops over the peak, or the weights, x and y
        # moved once over the HBM rate
        t_ops = flops / (PEAK_F32_TFLOPS * 1e12)
        t_bytes = (fp.nbytes() + 4 * (m + n) * r) / HBM_BYTES_PER_S
        rec["bound_ms"] = 1e3 * max(t_ops, t_bytes)
        rec["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    else:
        for key in ("apply_ms", "apply_tflops", "plain_ms", "library_ms",
                    "dense_ms"):
            rec[key] = None
    log(f"apply r={r}: {rec['apply_ms']} ms -> {rec['apply_tflops']} "
        f"TFLOP/s")

    # ---- accuracy vs dense ----------------------------------------------
    xs = np.random.default_rng(0).standard_normal((m, 4)).astype(np.float32)
    got = fp.apply(torch.from_numpy(xs).to(device)).double().cpu().numpy()
    want = Phi @ xs.astype(np.float64)
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    rec["rel_err_vs_dense"] = rel
    rec["device"] = torch.cuda.get_device_name(device) if on_card else str(
        device)
    log(f"rel err vs dense: {rel:.2e}")
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--m", type=int, default=4096)
    ap.add_argument("--r", type=int, default=1024)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain passes")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rec = run(args.n, args.m, args.r, device=args.device)
    print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump([rec], f, indent=1)
    return rec


if __name__ == "__main__":
    main()
