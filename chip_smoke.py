#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`butterfly_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

It needs one CUDA card, `nvcc` (the kernels are built from `csrc/` at first
use) and this checkout; it imports neither JAX nor the JAX package. Phases,
each printing its numbers on lines of their own:

  1. card: name, and the `nvidia-smi` name and power limit;
  2. build: K1 (`csrc/k1_pass.cu`) built by nvcc, with the compiler's report;
  3. kernel vs plain: K1 against its plain PyTorch version on the card, on
     small shapes covering every dtype mode, no leaf, partial depth, varying
     and odd ranks, wide blocks and a vector;
  4. flagship: a random butterfly at full width (NB=1024 blocks of 128 rows,
     10 levels) applied in bf16 at r=2048 and in IEEE f32 at r=256;
  5. real factorization: a 4096 x 1024 DCT matrix streamed through the
     factorizer, distilled to FFT form and applied through K1 at r=1024;
     that apply's output is held to a relative error of 1e-6 against the
     dense product in float64, and K1's passes to 1e-5 against the plain
     passes. Timed both as K1's passes alone and as the entry point's whole
     apply (passes plus the gather into canonical row order).

The main path (phases 4 and 5, one apply each) runs with K1's launch count
set to 0 just before and read just after. Times are medians of CUDA-event
timings after warm-up. The last lines are one JSON object describing the
kernels, the `nvidia-smi` line, and the result object. Any failed check
exits non-zero; nothing is caught and carried on.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# Data-sheet peaks of one H100 SXM (dense, at 700 W).
PEAK_BF16 = 989e12       # FLOP/s, bf16 tensor cores
PEAK_F32 = 67e12         # FLOP/s, float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


def bound_ms(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def nbytes_of(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from butterfly_tpu_torch.config import FacSpec
    from butterfly_tpu_torch.fac.streamer import FacStreamer
    from butterfly_tpu_torch.fac.uniformize import uniformize_fused
    from butterfly_tpu_torch.ops.butterfly import (
        UniformButterfly,
        random_butterfly,
    )
    from butterfly_tpu_torch.ops.fused_butterfly import K1, FusedButterflyPlan
    from butterfly_tpu_torch.trees import uniform_tree
    from butterfly_tpu_torch.utils.nvcc import build_kernel
    from butterfly_tpu_torch.utils.timer import device_time

    # IEEE float32 everywhere, including the plain and library paths: TF32
    # would break the accuracy lines.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)

    # ---- 1. card --------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[1 card] {name}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; tf32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn "
          f"{torch.backends.cudnn.allow_tf32}", flush=True)
    print(f"[1 card] nvidia-smi name, power limit: {smi}", flush=True)

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    K1.load()
    build_s = time.perf_counter() - t0
    lib = build_kernel("k1_pass.cu")
    log = lib.with_name(lib.name + ".log")
    print(f"[2 build] K1 built and loaded in {build_s:.2f} s", flush=True)
    entry = ""
    for ln in log.read_text().splitlines():  # ptxas -v: one report per kernel
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
        elif "spill" in ln or "Used" in ln:
            print(f"[2 build] {entry}: {ln.split(':')[-1].strip()}")

    # ---- 3. kernel vs plain, small shapes -------------------------------
    def randn(shape, dtype=torch.float32):
        return torch.as_tensor(rng.standard_normal(shape),
                               dtype=torch.float32).to(dev, dtype)

    def ranked_butterfly(NB, ranks, k_in):
        # leaf (NB, ranks[0], k_in); level l maps ranks[l] -> ranks[l+1]
        leaf = randn((NB, ranks[0], k_in)) / np.sqrt(k_in)
        levels = [randn((NB // 2 ** (l + 1), 2, 2, 2 ** l, ranks[l + 1],
                         ranks[l])) / np.sqrt(2 * ranks[l])
                  for l in range(len(ranks) - 1)]
        return UniformButterfly(leaf, levels, 2)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    cases = [
        # name, butterfly, weight dtype, act dtype, fuse, r
        ("f32", random_butterfly(16, 32, generator=gen(1), device=dev),
         torch.float32, torch.float32, 2, 40),
        ("bf16 w / bf16 act", random_butterfly(16, 32, generator=gen(2),
                                               device=dev),
         torch.bfloat16, torch.bfloat16, 2, 40),
        ("bf16 w / f32 act", random_butterfly(16, 32, generator=gen(3),
                                              device=dev),
         torch.bfloat16, torch.float32, 2, 40),
        ("no leaf", random_butterfly(16, 8, generator=gen(4),
                                     with_leaf=False, device=dev),
         torch.float32, torch.float32, 2, 70),
        ("partial depth 5 of 6", random_butterfly(64, 8, num_levels=5,
                                                  generator=gen(5),
                                                  device=dev),
         torch.float32, torch.float32, 3, 8),
        ("varying ranks 37,50,29,64", ranked_butterfly(8, [37, 50, 29, 64],
                                                       24),
         torch.float32, torch.float32, 2, 33),
        ("varying ranks bf16", ranked_butterfly(8, [37, 50, 29, 64], 24),
         torch.bfloat16, torch.bfloat16, 2, 33),
        ("wide blocks 160 (two row sweeps)", random_butterfly(
            4, 160, generator=gen(6), device=dev),
         torch.float32, torch.float32, 2, 100),
        ("blocks 256 (16-column tile)", random_butterfly(
            4, 256, generator=gen(7), device=dev),
         torch.float32, torch.float32, 2, 37),
        ("vector r=1", random_butterfly(32, 16, generator=gen(8),
                                        device=dev),
         torch.float32, torch.float32, 3, 1),
        ("bf16 blocks 160 (64-column tile)", random_butterfly(
            4, 160, generator=gen(9), device=dev),
         torch.bfloat16, torch.bfloat16, 2, 100),
        ("bf16 blocks 320 (32-column tile, two row sweeps)",
         random_butterfly(4, 320, generator=gen(10), device=dev),
         torch.bfloat16, torch.float32, 2, 45),
        ("bf16 vector r=1", random_butterfly(32, 16, generator=gen(11),
                                             device=dev),
         torch.bfloat16, torch.bfloat16, 3, 1),
    ]
    for label, bf, wdt, act, fuse, r in cases:
        plan = FusedButterflyPlan(bf.astype(wdt), fuse=fuse, act_dtype=act,
                                  device=dev)
        x = randn((bf.shape[1],) if r == 1 else (bf.shape[1], r))
        got = plan.apply(x)
        want = plan.apply_plain(x)
        torch.cuda.synchronize()
        require(got.shape == want.shape and got.dtype == act,
                f"{label}: kernel output {tuple(got.shape)} {got.dtype}")
        require(bool(torch.isfinite(got).all()), f"{label}: non-finite")
        err = rel_err(got, want)
        tol = TOL[torch.bfloat16 if torch.bfloat16 in (wdt, act)
                  else torch.float32]
        print(f"[3 kernel vs plain] {label}: passes "
              f"{[(p.k, p.r_tile) for p in plan.passes]} rel err "
              f"{err:.3e} (tol {tol:g})", flush=True)
        require(err <= tol, f"{label}: rel err {err:.3e} > {tol:g}")

    # ---- 4 + 5. the main path, one apply each, counted ------------------
    NB, block = 1024, 128
    r16, r32, rD = 2048, 256, 1024
    bf16 = random_butterfly(NB, block, dtype=torch.bfloat16,
                            generator=gen(7), device=dev)
    bf32 = bf16.astype(torch.float32)
    n = bf16.shape[1]
    x16 = torch.randn((n, r16), generator=gen(8), device=dev,
                      dtype=torch.float32).to(torch.bfloat16)
    x32 = torch.randn((n, r32), generator=gen(9), device=dev)

    nD, mD = 4096, 1024
    xg = (np.arange(nD) + 0.5) / nD
    Phi = np.cos(np.pi * np.outer(xg, np.arange(mD))) * np.sqrt(2.0 / nD)
    spec = FacSpec(row_tree=uniform_tree(nD, 2, 6),
                   col_tree=uniform_tree(mD, 2, 3), row_tree_init_depth=2,
                   tol=1e-7, min_num_rows=8, min_num_cols=8)
    xD = torch.randn((mD, rD), generator=gen(10), device=dev)

    K1.launches = 0
    plan_B = FusedButterflyPlan(bf16, fuse=8, act_dtype=torch.bfloat16,
                                device=dev)
    plan_A = FusedButterflyPlan(bf32, fuse=8, device=dev)
    yB = plan_B.apply(x16)
    yA = plan_A.apply(x32)
    torch.cuda.synchronize()
    launches_flagship = K1.launches
    K1.launches = 0
    ts = time.perf_counter()
    streamer = FacStreamer(spec)
    for leaf in spec.col_tree.nodes_at_depth(3):
        if leaf.num_points:
            streamer.feed(Phi[:, leaf.i0:leaf.i1])
    fac = streamer.get_fac()
    fp = uniformize_fused(fac, tol=1e-7, dtype=torch.float32, fuse=8,
                          device=dev)
    setup_D = time.perf_counter() - ts
    yD = fp.apply(xD)
    torch.cuda.synchronize()
    launches_real = K1.launches
    launches = launches_flagship + launches_real
    require(launches_flagship > 0 and launches_real > 0,
            "the main path did not launch K1")

    # ---- 4. flagship numbers --------------------------------------------
    require(yB.shape == (n, r16) and yB.dtype == torch.bfloat16
            and bool(torch.isfinite(yB).all()), "flagship bf16 output")
    require(yA.shape == (n, r32) and bool(torch.isfinite(yA).all()),
            "flagship f32 output")
    print("[4 flagship] bound = max(flops / peak, bytes / HBM rate) with the "
          "H100 SXM data-sheet peaks: 989 TFLOP/s bf16 dense, 67 TFLOP/s "
          "FP32 non-tensor, 3.35 TB/s", flush=True)
    results = {}
    for key, plan, bf, x, y, peak in (
            ("flagship bf16", plan_B, bf16, x16, yB, PEAK_BF16),
            ("flagship f32", plan_A, bf32, x32, yA, PEAK_F32)):
        r = x.shape[1]
        flops = bf.flops_per_col() * r
        ms = 1e3 * device_time(lambda: plan.apply(x), warmup=2, iters=10)
        plain_ms = 1e3 * device_time(lambda: plan.apply_plain(x), warmup=1,
                                     iters=10)
        library_ms = 1e3 * device_time(lambda: bf.apply(x), warmup=1,
                                       iters=10)
        b_ms, b_by = bound_ms(flops, bf.nbytes() + nbytes_of(x)
                              + nbytes_of(y), peak)
        plain = plan.apply_plain(x)
        lib = bf.apply(x)
        err_plain = rel_err(y, plain)
        err_lib = rel_err(y, lib)
        max_abs = float((y.double() - plain.double()).abs().max())
        tol = TOL[x.dtype]
        require(err_plain <= tol, f"{key}: kernel vs plain {err_plain:.3e}")
        results[key] = dict(
            shape=f"NB={NB} blk={block} L=10 r={r} {x.dtype}".replace(
                "torch.", ""),
            passes=[(p.k, p.r_tile) for p in plan.passes], ms=ms,
            tflops=flops / ms / 1e9, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
            max_abs_err=max_abs, rel_err_vs_plain=err_plain,
            rel_err_vs_library=err_lib)
        print(f"[4 flagship] {key}: " + json.dumps(results[key]),
              flush=True)
        del plain, lib
    # bf16 error against the f32 kernel on the same weights (the
    # reference's method): quantize the probe to bf16 first
    xs16 = torch.as_tensor(rng.standard_normal((n, 8)),
                           dtype=torch.float32).to(dev, torch.bfloat16)
    rel_B = rel_err(plan_B.apply(xs16), plan_A.apply(xs16.float()))
    require(rel_B <= 5e-2, f"bf16 vs f32 rel err {rel_B:.3e}")
    print(f"[4 flagship] bf16 rel err vs the f32 kernel: {rel_B:.3e}; "
          f"K1 launches on the main path: {launches_flagship}", flush=True)
    del plan_B, plan_A, bf16, bf32, x16, x32, yB, yA
    torch.cuda.empty_cache()

    # ---- 5. real factorization numbers ----------------------------------
    # The counted run's own output, at the timed shape, against the dense
    # product in float64; its kernel passes against the plain passes.
    require(yD.shape == (nD, rD) and bool(torch.isfinite(yD).all()),
            "real fac output")
    rel_D = rel_err(yD, torch.as_tensor(Phi, device=dev) @ xD.double())
    require(rel_D <= 1e-6, f"real fac rel err {rel_D:.3e} > 1e-6")
    yDb = fp.apply_butterfly_order(xD)
    plainDb = fp.plan.apply_plain(xD)
    err_D = rel_err(yDb, plainDb)
    require(err_D <= TOL[torch.float32],
            f"real fac: kernel vs plain {err_D:.3e}")
    flops_D = fp.flops_per_col() * rD
    # K1's passes alone (butterfly row order), and the entry point's whole
    # apply: the passes plus the gather into canonical row order
    ms_D = 1e3 * device_time(lambda: fp.apply_butterfly_order(xD),
                             warmup=2, iters=20)
    apply_D = 1e3 * device_time(lambda: fp.apply(xD), warmup=2, iters=20)
    plain_D = 1e3 * device_time(lambda: fp.plan.apply_plain(xD), warmup=1,
                                iters=20)
    lib_D = 1e3 * device_time(lambda: fp.dist.bf.apply(xD), warmup=1,
                              iters=20)
    bD_ms, bD_by = bound_ms(flops_D, fp.dist.bf.nbytes() + nbytes_of(xD)
                            + nbytes_of(yDb), PEAK_F32)
    real = dict(
        shape=f"n={nD} m={mD} NB={fp.plan.NB} rank={fp.rank} r={rD} float32",
        passes=[(p.k, p.r_tile) for p in fp.plan.passes], setup_s=setup_D,
        rel_err_vs_dense=rel_D, ms=ms_D, tflops=flops_D / ms_D / 1e9,
        apply_ms=apply_D, plain_ms=plain_D, library_ms=lib_D,
        bound_ms=bD_ms, bound_by=bD_by,
        max_abs_err=float((yDb.double() - plainDb.double()).abs().max()),
        rel_err_vs_plain=err_D, launches=launches_real)
    print("[5 real fac] " + json.dumps(real), flush=True)

    # ---- the record -----------------------------------------------------
    head = results["flagship bf16"]
    kernels = {"kernels": [{
        "name": "k1_pass",
        "route": "cuda",
        "source": "butterfly_tpu_torch/csrc/k1_pass.cu",
        "replaces": "butterfly_tpu/ops/pallas_butterfly.py:132",
        "launches": launches,
        "max_abs_err": head["max_abs_err"],
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "shape": head["shape"],
        "cases": {"flagship f32": results["flagship f32"], "real fac": real},
    }]}
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
