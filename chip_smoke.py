#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`butterfly_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

It needs one CUDA card, `nvcc` (the kernels are built from `csrc/` at first
use) and this checkout; it imports neither JAX nor the JAX package. Phases,
each printing its numbers on lines of their own:

  1. card: name, and the `nvidia-smi` name and power limit;
  2. build: K1 (`csrc/k1_pass.cu`) and K2 (`csrc/k2_cell.cu`) built by
     nvcc and the native tree and mesh kits (`csrc/treekit.cpp`,
     `csrc/meshkit.cpp`) by g++, all at once, with the compiler's report;
  3. kernel vs plain: K1 against its plain PyTorch version on the card, on
     small shapes covering each of its three engines (FFMA, MMA, WGMMA) and
     each path in them: every dtype mode, no leaf, the leaf in a pass of
     its own, depths 1-3 (sibling stride V = 1, 2, 4), varying and odd
     ranks (37, 50, 29; blocks 160, 320, 384), ragged r, r=1, WGMMA with
     ranks 64 and 128, with and without the leaf, a leaf of 128 rows under
     levels of 64, columns padded to 8, and one plan mixing MMA and WGMMA
     passes; each case
     checks that its plan has the engines its label names; K2 against
     `cells_plain` on
     one and two buffers, plain-add cells, cells straddling two output
     tiles (dst mod 128 = 8 and 120) or running past the output, merged
     cells, device-made weight tiles, r in {1, 36, 1000}, tiles with zero
     borders as a partition plan makes them (rank-80 V tiles, U tiles
     with zero columns past rank 96; r in {1, 200}), a straddling cell
     that is zero in one half and a tile whose only entry drops (r in {1,
     36}), and a weight stack of more than 2^31 bytes;
  4. flagship: a random butterfly at full width (NB=1024 blocks of 128 rows,
     10 levels) applied in bf16 at r=2048 (WGMMA, 10 passes) and in IEEE
     f32 at r=256 (FFMA, the leaf alone and 10 passes), each also timed
     pass by pass;
  5. real factorization: a 4096 x 1024 DCT matrix streamed through the
     factorizer, distilled to FFT form and applied through K1 at r=1024;
     that apply's output is held to a relative error of 1e-6 against the
     dense product in float64, and K1's passes to 1e-5 against the plain
     passes. Timed both as K1's passes alone and as the entry point's whole
     apply (passes plus the gather into canonical row order);
  6. helm2 partition (bench E of the JAX package's bench.py): the
     single-layer Helmholtz operator on 4096 points of an ellipse at k=60,
     factorized on the host (quadtree leaf 32, `make_multilevel`) and
     compiled into the two-pass cell program on the card
     (`partition_apply_plan`); one counted apply at r=1024 through K2, its
     passes held to 1e-5 against `cells_plain`, and `apply_complex` held to
     a relative error of 1e-6 against the operator's own action in float64
     (beside it the plain passes' error, and that of the same float32 plan
     evaluated in float64, which bounds what any float32 apply can reach).
     Timed as the whole apply and as each K2 pass, beside the plain passes,
     one batched `torch.bmm` + `index_add_` per pass (library) and the
     materialized 8192 x 8192 float32 operator times x (dense). K2's bound
     counts the useful flops (the tiles' zero padding left out); the
     bounds of the work K2 executes after trimming and of the padded work
     are printed beside it, and per pass K2's engine, its matmul entries
     before and after trimming, its groups, the heaviest output tile's
     work against the mean, and the executed flops;
  7. the Helmholtz BIE solve at n=16384 through the scale twin
     (`butterfly_tpu_torch/examples/helm2_scale.py`): the combined-field
     operator D - ikS on the same ellipse at 64 points per wavelength
     (k=298.8), quadtree leaf 64, factorized on the host and compiled on
     the card (`setup`; the plan must slice its low-rank windows from the
     operator materialized on the card in float64); K2 held to 1e-5
     against `cells_plain` on this plan at r=1 (the shape GMRES runs) and
     r=64, and timed beside the plain passes, the operator materialized
     through the plan (n2 x n2 float32: `D @ x`, freed before the solve)
     and its bound (weights bytes over the HBM rate, useful flops over
     the float32 peak); then the twin's `measure`: its apply timings, the
     128-row oracle (held to 1e-6, and below the 7.987e-7 that float32
     windows read on the H100) and GMRES on the second-kind BIE through
     the card system without a corrector (`models/bie.py` `CardBie`;
     tol 3e-7, restart 80, max_iter 300) in a complex64 basis (held to
     converge within the 18 iterations of float32 windows), with
     iterations, seconds, ms per iteration and K2 launches over the
     solve, beside the TPU record `HELM2_SCALE_r05.json`; every low-rank
     class, factored in float64, held to the probe tolerance 3e-7;
  8. the fast direct solver's device substitution (`DeviceSolver`) on the
     operator-first Toeplitz system at n=4096
     (`butterfly_tpu_torch/examples/fast_direct_solver.py`): host float64
     factorization and residual (1e-8), 64 right-hand sides on the card
     against the host solve (5e-4), the refined residual (1e-8) and the
     device ms per right-hand side. It launches no kernel (plain products);
  9. retrieval (`butterfly_tpu_torch/examples/retrieval_lbo.py`): BASELINE
     config 2, the 1M x 128 table compressed at rank 32 (`--config1m
     --skip-deep-1m`): size and setup, lookup and a 512-row sample of the
     scores held to 1e-6 against the factors multiplied out in float64 on
     the host, the serving time of scoring + top-100 for 256 queries
     beside its bound and the dense `Q @ Phi.T` + `torch.topk`, strict and
     tolerance recall@100 against exact IEEE scoring on the card
     (tolerance recall held to 0.99), the re-rank row; then the
     `--synthetic` table in its three formats, the last (`deep_fused`) on
     K1: its passes held to 1e-5 against `pass_plain` and its strict
     recall through K1 equal to that through the plain passes; then
     `butterfly_tpu_torch.entry.entry()` once;
 10. the Helmholtz BIE family: the `helm2_bie` twin at n=2048, k=40, then
     the `multiple_scattering` twin at k=25 with 3 scatterers of 512
     points (`butterfly_tpu_torch/examples/`). Each builds its host path
     (the dense system and LU, the host butterfly system and host GMRES)
     and the card system (`models/bie.py` `card_system`): the S' operator
     through `partition_apply_plan` and the Kapur-Rokhlin accumulate
     corrector on the card. K2 on the S'
     plan is held to 1e-5 against `cells_plain` at r=1 and r=64 and timed
     beside the plain passes, the materialized operator's `D @ x` and the
     bound; then the card solve: the system's MVP held to 1e-6 against the
     dense float64 system in tree order, the density to 2e-5 against the
     dense LU, `CardBie.solve` in a complex64 basis (tol 3e-7, max_iter
     400, no restarts; at most 70 iterations for helm2_bie, whose host GMRES takes
     63, and 1.1 x the host's for the scattering system) held to converge
     (its true residual under 10 x tol or, where the plan's float32 error
     alone keeps the residual above that even at the dense-LU density,
     its Givens estimate under tol: the scattering system's floor, about
     6.7e-6, of which the plan's error is 6.6e-6 and the corrector's
     4.4e-7 in a CPU run) and
     the field to 1e-5 (helm2_bie) and 1e-4 (multiple_scattering) against
     the exact solution; its iterations beside host GMRES's and K2
     launches over the solve, two in each apply; its CGS2 replays, one an
     iteration (the program's counters, tracing on over the card half),
     and its ms an iteration; then the system's deviation from
     complex-linearity ||S(iz) - iS(z)|| / ||S(z)|| beside its MVP error;
 11. the rest of the fac -> device bridge: `distill_butterfly_device` of a
     1024 x 512 DCT matrix (NB=16, rank 64) on the card, held to 1e-5
     against dense in float64, and `distill_butterfly_batch` of a
     (4, 256, 256) batch (NB=8, rank 64), held to 1e-6 against
     block-diag(M_b); both applied by `fused_apply` through K1, its passes
     held to 1e-5 against `pass_plain` and equal to the plan's own apply;
 12. the LBO and covariance workload (BASELINE config 4) and the LBO
     eigenvector table: (a) `compress_lbo_eigenfunctions` on icosphere(3)
     (642 vertices, tol 1e-6) with the device eigensolver (dense path,
     float64 on the card), its eigenvalues held to the dense host
     eigensolve (rtol and atol 1e-8) and every frequency of the scipy
     branch found among its own (rtol 1e-8, atol 1e-6; the scipy branch
     misses one pair of a multiplet here), the `bf_lbo` eigen-residual of
     the compressed apply (1e-5) and the covariance apply through it
     against the Chebyshev apply (order 96, kappa 0.1; held to the JAX
     example's 4.402e-3); (b) `DeviceEigSession` on icosphere(5) (10,242
     vertices: LOBPCG, chunk 128, float64, cuSPARSE products) serving the
     lowest 256 pairs, held to host `eigsh(k=256, sigma=0)` (rtol and atol
     1e-8), residuals 1e-5 of the band's scale, M-orthonormality 1e-6, and
     timed against it; (c) the `retrieval_lbo` twin's LBO table at
     icosphere(5) with 1024 eigenvectors (host `eigsh`, octree rows) in
     its three formats, `deep_fused` on K1: its passes held to 1e-5
     against `pass_plain`, 512 rows of its scores to 1e-6 against the
     distilled factors in float64, recall of every format printed, K1
     timed beside its plain passes, the per-level einsum and the dense
     `Q @ Phi.T` + `torch.topk`; (d) on the host: the native treekit
     against the NumPy builder (the 65,536-point quadtree of the scale
     twin's ellipse, leaf 64; trees equal) and the native meshkit's
     `lbo_fem` against the NumPy assembly (icosphere(7); 1e-14), timed;
 13. radiosity (`butterfly_tpu_torch/geom/visibility.py`,
     `models/radiosity.py`, the `radiosity` twin; eager torch ops, no
     kernel, as the JAX package's jitted jnp): (a) 16,384 random triangles
     and 2^20 rays (`default_rng(13)`), the octree-culled visibility
     (leaf 512) equal to brute force ray for ray on the card, with one
     host read a ray chunk, the card against the CPU on 4096 rays (each
     disagreement printed with its float64 margin, failing above 1e-5),
     both paths timed, the ray-triangle pairs the culled path's tiles
     test beside those its candidates need and brute force's, and the
     culled path's host share read from a `torch.profiler` trace of a
     slice against its median unprofiled time (held to at most a half);
     (b) the
     occlusion-aware assembly of icosphere(3) equal to the plain one
     (1,637,120 nonzeros, no pair occluded); (c) the twin on icosphere(5),
     F dense in float64 on the card (3.36 GB): 4096 entries against the
     scalar formula (1e-12 relative), row sums in [1.00005, 1.0002], GMRES
     in 3-6 iterations, fixed-point residual 1e-8, B[0] >= 1, B >= -1e-12,
     the assembly seconds and the ms per matvec against 8 n^2 / 3.35 TB/s;
 14. multi-device on the one card (`butterfly_tpu_torch/parallel/`, the
     `multidevice` twin): gloo ranks, one process each, all sharing the
     card (NCCL refuses two ranks on one GPU), their collectives staged
     through the host. (a) `ShardedButterfly` of phase 4's f32 flagship
     (r=256) over 4 ranks: each runs the leaf and 8 local levels on K1 over
     256 blocks, the one all-to-all (25,165,824 elements moved, checked
     against `expected_exchange_elems`), then the 2 top levels; the
     gathered, unpermuted output held to 1e-5 against the single-process
     `FusedButterflyPlan` apply (bit-equality printed), each rank's K1
     passes to 1e-5 against their plain passes; per rank the local stage,
     exchange, top levels and whole apply timed, beside phase 4's f32
     flagship. (b) `PipelinedButterfly` of the same butterfly over 2 stage
     ranks, 4 microbatches, r=256: held to 1e-5 against the
     single-process `bf.apply`, ms per apply, steps, bubble share and the
     message of a rotation. (c) `dryrun_multichip(4)` (mesh data 2 x model
     2) with its checks. The ranks time-share the card's SMs: these are
     not scaling numbers.

Each part of the main path (phases 4 and 5 through K1, phases 6 and 7
through K2, phase 9 through K1, phase 10 through K2, phases 11 and 12
through K1, phase 14 (a) through K1 in each rank; phases 8 and 13 must
launch neither) runs with the launch counts set to 0 just before and read
just after; a rank counts its own launches and reports them.
Times are means of a batch of calls between two CUDA events after
warm-up (`utils/timer.py` `device_time`). The last lines are
one JSON object describing the kernels, the `nvidia-smi` line, and the
result object. Any failed check exits non-zero; nothing is caught and
carried on.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

# Data-sheet peaks of one H100 SXM (dense, at 700 W).
PEAK_BF16 = 989e12       # FLOP/s, bf16 tensor cores
PEAK_F32 = 67e12         # FLOP/s, float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
ROOT = Path(__file__).resolve().parent


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


def pass_split(plan) -> list:
    """(depth, column tile, engine) of each pass of a FusedButterflyPlan."""
    return [(p.k, p.r_tile, p.engine) for p in plan.passes]


def retrieval_phase(dev, timer):
    """Phase 9: the retrieval twin's `--config1m` (without the deep
    format) and `--synthetic` runs and `entry()`, with the launch
    counts set to 0 just before and read just after; then K1 on the
    deep_fused plan against its plain passes. Returns (K1's deep_fused
    case, K1 launches of the phase)."""
    from butterfly_tpu_torch.entry import entry
    from butterfly_tpu_torch.examples import retrieval_lbo as twin
    from butterfly_tpu_torch.models.retrieval import recall_at_k
    from butterfly_tpu_torch.ops.cellsp import K2
    from butterfly_tpu_torch.ops.fused_butterfly import K1, pass_plain

    args_1m = twin.parse_args(["--config1m", "--skip-deep-1m"])
    args_syn = twin.parse_args(["--synthetic"])
    K1.launches = 0
    K2.launches = 0
    with torch.no_grad():
        rows_1m = twin.run_config1m(args_1m, dev)
        rows_syn, fused = twin.run_table(twin.synthetic_table(), args_syn,
                                         dev)
        forward, eargs = entry(device=dev)
        evals, eidx = forward(*eargs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launches = K1.launches
    require(launches > 0 and K2.launches == 0,
            f"retrieval launched K1 {launches} and K2 {K2.launches} times")
    for r in rows_1m + rows_syn:
        print("[9 retrieval] " + json.dumps(r), flush=True)
    one = rows_1m[0]
    require(one["lookup_rel_err_vs_f64"] <= 1e-6,
            f"config1m lookup vs float64 {one['lookup_rel_err_vs_f64']:.3e}")
    require(one["score_rel_err_vs_f64"] <= 1e-6,
            f"config1m scores vs float64 {one['score_rel_err_vs_f64']:.3e}")
    require(one["recall_at_100_tol1e-3"] >= 0.99,
            f"config1m tolerance recall {one['recall_at_100_tol1e-3']}")
    print(f"[9 retrieval] config1m serving: {one['ms_per_batch']} ms a batch "
          f"of {args_1m.queries} ({one['queries_per_s']} q/s) against a bound "
          f"of {one['bound_ms']:.4f} ms ({one['bound_queries_per_s']} q/s); "
          f"dense Q @ Phi.T + topk {one['dense_ms_per_batch']} ms "
          f"({one['dense_queries_per_s']} q/s)", flush=True)
    tpu = json.loads((ROOT / "RETRIEVAL_R05_1M.json").read_text())
    print("[9 retrieval] TPU record RETRIEVAL_R05_1M.json (not this card): "
          + "; ".join(f"{t['format']} {t['queries_per_s']} q/s, strict "
                      f"{t['recall_at_100_strict']}" for t in tpu),
          flush=True)
    require(tuple(evals.shape) == (16, 100) and tuple(eidx.shape) == (16, 100)
            and bool(torch.isfinite(evals).all())
            and int(eidx.min()) >= 0 and int(eidx.max()) < 32 * 128,
            f"entry(): values {tuple(evals.shape)}, ids {tuple(eidx.shape)}")
    print(f"[9 retrieval] entry(): top-100 of 16 queries, best score "
          f"{float(evals[:, 0].max()):.4f}", flush=True)

    # K1 on the deep_fused plan against its plain passes (not counted)
    plan, dist, x = fused["plan"], fused["dist"], fused["x"]
    y, y_plain = plan.apply(x), plan.apply_plain(x)
    err = rel_err(y, y_plain)
    require(err <= 1e-5, f"deep_fused: K1 vs plain {err:.3e}")
    cur = x
    for i, (pm, ws) in enumerate(zip(plan.passes, plan._pass_weights)):
        leafp = plan._leafp if pm.has_leaf else None
        got = K1(pm, plan.radix, cur, leafp, ws)
        err_p = rel_err(got, pass_plain(pm, plan.radix, cur, leafp, ws))
        require(err_p <= 1e-5, f"deep_fused pass {i}: K1 vs plain {err_p:.3e}")
        cur = got
    ids_k1 = dist.row_perm[torch.topk(y.T, 100).indices.cpu().numpy()]
    ids_plain = dist.row_perm[torch.topk(y_plain.T, 100).indices.cpu().numpy()]
    rec_k1 = recall_at_k(ids_k1, fused["true100"])
    rec_plain = recall_at_k(ids_plain, fused["true100"])
    require(rec_k1 == rec_plain,
            f"deep_fused strict recall {rec_k1} through K1, {rec_plain} "
            "through the plain passes")
    r = x.shape[1]
    flops = dist.bf.flops_per_col() * r
    b_ms, b_by = bound_ms(flops, dist.bf.nbytes() + nbytes_of(x)
                          + nbytes_of(y), PEAK_F32)
    case = dict(
        shape=f"n=4096 d=256 NB={plan.NB} rank={dist.rank} r={r} float32",
        passes=pass_split(plan),
        ms=1e3 * timer(lambda: plan.apply(x), warmup=2, iters=20),
        plain_ms=1e3 * timer(lambda: plan.apply_plain(x), warmup=1,
                             iters=20),
        library_ms=1e3 * timer(lambda: dist.bf.apply(x), warmup=1,
                               iters=20),
        bound_ms=b_ms, bound_by=b_by,
        max_abs_err=float((y.double() - y_plain.double()).abs().max()),
        rel_err_vs_plain=err, recall_at_100_strict_k1=rec_k1,
        recall_at_100_strict_plain=rec_plain, launches=launches)
    print("[9 retrieval] K1 on deep_fused: " + json.dumps(case), flush=True)
    return case, launches


def materialize(plan, chunk: int = 1024) -> torch.Tensor:
    """The operator of a partition plan as an (n2, n2) float32 matrix on
    its device, applied to identity chunks."""
    n2, dev = plan.n2, plan.device
    D = torch.empty((n2, n2), device=dev)
    ar = torch.arange(chunk, device=dev)
    for j in range(0, n2, chunk):
        w = min(chunk, n2 - j)
        e = torch.zeros((n2, w), device=dev)
        e[j + ar[:w], ar[:w]] = 1.0
        D[:, j:j + w] = plan.apply(e)
    return D


def k2_on_plan(label: str, plan, gen, timer, rs=None) -> dict:
    """K2 on a partition plan against `cells_plain` at r in `rs` (not
    counted; by default 1, 2, the widest r of the matrix-vector engine, the
    next r and 64), on the engine that r takes, timed pass by pass beside
    the tile engine at the same r, the plain passes, the materialized
    operator's `D @ x` (the library call) and the bound: the plan's
    weights and the buffers over the HBM rate, its useful flops over the
    float32 peak. Two r=1 applies of one input must be bit-identical."""
    from butterfly_tpu_torch.ops.cellsp import _MV_MAX_R, K2, k2_engine

    c1, c2 = plan.cells1, plan.cells2
    D = materialize(plan)
    out = {}
    for r in rs or sorted({1, 2, _MV_MAX_R, _MV_MAX_R + 1, 64}):
        x = torch.randn((plan.n2, r), generator=gen, device=plan.device)
        y, y_plain = plan.apply(x), plan.apply_plain(x)
        err = rel_err(y, y_plain)
        require(y.shape == (plan.n2, r) and bool(torch.isfinite(y).all()),
                f"{label} r={r}: output")
        require(err <= 1e-5, f"{label} r={r}: K2 vs plain {err:.3e}")
        if r == 1:
            require(torch.equal(y, plan.apply(x)),
                    f"{label} r=1: two applies of one input differ")
        t = (c1.apply([x]) if c1 is not None else torch.zeros(
            (plan.t_rows, r), device=plan.device))

        def passes(engine):
            """ms of each pass on `engine` (None: the rule's), and the
            launches of each engine over the timing."""
            before = (K2.launches_mv, K2.launches_tile)
            p1 = (1e3 * timer(lambda: K2.launch(c1, [x], engine), warmup=2,
                              iters=20) if c1 is not None else 0.0)
            p2 = 1e3 * timer(lambda: K2.launch(c2, [x, t], engine),
                             warmup=2, iters=20)
            return [p1, p2], dict(mv=K2.launches_mv - before[0],
                                  tile=K2.launches_tile - before[1])

        (p1, p2), launches = passes(None)
        tile_ms, tile_launches = passes("tile")
        # the tile engine at this r, pass by pass, against the plain passes
        tile_err = max(rel_err(K2.launch(c, b, "tile"), c.apply_plain(b))
                       for c, b in ((c1, [x]), (c2, [x, t])) if c is not None)
        require(tile_err <= 1e-5,
                f"{label} r={r}: K2's tile engine vs plain {tile_err:.3e}")
        plain = 1e3 * timer(lambda: plan.apply_plain(x), warmup=1, iters=10)
        nbytes = plan.nbytes() + 2 * nbytes_of(x) + nbytes_of(t)
        b_ms, b_by = bound_ms(plan.useful_flops_per_col() * r, nbytes,
                              PEAK_F32)
        out[r] = dict(
            engine=k2_engine(r), ms=p1 + p2, k2_pass_ms=[p1, p2],
            launches=launches, tile_engine_pass_ms=tile_ms,
            tile_engine_launches=tile_launches,
            tile_engine_rel_err_vs_plain=tile_err,
            plain_ms=plain,
            library_ms=1e3 * timer(lambda: D @ x, warmup=2, iters=20),
            bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes,
            rel_err_vs_plain=err, rel_err_dense_vs_apply=rel_err(D @ x, y),
            max_abs_err=float((y.double() - y_plain.double()).abs().max()))
        print(f"[10 bie] {label} K2 r={r}: " + json.dumps(out[r]),
              flush=True)
    return out


def bie_phase(dev, timer):
    """Phase 10: the `helm2_bie` twin at n=2048, k=40 and the
    `multiple_scattering` twin at k=25, 3 x 512. Per twin: the host path
    and the card system (`setup`), K2 on its S' plan against the plain
    passes at r=1 and 64, then the card half (`solve`: the system's MVP
    against the dense float64 system, GMRES on the card) with the launch
    counts set to 0 just before and read just after, and the program's
    tracing on over it. Returns (cases, K2 launches of the solves)."""
    from butterfly_tpu_torch.examples import helm2_bie, multiple_scattering
    from butterfly_tpu_torch.ops.cellsp import K2
    from butterfly_tpu_torch.ops.fused_butterfly import K1
    from butterfly_tpu_torch.utils import profiling

    cases, launches = {}, 0
    for label, setup, solve, field_tol, max_iters in (
            ("helm2_bie n=2048 k=40",
             lambda: helm2_bie.setup(2048, 40.0, device=dev),
             helm2_bie.solve, 1e-5, lambda rec: 70),
            ("multiple_scattering k=25 3x512",
             lambda: multiple_scattering.setup(25.0, 3, 512, device=dev),
             multiple_scattering.solve, 1e-4,
             lambda rec: 1.1 * rec["host_gmres_iters"])):
        prob = setup()
        plan = prob.card.plan
        print(f"[10 bie] {label}: plan {prob.rec['plan_s']:.2f} s, windows "
              f"{plan.windows}, {prob.rec['weights_mb']:.1f} MB, classes "
              f"{plan._lr_meta}, oversized {plan.num_oversized}", flush=True)
        k2 = k2_on_plan(label, plan, torch.Generator(device=dev).manual_seed(
            31), timer)
        K1.launches = 0
        K2.launches = K2.launches_mv = K2.launches_tile = 0
        # the program's counters and spans over the card half: one GMRES
        # solve, its CGS2 a replayed graph an iteration
        profiling.reset()
        was = profiling.tracing(True)
        try:
            rec = solve(prob)
            torch.cuda.synchronize()
        finally:
            profiling.tracing(was)
        snap = profiling.snapshot()
        profiling.reset()
        calls = {k: v["calls"] for k, v in snap["spans"].items()}
        rec["gmres_counters"] = snap["counters"]
        applies = calls.get("gmres.apply", 0) + calls.get("gmres.residual", 0)
        require(K2.launches > 0 and K1.launches == 0,
                f"{label}: the solve launched K2 {K2.launches} and K1 "
                f"{K1.launches} times")
        case_launches = K2.launches
        rec["k2_launches_by_engine"] = dict(mv=K2.launches_mv,
                                            tile=K2.launches_tile)
        launches += case_launches
        require(rec["mvp_rel"] <= 1e-6,
                f"{label}: card MVP vs the dense system {rec['mvp_rel']:.3e}")
        # converged: the true residual under 10 x tol or, where the card
        # system cannot read a true residual that low even at the dense-LU
        # density (`f32_residual_floor` above 10 x tol) and that floor
        # comes from the plan's float32 weights, not from the corrector's
        # complex64 (`floor_from_corrector` under 10 x tol), the Givens
        # estimate under tol. The scattering system at k=25 is such a case:
        # there the S' term at the density is far larger than b (it
        # cancels against 0.5 sigma), so the plan's float32 error leaves
        # 6.6e-6 of ||b|| and the corrector's 4.4e-7 (the twin with
        # `--device cpu`). The density is held to helm2_bie's 2e-5
        # against the dense LU either way.
        require(rec["density_rel_vs_dense_lu"] <= 2e-5,
                f"{label}: density vs dense LU "
                f"{rec['density_rel_vs_dense_lu']:.3e}")
        tol10 = 10 * rec["gmres_tol"]
        require(rec["gmres_converged"] or (
            rec["gmres_givens_res"] < rec["gmres_tol"]
            and rec["f32_residual_floor"] > tol10
            and rec["floor_from_corrector"] < tol10),
            f"{label}: GMRES did not converge: {rec['gmres_iters']} "
            f"iterations, rel res {rec['gmres_rel_res']:.3e} (Givens "
            f"{rec['gmres_givens_res']:.3e}, float32 floor "
            f"{rec['f32_residual_floor']:.3e}: plan "
            f"{rec['floor_from_plan']:.3e}, corrector "
            f"{rec['floor_from_corrector']:.3e})")
        require(rec["k2_launches"] >= 2 * rec["gmres_iters"],
                f"{label}: GMRES launched K2 {rec['k2_launches']} times in "
                f"{rec['gmres_iters']} iterations")
        # the apply stays eager: K2's two passes in each of the solve's
        # applies (its iterations' and its true residuals')
        require(rec["k2_launches"] == 2 * applies,
                f"{label}: GMRES launched K2 {rec['k2_launches']} times in "
                f"{applies} applies")
        counters = rec["gmres_counters"]
        require(counters.get("gmres.iters") == rec["gmres_iters"]
                and counters.get("gmres.cgs2_replay") == rec["gmres_iters"],
                f"{label}: {counters.get('gmres.cgs2_replay')} CGS2 replays "
                f"in {counters.get('gmres.iters')} GMRES iterations")
        print(f"[10 bie] {label}: CGS2 replays "
              f"{counters.get('gmres.cgs2_replay')} (captures "
              f"{counters.get('gmres.cgs2_capture', 0)}) in "
              f"{counters.get('gmres.iters')} iterations, "
              f"{rec['ms_per_iter']:.3f} ms an iteration (tracing on, any "
              f"capture included), K2 {rec['k2_launches']} launches in "
              f"{applies} applies", flush=True)
        require(rec["field_rel_err"] <= field_tol,
                f"{label}: field rel err {rec['field_rel_err']:.3e}")
        # the complex basis: about the host's complex iterations (helm2_bie
        # took 113 on the interleaved real embedding, the host 63)
        require(rec["gmres_iters"] <= max_iters(rec),
                f"{label}: complex GMRES took {rec['gmres_iters']} "
                f"iterations, more than {max_iters(rec):.1f} (host "
                f"{rec['host_gmres_iters']})")
        # the plan applies the real embedding: its deviation from
        # complex-linearity, ||S(iz) - iS(z)|| / ||S(z)||, beside the MVP
        # error (the CPU tests hold it within twice that)
        gz = torch.Generator(device=dev).manual_seed(7)
        z = torch.complex(*(torch.randn(len(prob.card.perm), generator=gz,
                                        device=dev) for _ in range(2)))
        Sz = prob.card.sys_apply_complex(z)
        rec["complex_linearity"] = float(
            torch.linalg.vector_norm(prob.card.sys_apply_complex(1j * z)
                                     - 1j * Sz)
            / torch.linalg.vector_norm(Sz))
        print(f"[10 bie] {label}: GMRES on the card {rec['gmres_iters']} "
              f"iterations (tol {rec['gmres_tol']:g}, no restarts, complex64 "
              f"basis; true residual {rec['gmres_rel_res']:.3e}, float32 "
              f"floor {rec['f32_residual_floor']:.3e}: plan "
              f"{rec['floor_from_plan']:.3e}, corrector "
              f"{rec['floor_from_corrector']:.3e}), {rec['ms_per_iter']:.3f} "
              f"ms an iteration, K2 {rec['k2_launches']} launches in GMRES "
              f"(by engine over the whole solve call: "
              f"{rec['k2_launches_by_engine']}); complex-linearity "
              f"{rec['complex_linearity']:.3e} (MVP {rec['mvp_rel']:.3e}); "
              "on the host "
              f"{rec['host_gmres_iters']} (tol 1e-10, complex float64); "
              f"K2 r=1 {k2[1]['ms']:.4f} ms ({k2[1]['engine']} engine; "
              f"tile engine {sum(k2[1]['tile_engine_pass_ms']):.4f} ms) "
              f"against a bound of "
              f"{k2[1]['bound_ms']:.4f} ms ({k2[1]['bound_by']}), plain "
              f"{k2[1]['plain_ms']:.4f} ms, D @ x {k2[1]['library_ms']:.4f} "
              "ms", flush=True)
        print(f"[10 bie] {label} row: " + json.dumps(rec), flush=True)
        cases[label] = dict(k2, row=rec, launches=case_launches)
        del prob, plan
        torch.cuda.empty_cache()
    return cases, launches


def bridge_phase(dev, timer):
    """Phase 11: `distill_butterfly_device` of a 1024 x 512 DCT matrix
    (NB=16, rank 64) on the card and `distill_butterfly_batch` of a
    (4, 256, 256) batch (NB=8, rank 64), both applied by `fused_apply`
    through K1 with the launch counts set to 0 just before and read just
    after; then the accuracy against dense float64, K1 against
    `pass_plain` and the plan's own apply, and the times. Returns (case,
    K1 launches)."""
    from butterfly_tpu_torch.fac.distill import (
        distill_butterfly_batch,
        distill_butterfly_device,
    )
    from butterfly_tpu_torch.ops.cellsp import K2
    from butterfly_tpu_torch.ops.fused_butterfly import (
        K1,
        FusedButterflyPlan,
        fused_apply,
    )

    def dct(n, m, shift=0.0):
        x = (np.arange(n) + 0.5) / n + shift
        return np.cos(np.pi * np.outer(x, np.arange(m))) * np.sqrt(2.0 / n)

    Phi = dct(1024, 512)
    Mb = np.stack([dct(256, 256, 0.1 * b) for b in range(4)])
    gen = torch.Generator(device=dev).manual_seed(41)
    r = 1024
    x = torch.randn((512, r), generator=gen, device=dev)
    xb = torch.randn((1024, 8), generator=gen, device=dev)
    K1.launches = 0
    K2.launches = 0
    ts = time.perf_counter()
    d = distill_butterfly_device(torch.as_tensor(Phi, dtype=torch.float32,
                                                 device=dev), 16, rank=64)
    torch.cuda.synchronize()
    device_s = time.perf_counter() - ts
    ts = time.perf_counter()
    db = distill_butterfly_batch(Mb, 8, 64, device=dev)
    batch_s = time.perf_counter() - ts
    y = fused_apply(d.bf, x)
    yb = fused_apply(db.bf, xb)
    torch.cuda.synchronize()
    launches = K1.launches
    require(launches > 0 and K2.launches == 0,
            f"the bridge launched K1 {launches} and K2 {K2.launches} times")
    inv = np.empty_like(d.row_perm)
    inv[d.row_perm] = np.arange(d.row_perm.size)
    rel_dev = rel_err(y[torch.as_tensor(inv, device=dev)],
                      torch.as_tensor(Phi, device=dev) @ x.double())
    require(rel_dev <= 1e-5,
            f"distill_butterfly_device vs dense {rel_dev:.3e} > 1e-5")
    dense_b = torch.cat([torch.as_tensor(Mb[b], device=dev)
                         @ xb[b * 256:(b + 1) * 256].double()
                         for b in range(4)])
    rel_batch = rel_err(yb, dense_b[torch.as_tensor(db.row_perm,
                                                    device=dev)])
    require(rel_batch <= 1e-6,
            f"distill_butterfly_batch vs block-diag {rel_batch:.3e} > 1e-6")
    plan = FusedButterflyPlan(d.bf, fuse=3, device=dev)
    y_plain = plan.apply_plain(x)
    err = rel_err(y, y_plain)
    require(err <= 1e-5, f"fused_apply: K1 vs plain {err:.3e}")
    require(torch.equal(y, plan.apply(x)),
            "fused_apply differs from the plan's own apply")
    flops = d.bf.flops_per_col() * r
    b_ms, b_by = bound_ms(flops, d.bf.nbytes() + nbytes_of(x)
                          + nbytes_of(y), PEAK_F32)
    case = dict(
        shape=f"n=1024 m=512 NB=16 rank=64 r={r} float32 (distilled on the "
              "card)",
        passes=pass_split(plan), device_distill_s=device_s,
        batch_distill_s=batch_s, rel_err_device_vs_dense=rel_dev,
        rel_err_batch_vs_block_diag=rel_batch,
        max_sv_discarded=d.max_sv_discarded, sigma_max=d.sigma_max,
        ms=1e3 * timer(lambda: plan.apply(x), warmup=2, iters=20),
        fused_apply_ms=1e3 * timer(lambda: fused_apply(d.bf, x), warmup=2,
                                   iters=20),
        plain_ms=1e3 * timer(lambda: plan.apply_plain(x), warmup=1,
                             iters=20),
        library_ms=1e3 * timer(lambda: d.bf.apply(x), warmup=1, iters=20),
        bound_ms=b_ms, bound_by=b_by,
        max_abs_err=float((y.double() - y_plain.double()).abs().max()),
        rel_err_vs_plain=err, launches=launches)
    print("[11 bridge] " + json.dumps(case), flush=True)
    return case, launches


def lbo_phase(dev, timer, band=(5, 256), table=(5, 1024)):
    """Phase 12: the LBO and covariance workload (BASELINE config 4) and
    the LBO eigenvector table through K1. (a) `compress_lbo_eigenfunctions`
    on icosphere(3) with the device eigensolver (dense path, float64 on
    the card) against the scipy branch and the dense eigensolve, the
    compressed apply's eigen-residual and the covariance apply against the
    Chebyshev one; (b) `DeviceEigSession` on icosphere(5) (LOBPCG) for the
    lowest 256 pairs against host `eigsh`; (c) the `retrieval_lbo` twin's
    LBO table at icosphere(5), 1024 eigenvectors, in its three formats,
    the launch counts set to 0 just before and read just after, then K1 on
    its deep_fused plan. `band` and `table` are (subdivisions, pairs) of
    (b) and (c). Returns (K1's case, K1 launches of (c), the record of (a)
    and (b))."""
    import scipy.linalg as sla
    import scipy.sparse.linalg as spla

    from butterfly_tpu_torch.examples import bf_lbo
    from butterfly_tpu_torch.examples import covariance as twin_cov
    from butterfly_tpu_torch.examples import retrieval_lbo as twin
    from butterfly_tpu_torch.geom import icosphere
    from butterfly_tpu_torch.models.covariance import (
        squared_exponential_density,
    )
    from butterfly_tpu_torch.models.lbo import compress_lbo_eigenfunctions
    from butterfly_tpu_torch.models.retrieval import recall_at_k
    from butterfly_tpu_torch.ops.cellsp import K2
    from butterfly_tpu_torch.ops.device_eigs import DeviceEigSession
    from butterfly_tpu_torch.ops.fused_butterfly import K1, pass_plain

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rec = {}
    # ---- (a) config 4 on icosphere(3): the dense device path ------------
    mesh = icosphere(3)
    L, M = mesh.lbo_fem()
    K1.launches = 0
    K2.launches = 0
    ts = time.perf_counter()
    comp = compress_lbo_eigenfunctions(mesh, tol=1e-6, eigensolver="device",
                                       device=dev)
    rec["device_setup_s"] = time.perf_counter() - ts
    require(K1.launches == 0 and K2.launches == 0,
            "the LBO compression launched K1 or K2")
    ts = time.perf_counter()
    comp_h = compress_lbo_eigenfunctions(mesh, tol=1e-6)
    rec["scipy_setup_s"] = time.perf_counter() - ts
    lam = np.sort(sla.eigh(L.toarray(), M.toarray(), eigvals_only=True))
    require(comp.freqs.size == mesh.num_verts,
            f"device branch: {comp.freqs.size} of {mesh.num_verts} pairs")
    # eigenvalues here: sqrt maps the kernel mode's 1e-12 rounding in the
    # host's dense solve to 1e-6 in frequency
    err_dense = float(np.max(np.abs(comp.freqs ** 2 - lam)
                             / (1e-8 + 1e-8 * np.abs(lam))))
    require(err_dense <= 1.0, f"device eigenvalues vs the dense eigensolve: "
            f"{err_dense:.3f} of rtol 1e-8 + atol 1e-8")
    # the scipy branch: every frequency it found is the device branch's
    # (it misses pairs inside a multiplet that its covering probes split)
    j = np.clip(np.searchsorted(comp.freqs, comp_h.freqs), 1,
                comp.freqs.size - 1)
    near = np.where(np.abs(comp.freqs[j] - comp_h.freqs)
                    < np.abs(comp.freqs[j - 1] - comp_h.freqs),
                    comp.freqs[j], comp.freqs[j - 1])
    err_h = float(np.max(np.abs(near - comp_h.freqs)
                         / (1e-6 + 1e-8 * comp_h.freqs)))
    require(err_h <= 1.0, f"device freqs vs the scipy branch: {err_h:.3f} "
            "of rtol 1e-8 + atol 1e-6")
    res = bf_lbo.eigen_residual(mesh, comp)
    require(res <= 1e-5, f"bf_lbo eigen-residual {res:.3e} > 1e-5")
    cov = twin_cov.fast_vs_cheb(mesh, comp, squared_exponential_density(0.1),
                                96)
    # the JAX example `examples/covariance.py --subdiv 3 --tol 1e-6` prints
    # 4.402e-03 (its fast path through the scipy branch's basis)
    require(cov["rel_diff_fast_vs_cheb"] <= 4.402e-3,
            f"covariance fast vs cheb {cov['rel_diff_fast_vs_cheb']:.3e}")
    rec.update(verts=mesh.num_verts, pairs_device=int(comp.freqs.size),
               pairs_scipy=int(comp_h.freqs.size),
               freq_err_vs_dense=err_dense, freq_err_vs_scipy=err_h,
               compression_rate=comp.compression_rate, eigen_residual=res,
               **cov)
    print("[12 lbo] (a) icosphere(3) " + json.dumps(rec), flush=True)

    # ---- (b) the device eigensolver at real size: LOBPCG ----------------
    mesh5 = icosphere(band[0])
    L5, M5 = mesh5.lbo_fem()
    k = band[1]
    ts = time.perf_counter()
    lam_h = np.sort(spla.eigsh(L5, k=k, M=M5, sigma=0.0, which="LM",
                               return_eigenvectors=False))
    eigsh_s = time.perf_counter() - ts
    hi = float(lam_h[-1]) * (1 + 1e-3)
    K1.launches = 0
    K2.launches = 0
    sync()
    ts = time.perf_counter()
    ses = DeviceEigSession(L5, M5, device=dev, chunk=128)
    vals, vecs = ses.next_band(-np.inf, hi)
    sync()
    lobpcg_s = time.perf_counter() - ts
    require(K1.launches == 0 and K2.launches == 0,
            "the device eigensolver launched K1 or K2")
    require(vals.size == k, f"LOBPCG served {vals.size} pairs below "
            f"{hi:.4g}, host eigsh {k}")
    err_b = float(np.max(np.abs(vals - lam_h) / (1e-8 + 1e-8 * lam_h)))
    require(err_b <= 1.0, f"LOBPCG vs eigsh: {err_b:.3f} of rtol 1e-8 + "
            "atol 1e-8")
    rel_b = float(np.max(np.abs(vals - lam_h)[1:] / lam_h[1:]))
    R = L5 @ vecs - (M5 @ vecs) * vals[None, :]
    res_b = float(np.linalg.norm(R, axis=0).max() / max(vals.max(), 1.0))
    require(res_b <= 1e-5, f"LOBPCG residual {res_b:.3e} of the band scale")
    orth = float(np.abs(vecs.T @ (M5 @ vecs) - np.eye(k)).max())
    require(orth <= 1e-6, f"LOBPCG M-orthonormality {orth:.3e}")
    rb = dict(verts=mesh5.num_verts, pairs=k, chunk=128,
              pairs_converged=int(ses._vals.size), host_eigsh_s=eigsh_s,
              lobpcg_s=lobpcg_s, err_vs_eigsh_of_tol=err_b,
              max_rel_err_vs_eigsh_nonzero=rel_b,
              residual_over_scale=res_b, m_orthonormality=orth)
    rec["lobpcg"] = rb
    print(f"[12 lbo] (b) icosphere({band[0]}) " + json.dumps(rb), flush=True)

    # ---- (c) the LBO table through K1 -----------------------------------
    args = twin.parse_args(["--subdiv", str(table[0]), "--num-eigs",
                            str(table[1])])
    Phi, eig_s = twin.lbo_table(*table)
    K1.launches = 0
    K2.launches = 0
    with torch.no_grad():
        rows, fused = twin.run_table(Phi, args, dev)
    sync()
    launches = K1.launches
    require(launches > 0 and K2.launches == 0,
            f"the LBO table launched K1 {launches} and K2 {K2.launches} "
            "times")
    for r in rows:
        r.update(eigsh_s=eig_s)
        print("[12 lbo] (c) " + json.dumps(r), flush=True)
    plan, dist, x = fused["plan"], fused["dist"], fused["x"]
    y, y_plain = plan.apply(x), plan.apply_plain(x)
    err = rel_err(y, y_plain)
    require(err <= 1e-5, f"LBO deep_fused: K1 vs plain {err:.3e}")
    cur = x
    for i, (pm, ws) in enumerate(zip(plan.passes, plan._pass_weights)):
        leafp = plan._leafp if pm.has_leaf else None
        got = K1(pm, plan.radix, cur, leafp, ws)
        err_p = rel_err(got, pass_plain(pm, plan.radix, cur, leafp, ws))
        require(err_p <= 1e-5, f"LBO deep_fused pass {i}: K1 vs plain "
                f"{err_p:.3e}")
        cur = got
    # 512 rows of the scores against the distilled factors in float64
    bf64 = copy.deepcopy(dist.bf).double()
    rows512 = torch.as_tensor(np.sort(np.random.default_rng(12).choice(
        y.shape[0], 512, replace=False)), device=dev)
    y64 = bf64.apply(x.double())
    err64 = rel_err(y.index_select(0, rows512), y64.index_select(0, rows512))
    require(err64 <= 1e-6, f"LBO deep_fused scores vs float64 factors "
            f"{err64:.3e}")
    ids_k1 = dist.row_perm[torch.topk(y.T, 100).indices.cpu().numpy()]
    rec_k1 = recall_at_k(ids_k1, fused["true100"])
    table = torch.as_tensor(fused["table"], device=dev)
    q = x.T.contiguous()
    r = x.shape[1]
    flops = dist.bf.flops_per_col() * r
    b_ms, b_by = bound_ms(flops, dist.bf.nbytes() + nbytes_of(x)
                          + nbytes_of(y), PEAK_F32)
    case = dict(
        shape=f"n={Phi.shape[0]} (padded {table.shape[0]}) d={Phi.shape[1]}"
              f" NB={plan.NB} rank={dist.rank} r={r} float32",
        passes=pass_split(plan),
        ms=1e3 * timer(lambda: plan.apply(x), warmup=2, iters=20),
        plain_ms=1e3 * timer(lambda: plan.apply_plain(x), warmup=1,
                             iters=20),
        library_ms=1e3 * timer(lambda: dist.bf.apply(x), warmup=1,
                               iters=20),
        dense_topk_ms=1e3 * timer(lambda: torch.topk(q @ table.T, 100),
                                  warmup=2, iters=20),
        k1_topk_ms=1e3 * timer(lambda: torch.topk(plan.apply(x).T, 100),
                               warmup=2, iters=20),
        bound_ms=b_ms, bound_by=b_by, flops=flops,
        max_abs_err=float((y.double() - y_plain.double()).abs().max()),
        rel_err_vs_plain=err, rel_err_vs_f64_factors_512_rows=err64,
        recall_at_100_strict_k1=rec_k1,
        recalls={row["format"]: (row["recall_at_100_strict"],
                                 row["recall_at_100_tol1e-3"])
                 for row in rows},
        launches=launches)
    print("[12 lbo] K1 on the LBO table's deep_fused: " + json.dumps(case),
          flush=True)
    rec["native_kits"] = native_kits()
    return case, launches, rec


def native_kits(n_tree: int = 65536, subdiv: int = 7, reps: int = 3):
    """Phase 12 (d), on the host: the native treekit against the NumPy
    builder (the scale twin's ellipse at `n_tree` points, quadtree leaf
    64) and the native meshkit's `lbo_fem` against the NumPy assembly
    (icosphere(`subdiv`)), each built `reps` times in turns (the first
    call builds the library with g++); the trees held equal, the FEM
    matrices to 1e-14."""
    from butterfly_tpu_torch.geom import Ellipse, icosphere
    from butterfly_tpu_torch.trees import PointTree

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    X = Ellipse(1.0, 0.7, (0.0, 0.0), 0.3).sample_linspaced(n_tree)[0]
    mesh = icosphere(subdiv)
    secs = {k: [] for k in ("treekit", "tree_numpy", "meshkit",
                            "lbo_numpy")}
    for _ in range(reps):
        tn, t = timed(lambda: PointTree(X, leaf_size=64))
        secs["treekit"].append(t)
        tp, t = timed(lambda: PointTree(X, leaf_size=64, use_native=False))
        secs["tree_numpy"].append(t)
        (Ln, Mn), t = timed(lambda: mesh.lbo_fem())
        secs["meshkit"].append(t)
        (Lp, Mp), t = timed(lambda: mesh.lbo_fem(use_native=False))
        secs["lbo_numpy"].append(t)
    same = (np.array_equal(tn.perm, tp.perm)
            and [(v.depth, v.i0, v.i1) for v in tn.post_order()]
            == [(v.depth, v.i0, v.i1) for v in tp.post_order()])
    require(same, "treekit and NumPy trees differ")
    lm = max(float(abs(Ln - Lp).max()), float(abs(Mn - Mp).max()))
    require(lm <= 1e-14, f"meshkit lbo_fem vs NumPy {lm:.3e}")
    out = dict(tree_points=n_tree, tree_nodes=sum(1 for _ in
                                                  tn.post_order()),
               mesh_verts=mesh.num_verts, lbo_max_abs_diff=lm,
               **{f"{k}_s": float(np.median(v)) for k, v in secs.items()},
               **{f"{k}_s_all": v for k, v in secs.items()})
    print("[12 lbo] (d) native kits on the host: " + json.dumps(out),
          flush=True)
    return out


def _vf_reference(cent, norm, area, i, j):
    """Scalar float64 transcription of integrateViewFactorMidpointRule
    (src/mat_csr_real.c:387-405), the JAX test's `_reference_view_factor`."""
    if i == j:
        return 0.0
    dp = cent[i] - cent[j]
    dot_src = norm[i] @ dp
    dot_tgt = -norm[j] @ dp
    r2 = dp @ dp
    return area[j] * max(0.0, dot_src) * max(0.0, dot_tgt) / (
        np.pi * r2 * r2)


def _ray_margin(o, d, tris, skip, t_lo=1e-6, t_hi=1.0 - 1e-6):
    """Float64 distance of one ray's hit decision from its boundary: the
    least over the triangles (its skipped faces left out) of |min(u, v,
    1-u-v, t-t_lo, t_hi-t)|, the quantity float32 rounding can flip."""
    o, d = np.asarray(o, np.float64), np.asarray(d, np.float64)
    t0 = tris[:, 0].astype(np.float64)
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    p = np.cross(d, e2)
    det = np.einsum("fk,fk->f", p, e1)
    tv = o - t0
    with np.errstate(divide="ignore", invalid="ignore"):
        u = np.einsum("fk,fk->f", tv, p) / det
        q = np.cross(tv, e1)
        v = (q @ d) / det
        t = np.einsum("fk,fk->f", e2, q) / det
    m = np.abs(np.minimum.reduce([u, v, 1 - u - v, t - t_lo, t_hi - t]))
    keep = np.isfinite(m) & ~np.isin(np.arange(len(tris)), skip)
    return float(m[keep].min())


def culled_pairs(cv, orig, dirs, chunks, ray_chunk: int = 16384) -> dict:
    """Ray-triangle pairs of the culled path over the first `chunks` ray
    chunks: as its tiles test them (candidate and triangle counts padded
    to powers of two), as the candidates need them, and brute force's."""
    from butterfly_tpu_torch.geom.visibility import _pow2_at_least

    tp = _pow2_at_least(cv.group_size, 32)
    padded = exact = brute = 0
    for b0 in range(0, min(len(orig), chunks * ray_chunk), ray_chunk):
        o = torch.as_tensor(orig[b0:b0 + ray_chunk], dtype=torch.float32,
                            device=cv.device)
        d = torch.as_tensor(dirs[b0:b0 + ray_chunk], dtype=torch.float32,
                            device=cv.device)
        counts = cv._candidate_mask(o, d, 1e-6, 1.0 - 1e-6).sum(0).cpu(
            ).numpy()
        live = counts > 0
        padded += int((_pow2_at_least(counts[live], 32) * tp[live]).sum())
        exact += int((counts * cv.group_size).sum())
        brute += len(o) * cv.num_tris
    return dict(padded=padded, exact=exact, brute=brute,
                padded_over_exact=padded / exact,
                brute_over_padded=brute / padded)


def _device_busy(trace: Path) -> tuple[float, float]:
    """(seconds the device was busy, seconds of the whole window) of a
    Chrome trace: the union of its kernel, copy and set intervals, and the
    span of all its complete events."""
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    if not events:
        return 0.0, 0.0
    window = (max(e["ts"] + e.get("dur", 0) for e in events)
              - min(e["ts"] for e in events))
    busy, end = 0.0, -float("inf")
    for t0, t1 in sorted((e["ts"], e["ts"] + e.get("dur", 0))
                         for e in events if e.get("cat") in (
                             "kernel", "gpu_memcpy", "gpu_memset")):
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    return 1e-6 * busy, 1e-6 * window


def radiosity_phase(dev, smi, vis=(16384, 1 << 20), occ_subdiv=3,
                    subdiv=5):
    """Phase 13: radiosity (no kernel: eager torch ops, as the JAX
    package's jitted jnp). (a) visibility on 16,384 random triangles of
    size 0.08 in the unit cube and 2^20 rays (`default_rng(13)`): the
    culled path (`CulledVisibility`, leaf 512) against brute-force
    `ray_hits_any`, both on the card, equal ray for ray, one host read a
    ray chunk; the card against the CPU on 4096 rays, every disagreement
    printed with its float64 margin (failing above 1e-5); both paths
    timed, and the culled path's host share read from the trace of a
    profiled slice (at most a half); (b) `view_factor_matrix` of
    icosphere(3) with occlusion equal to the assembly without (1,637,120
    nonzeros, no pair occluded); (c) the radiosity twin on icosphere(5)
    (20,480 faces, F dense float64 on the card): 4096 sampled entries
    against the scalar formula (1e-12 relative), row sums in [1.00005,
    1.0002], GMRES (rho 0.3, E = e_0, tol 1e-10) in 3-6 iterations,
    fixed-point residual <= 1e-8, B[0] >= 1 and B >= -1e-12. `vis` is
    (triangles, rays) of (a), `occ_subdiv` and `subdiv` the icospheres of
    (b) and (c). Returns the phase's record."""
    from butterfly_tpu_torch.examples import radiosity as twin
    from butterfly_tpu_torch.geom import icosphere
    from butterfly_tpu_torch.geom.visibility import (
        CulledVisibility,
        ray_hits_any,
    )
    from butterfly_tpu_torch.models.radiosity import view_factor_matrix
    from butterfly_tpu_torch.utils.profiling import device_trace

    def clock(fn):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t0

    tag = f"[13 radiosity] ({smi})"
    rec = {}
    # ---- (a) visibility -------------------------------------------------
    rng = np.random.default_rng(13)
    nT, nR = vis
    c = rng.random((nT, 1, 3))
    tris = c + 0.08 * (rng.random((nT, 3, 3)) - 0.5)
    orig = rng.random((nR, 3))
    dirs = rng.random((nR, 3)) - orig
    skip = rng.integers(-1, nT, (nR, 2)).astype(np.int32)
    tris32 = tris.astype(np.float32)

    brute, brute_s = clock(lambda: ray_hits_any(orig, dirs, tris,
                                                skip_idx=skip, device=dev))
    cv, build_s = clock(lambda: CulledVisibility(tris, leaf_size=512,
                                                 device=dev))
    syncs0 = cv.syncs
    culled, culled_s = clock(lambda: cv.ray_hits_any(orig, dirs,
                                                     skip_idx=skip))
    chunks = -(-nR // 16384)
    syncs_per_chunk = (cv.syncs - syncs0) / chunks
    require(syncs_per_chunk == 1, f"culled path: {cv.syncs - syncs0} host "
            f"reads over {chunks} ray chunks")
    pairs = culled_pairs(cv, orig, dirs, chunks)
    bad = np.nonzero(culled != brute)[0]
    for i in bad[:20]:
        print(f"{tag} (a) culled != brute at ray {i}: margin "
              f"{_ray_margin(orig[i], dirs[i], tris32, skip[i]):.3e}")
    require(bad.size == 0, f"culled visibility differs from brute force on "
            f"{bad.size} of {nR} rays")
    # the card against the CPU, 4096 rays
    nS = 4096
    t0 = time.perf_counter()
    on_cpu = ray_hits_any(orig[:nS], dirs[:nS], tris, skip_idx=skip[:nS],
                          device="cpu")
    cpu_s = time.perf_counter() - t0
    flips = np.nonzero(on_cpu != brute[:nS])[0]
    margins = [_ray_margin(orig[i], dirs[i], tris32, skip[i])
               for i in flips]
    for i, m in zip(flips, margins):
        print(f"{tag} (a) card != cpu at ray {i}: card {brute[i]}, margin "
              f"{m:.3e}")
    require(all(m <= 1e-5 for m in margins),
            f"card and CPU disagree on a ray {max(margins, default=0):.3e} from its "
            "boundary")
    # the culled path's host share, on a slice of 4 ray chunks: 1 - the
    # device's busy time (the union of the trace's kernel and copy
    # intervals) over the slice's unprofiled wall time (median of 5). The profiler slows
    # the host's launches, not the kernels, so the share over the profiled
    # window, printed beside it, reads the host higher than it is. (The
    # sum of `key_averages()`' device times, also printed, counts each
    # kernel twice: in its own row and in its op's.)
    nP = 4 * 16384
    slice_all = [clock(lambda: cv.ray_hits_any(orig[:nP], dirs[:nP],
                                               skip_idx=skip[:nP]))[1]
                 for _ in range(5)]
    slice_s = float(np.median(slice_all))  # one host hiccup moves one run
    trace_dir = ROOT / "build" / "trace_phase13"
    with device_trace(str(trace_dir)) as prof:
        cv.ray_hits_any(orig[:nP], dirs[:nP], skip_idx=skip[:nP])
        torch.cuda.synchronize(dev)
    ops = prof.key_averages()
    busy_s, window_s = _device_busy(trace_dir / "trace.json")
    avg_sum_s = 1e-6 * sum(getattr(e, "self_device_time_total", 0)
                           for e in ops)
    # where the host's time goes: torch ops by their own CPU time (the
    # rest of the slice is NumPy and Python: the bucket tables)
    top = sorted(ops, key=lambda e: -e.self_cpu_time_total)[:8]
    host_ops = [(e.key, 1e-3 * e.self_cpu_time_total, e.count) for e in top]
    torch_cpu_s = 1e-6 * sum(e.self_cpu_time_total for e in ops)
    vis = dict(
        triangles=nT, rays=nR, hit_share=float(brute.mean()),
        groups=cv.num_groups, group_pad=cv.group_pad,
        group_sizes=[int(cv.group_size.min()), int(cv.group_size.max())],
        brute_s=brute_s, culled_build_s=build_s, culled_s=culled_s,
        culled_ray_chunks=chunks, culled_host_syncs_per_chunk=syncs_per_chunk,
        culled_pairs=pairs,
        cpu_rays=nS, cpu_s=cpu_s, card_cpu_disagreements=int(flips.size),
        card_cpu_margins=margins, slice_rays=nP, slice_s=slice_s,
        slice_s_all=slice_all,
        slice_profiled_window_s=window_s,
        slice_device_busy_s=busy_s if busy_s > 0 else "not measured",
        slice_host_share=(1 - busy_s / slice_s) if busy_s > 0
        else "not measured",
        slice_host_share_profiled=(1 - busy_s / window_s) if busy_s > 0
        else "not measured",
        slice_key_averages_device_sum_s=avg_sum_s,
        slice_profiled_torch_cpu_s=torch_cpu_s,
        slice_top_torch_ops_cpu_ms_count=host_ops)
    print(f"{tag} (a) visibility: " + json.dumps(vis), flush=True)
    # the culled path runs on the device: the host holds at most half of
    # its time (where the profiler reads the device)
    require(busy_s == 0 or 1 - busy_s / slice_s <= 0.5,
            f"culled path host share {1 - busy_s / slice_s:.3f}")
    rec["visibility"] = vis
    del cv
    # ---- (b) occlusion on a convex mesh ---------------------------------
    m3 = icosphere(occ_subdiv)
    tm = {}
    F_occ = view_factor_matrix(m3, occlusion=True, sparse=False, device=dev,
                               timings=tm)
    F_free = view_factor_matrix(m3, sparse=False, device=dev)
    nnz = int(torch.count_nonzero(F_occ))
    occluded = int(torch.count_nonzero((F_free != 0) & (F_occ == 0)))
    require(torch.equal(F_occ, F_free) and occluded == 0,
            f"icosphere(3): occlusion zeroed {occluded} pairs")
    # on a convex sphere every pair but the self-pair sees the other:
    # 1,637,120 at icosphere(3), as the JAX package reads
    require(nnz == m3.num_faces * (m3.num_faces - 1),
            f"icosphere(3): {nnz} nonzeros")
    occ = dict(faces=m3.num_faces, nnz=nnz, occluded=occluded,
               rays=nnz, assembly_s=tm["assembly_s"],
               visibility_s=tm["visibility_s"])
    print(f"{tag} (b) occlusion on icosphere(3): " + json.dumps(occ),
          flush=True)
    rec["occlusion"] = occ
    del F_occ, F_free
    # ---- (c) icosphere(5) through the twin -----------------------------
    m5 = icosphere(subdiv)
    run = twin.run(m5, rho=0.3, device=dev,
                   log=lambda line: print(f"{tag} (c) {line}", flush=True))
    F, B = run.pop("F"), run.pop("B")
    n = m5.num_faces
    cent, norm, area = (m5.face_centroids(), m5.face_normals(),
                        m5.face_areas())
    ij = np.random.default_rng(5).integers(0, n, (4096, 2))
    got = F[torch.as_tensor(ij[:, 0], device=dev),
            torch.as_tensor(ij[:, 1], device=dev)].cpu().numpy()
    want = np.array([_vf_reference(cent, norm, area, i, j) for i, j in ij])
    zero = want == 0
    require(np.all(got[zero] == 0), "a zero view factor reads nonzero")
    rel = float(np.max(np.abs(got[~zero] - want[~zero]) / want[~zero]))
    require(rel <= 1e-12, f"icosphere(5) sampled F entries {rel:.3e}")
    require(1.00005 <= run["row_sum_min"] and run["row_sum_max"] <= 1.0002,
            f"row sums [{run['row_sum_min']}, {run['row_sum_max']}]")
    require(3 <= run["gmres_iters"] <= 6,
            f"GMRES took {run['gmres_iters']} iterations")
    require(run["fixed_point_residual"] <= 1e-8,
            f"fixed-point residual {run['fixed_point_residual']:.3e}")
    require(float(B[0]) >= 1.0 and float(B.min()) >= -1e-12,
            f"B[0] {float(B[0])}, min B {float(B.min())}")
    run.update(sampled_entries=len(ij), sampled_max_rel_err=rel,
               B0=float(B[0]), B_min=float(B.min()))
    print(f"{tag} (c) icosphere(5): " + json.dumps(run), flush=True)
    rec["icosphere5"] = run
    del F, B
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from butterfly_tpu_torch.config import FacSpec
    from butterfly_tpu_torch.examples import fast_direct_solver, helm2_scale
    from butterfly_tpu_torch.fac import helm2 as fac_helm2
    from butterfly_tpu_torch.fac.partition import partition_apply_plan
    from butterfly_tpu_torch.fac.streamer import FacStreamer
    from butterfly_tpu_torch.fac.uniformize import uniformize_fused
    from butterfly_tpu_torch.geom import Ellipse
    from butterfly_tpu_torch.ops.butterfly import (
        UniformButterfly,
        random_butterfly,
    )
    from butterfly_tpu_torch.ops.cellsp import (
        GK,
        GM,
        K2,
        Cell,
        CellPlan,
        cells_from_dense_block,
    )
    from butterfly_tpu_torch.ops.fused_butterfly import K1, FusedButterflyPlan
    from butterfly_tpu_torch.ops.helm2 import Helm2, LayerPot
    from butterfly_tpu_torch.ops.linalg import solve_gmres_plan
    from butterfly_tpu_torch.trees import Quadtree, uniform_tree
    from butterfly_tpu_torch.utils.nvcc import build_host_library, build_kernel
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
    # one compiler per source, started together: nvcc for the kernels, g++
    # for the native tree and mesh kits
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as ex:
        futs = ([ex.submit(build_kernel, f) for f in ("k1_pass.cu",
                                                      "k2_cell.cu")]
                + [ex.submit(build_host_library, f) for f in ("treekit.cpp",
                                                              "meshkit.cpp")])
        libs, kits = ([f.result() for f in futs[:2]],
                      [f.result() for f in futs[2:]])
    K1.load()
    K2.load()
    build_s = time.perf_counter() - t0
    print(f"[2 build] K1 and K2 built and loaded, the native kits built "
          f"({', '.join(k.name for k in kits)}), in {build_s:.2f} s",
          flush=True)
    for lib in libs:
        entry = ""
        for ln in lib.with_name(lib.name + ".log").read_text().splitlines():
            # ptxas -v: one report per kernel
            if "Compiling entry function" in ln:
                entry = ln.split("'")[1]
            elif "spill" in ln or "Used" in ln:
                print(f"[2 build] {lib.name} {entry}: "
                      f"{ln.split(':')[-1].strip()}")

    # ---- 3. kernel vs plain, small shapes -------------------------------
    def randn(shape, dtype=torch.float32):
        return torch.as_tensor(rng.standard_normal(shape),
                               dtype=torch.float32).to(dev, dtype)

    def ranked_butterfly(NB, ranks, k_in, dtype=torch.float32):
        # leaf (NB, ranks[0], k_in); level l maps ranks[l] -> ranks[l+1]
        leaf = randn((NB, ranks[0], k_in)) / np.sqrt(k_in)
        levels = [randn((NB // 2 ** (l + 1), 2, 2, 2 ** l, ranks[l + 1],
                         ranks[l])) / np.sqrt(2 * ranks[l])
                  for l in range(len(ranks) - 1)]
        return UniformButterfly(leaf, levels, 2).astype(dtype)

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
        ("f32 blocks 128, the leaf in a pass of its own", random_butterfly(
            4, 128, generator=gen(19), device=dev),
         torch.float32, torch.float32, 8, 70),
        ("blocks 384, the leaf alone, three row sweeps", random_butterfly(
            4, 384, generator=gen(7), device=dev),
         torch.float32, torch.float32, 2, 37),
        ("vector r=1", random_butterfly(32, 16, generator=gen(8),
                                        device=dev),
         torch.float32, torch.float32, 3, 1),
        ("f32 w / bf16 act (FFMA on bf16 rows)", random_butterfly(
            16, 32, generator=gen(12), device=dev),
         torch.float32, torch.bfloat16, 2, 40),
        ("FFMA depth 2 (V=1,2), ragged r", random_butterfly(
            32, 16, num_levels=5, generator=gen(13), device=dev),
         torch.float32, torch.float32, 8, 67),
        ("bf16 blocks 160 (64-column tile)", random_butterfly(
            4, 160, generator=gen(9), device=dev),
         torch.bfloat16, torch.bfloat16, 2, 100),
        ("bf16 blocks 320 (32-column tile, two row sweeps)",
         random_butterfly(4, 320, generator=gen(10), device=dev),
         torch.bfloat16, torch.float32, 2, 45),
        ("bf16 vector r=1", random_butterfly(32, 16, generator=gen(11),
                                             device=dev),
         torch.bfloat16, torch.bfloat16, 3, 1),
        ("MMA depth 3 (V=1,2,4), blocks 32", random_butterfly(
            16, 32, generator=gen(14), device=dev),
         torch.bfloat16, torch.bfloat16, 8, 72),
        ("WGMMA blocks 128 with leaf, 3 column tiles", random_butterfly(
            8, 128, generator=gen(15), device=dev),
         torch.bfloat16, torch.bfloat16, 8, 384),
        ("WGMMA blocks 64, ragged tile (r=200)", random_butterfly(
            16, 64, generator=gen(16), device=dev),
         torch.bfloat16, torch.bfloat16, 8, 200),
        ("WGMMA no leaf, r=37 (padded to 40)", random_butterfly(
            8, 128, generator=gen(17), with_leaf=False, device=dev),
         torch.bfloat16, torch.bfloat16, 8, 37),
        ("WGMMA depth 1 without a leaf", random_butterfly(
            2, 128, generator=gen(20), with_leaf=False, device=dev),
         torch.bfloat16, torch.bfloat16, 8, 136),
        ("WGMMA vector r=1", random_butterfly(8, 64, generator=gen(18),
                                              device=dev),
         torch.bfloat16, torch.bfloat16, 8, 1),
        ("WGMMA leaf 128 rows, levels 64", ranked_butterfly(
            16, [128, 64, 64, 64, 64], 64, torch.bfloat16),
         torch.bfloat16, torch.bfloat16, 8, 136),
        ("MMA then WGMMA in one plan (real-fac ranks)", ranked_butterfly(
            32, [64] * 5 + [128], 32, torch.bfloat16),
         torch.bfloat16, torch.bfloat16, 8, 256),
    ]
    for label, bf, wdt, act, fuse, r in cases:
        plan = FusedButterflyPlan(bf.astype(wdt), fuse=fuse, act_dtype=act,
                                  device=dev)
        engines = {p.engine for p in plan.passes}
        words = label.split()
        require(all(e in engines for e, word in (
            ("wgmma", "WGMMA"), ("mma", "MMA")) if word in words),
            f"{label}: the plan's passes are {pass_split(plan)}")
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
              f"{pass_split(plan)} rel err "
              f"{err:.3e} (tol {tol:g})", flush=True)
        require(err <= tol, f"{label}: rel err {err:.3e} > {tol:g}")

    # K2 against cells_plain (IEEE float32 both: only the summation order
    # differs, hence 1e-5)
    def tile(scale=1.0):
        return (rng.standard_normal((GM, GK)) * scale).astype(np.float32)

    def k2_case(label, n_out, buf_rows, cells, r, dev_tiles=None):
        plan = CellPlan(n_out, buf_rows, cells, dev_tiles=dev_tiles,
                        device=dev)
        bufs = [randn((b, r)) for b in buf_rows]
        got = plan.apply(bufs)
        want = plan.apply_plain(bufs)
        torch.cuda.synchronize()
        require(got.shape == (n_out, r) and bool(torch.isfinite(got).all()),
                f"K2 {label}: output {tuple(got.shape)}")
        err = rel_err(got, want)
        print(f"[3 kernel vs plain] K2 {label}: {plan.num_cells} cells, "
              f"{plan.W.shape[0]} weight tiles, r={r}: rel err {err:.3e} "
              f"(tol 1e-05)", flush=True)
        require(err <= 1e-5, f"K2 {label}: rel err {err:.3e} > 1e-05")
        return plan

    cells = []
    for _ in range(6):
        cells_from_dense_block(
            rng.standard_normal((int(rng.integers(16, 180)),
                                 int(rng.integers(16, 180)))) / 8,
            int(rng.integers(0, 220)) * 2, int(rng.integers(0, 156)) * 2,
            cells)
    k2_case("one buffer, dense blocks at even offsets", 640, [512], cells,
            36)
    # two buffers; dst mod 128 in {0, 8, 120}; plain adds, one of them
    # straddling, one reading past the end of its 300-row buffer; a cell
    # whose rows run past n_out; two merged cells
    mixed = [Cell(0, 0, 0, tile()), Cell(8, 0, 1, tile()),
             Cell(120, 1, 0, tile()), Cell(264, 0, 2, tile()),
             Cell(264, 0, 2, tile()), Cell(128, 1, 1, None),
             Cell(376, 1, 2, None), Cell(400 - 64, 0, 3, tile())]
    for r in (1, 36, 1000):
        plan = k2_case("two buffers, plain adds, straddling and merged "
                       "cells", 400, [512, 300], mixed, r)
        require(plan.num_cells == len(mixed) - 1, "K2: cells not merged")
    stack = randn((40, GM, GK)) / 8
    k2_case("device-made tiles after host tiles", 512, [384, 256],
            [Cell(0, 0, 0, tile()), Cell(120, 1, 1, ("dev", 0, 39)),
             Cell(248, 0, 2, ("dev", 0, 0)), Cell(256, 0, 1, ("dev", 1, 2))],
            100, dev_tiles=[stack, stack[:3] * 2])
    # tiles with zero borders, as a partition plan makes them: V tiles of
    # rank 80 (zero rows past 80), U tiles of rank 96 (zero columns past
    # 96), a member window ending inside a tile
    V = np.zeros((3, GM, GK), np.float32)
    V[:, :80] = rng.standard_normal((3, 80, GK)) / 8
    V[2, :, 44:] = 0.0
    U = np.zeros((3, GM, GK), np.float32)
    U[:, :, :96] = rng.standard_normal((3, GM, 96)) / 8
    U[2, 44:] = 0.0
    lr_cells = ([Cell(640, 0, c, ("dev", 0, c)) for c in range(3)]
                + [Cell(256 + 128 * c + 40, 1, 5, ("dev", 1, c))
                   for c in range(3)])
    for r in (1, 200):
        plan = k2_case("rank-80 V tiles, U tiles with zero columns", 768,
                       [512, 768], lr_cells, r,
                       dev_tiles=[torch.from_numpy(V).to(dev),
                                  torch.from_numpy(U).to(dev)])
        require(plan.executed_flops_per_col() < plan.flops_per_col(),
                "K2: the zero borders were not trimmed")
    # a straddling cell whose nonzero rows lie in one tile (one entry), and
    # a tile whose only cell is zero (its entry drops; the tile stores 0)
    top = np.zeros((GM, GK), np.float32)
    top[:64] = tile()[:64]
    bottom = np.zeros((GM, GK), np.float32)
    bottom[70:] = tile()[70:]
    for r in (1, 36):
        plan = k2_case("straddling cells zero in one half, a tile whose "
                       "entries all drop", 512, [384],
                       [Cell(64, 0, 0, top), Cell(192, 0, 1, bottom),
                        Cell(384, 0, 2, np.zeros((GM, GK), np.float32))], r)
        require(plan.num_entries == (5, 2), "K2: entries not trimmed")
    # more than 32768 tiles: byte offsets past 2^31 must not wrap
    big = torch.zeros((33000, GM, GK), device=dev)
    far = list(range(32760, 33000, 7))
    big[far] = randn((len(far), GM, GK)) / 8
    k2_case("weight stack of 33000 tiles (2.16 GB)", 1024, [1024],
            [Cell(int(rng.integers(0, 112)) * 8, 0,
                  int(rng.integers(0, 8)), ("dev", 0, t)) for t in far],
            64, dev_tiles=[big])
    del big, stack

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
        # each launch alone, on its own pass's input
        pass_ms, cur = [], x
        for pm, ws in zip(plan.passes, plan._pass_weights):
            leafp = plan._leafp if pm.has_leaf else None
            pass_ms.append(1e3 * device_time(
                lambda: K1(pm, plan.radix, cur, leafp, ws), warmup=1,
                iters=10))
            cur = K1(pm, plan.radix, cur, leafp, ws)
        del cur
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
            passes=pass_split(plan), ms=ms, pass_ms=pass_ms,
            tflops=flops / ms / 1e9, frac_of_bound=b_ms / ms,
            plain_ms=plain_ms,
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
    print(f"[4 flagship] bf16 rel err vs the f32 kernel: {rel_B:.3e} (the "
          "reference's method gave 5.5e-3 on the TPU); "
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
        passes=pass_split(fp.plan), setup_s=setup_D,
        rel_err_vs_dense=rel_D, ms=ms_D, tflops=flops_D / ms_D / 1e9,
        frac_of_bound=bD_ms / ms_D,
        apply_ms=apply_D, plain_ms=plain_D, library_ms=lib_D,
        bound_ms=bD_ms, bound_by=bD_by,
        max_abs_err=float((yDb.double() - plainDb.double()).abs().max()),
        rel_err_vs_plain=err_D, launches=launches_real)
    print("[5 real fac] " + json.dumps(real), flush=True)
    del fp, xD, yD, yDb, plainDb
    torch.cuda.empty_cache()

    # ---- 6. helm2 partition (bench E), one counted apply ----------------
    nE, rE = 4096, 1024
    ts = time.perf_counter()
    XE, _, NrmE, _ = Ellipse(1.0, 0.7, (0.0, 0.0), 0.3).sample_linspaced(nE)
    treeE = Quadtree(XE, leaf_size=32, normals=NrmE)
    A = fac_helm2.make_multilevel(Helm2(k=60.0, layer_pot=LayerPot.SINGLE),
                                  treeE, treeE)
    fac_s = time.perf_counter() - ts
    ts = time.perf_counter()
    pp = partition_apply_plan(A, device=dev)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - ts
    c1, c2 = pp.cells1, pp.cells2
    require(c1 is not None, "bench E built no low-rank blocks")
    xE = torch.randn((pp.n2, rE), generator=gen(12), device=dev)
    K1.launches = 0
    K2.launches = 0
    yE = pp.apply(xE)
    torch.cuda.synchronize()
    launches_E = K2.launches
    require(launches_E > 0 and K1.launches == 0,
            f"the partition apply launched K2 {launches_E} and K1 "
            f"{K1.launches} times")
    require(yE.shape == (pp.n2, rE) and bool(torch.isfinite(yE).all()),
            "partition output")
    # the counted apply against the plain passes on the same input, and
    # each K2 pass against its plain pass
    err_E = rel_err(yE, pp.apply_plain(xE))
    tK, tP = c1.apply([xE]), c1.apply_plain([xE])
    yK, yP = c2.apply([xE, tK]), c2.apply_plain([xE, tK])
    err_p1, err_p2 = rel_err(tK, tP), rel_err(yK, yP)
    max_abs_E = max(float((tK.double() - tP.double()).abs().max()),
                    float((yK.double() - yP.double()).abs().max()))
    for what, err in (("apply", err_E), ("pass 1", err_p1),
                      ("pass 2", err_p2)):
        require(err <= 1e-5, f"partition {what}: K2 vs plain {err:.3e}")
    # the reference's accuracy clause: bench.py's probe against the
    # operator's own action in float64
    zs = (np.random.default_rng(0).standard_normal((nE, 2))
          + 1j * np.random.default_rng(1).standard_normal((nE, 2)))
    want = A.matmat(zs)

    def rel_vs_op(y):
        y = y.double().cpu().numpy()
        return float(np.linalg.norm(y[0::2] + 1j * y[1::2] - want)
                     / np.linalg.norm(want))

    rel_E = float(np.linalg.norm(pp.apply_complex(zs) - want)
                  / np.linalg.norm(want))
    require(rel_E <= 1e-6, f"partition rel err {rel_E:.3e} > 1e-6")
    xz = np.empty((pp.n2, 2), np.float32)
    xz[0::2], xz[1::2] = zs.real, zs.imag
    xz = torch.from_numpy(xz).to(dev)

    apply_ms = 1e3 * device_time(lambda: pp.apply(xE), warmup=3, iters=20)
    p1_ms = 1e3 * device_time(lambda: c1.apply([xE]), warmup=3, iters=20)
    p2_ms = 1e3 * device_time(lambda: c2.apply([xE, tK]), warmup=3,
                              iters=20)
    plain_ms = 1e3 * device_time(
        lambda: (c1.apply_plain([xE]), c2.apply_plain([xE, tK])), warmup=1,
        iters=20)
    # library: per pass, one torch.bmm over the cells' gathered tiles and
    # one index_add_ (the weight tiles are gathered once, beforehand)
    arange = torch.arange(GM, device=dev)

    def library_pass(c, bufs, Wg, rows):
        r = bufs[0].shape[1]
        tiles = torch.cat([torch.nn.functional.pad(
            b, (0, 0, 0, n - b.shape[0])) for n, b in zip(c.buf_rows_pad,
                                                          bufs)])
        Y = torch.bmm(Wg, tiles.reshape(-1, GK, r).index_select(
            0, c._plain["src0"]))
        y = torch.zeros((c.n_out_pad, r), dtype=Y.dtype, device=dev)
        return y.index_add_(0, rows, Y.reshape(-1, r))[:c.n_out]

    lib_args = []
    for c in (c1, c2):
        require(c._plain["src1"].numel() == 0, "bench E has plain adds")
        lib_args.append((c.W.index_select(0, c._plain["widx0"]),
                         (c._plain["dst0"][:, None] + arange).reshape(-1)))
    err_lib = rel_err(library_pass(c2, [xE, library_pass(c1, [xE],
                                                         *lib_args[0])],
                                   *lib_args[1]), yP)
    library_ms = 1e3 * device_time(
        lambda: library_pass(c2, [xE, library_pass(c1, [xE], *lib_args[0])],
                             *lib_args[1]), warmup=1, iters=20)
    # the accuracy budget: the same float32 plan evaluated in float64, and
    # the plain passes, against the operator
    a64 = [(W.double(), rows) for W, rows in lib_args]
    x64 = xz.double()
    rel_f64 = rel_vs_op(library_pass(
        c2, [x64, library_pass(c1, [x64], *a64[0])], *a64[1]))
    rel_plain = rel_vs_op(pp.apply_plain(xz))
    del lib_args, a64
    # dense: the operator materialized through the plan, 8192 x 8192 f32
    eye = torch.eye(pp.n2, device=dev)
    D = torch.cat([pp.apply(eye[:, j:j + rE].contiguous())
                   for j in range(0, pp.n2, rE)], dim=1)
    del eye
    err_dense = rel_err(D @ xE, yE)
    dense_ms = 1e3 * device_time(lambda: D @ xE, warmup=2, iters=20)
    # the bound counts the useful flops (zero padding of the tiles left
    # out); the padded count, every matmul cell as a full 128x128 product,
    # gives the bound of the work K2 executes
    flops_E = (c1.useful_flops_per_col() + c2.useful_flops_per_col()) * rE
    flops_pad_E = (c1.flops_per_col() + c2.flops_per_col()) * rE
    flops_ex_E = (c1.executed_flops_per_col()
                  + c2.executed_flops_per_col()) * rE
    bytes_E = (c1.nbytes() + c2.nbytes() + nbytes_of(xE) + nbytes_of(tK)
               + nbytes_of(yE))
    bE_ms, bE_by = bound_ms(flops_E, bytes_E, PEAK_F32)
    bE_pad_ms, bE_pad_by = bound_ms(flops_pad_E, bytes_E, PEAK_F32)
    bE_ex_ms, bE_ex_by = bound_ms(flops_ex_E, bytes_E, PEAK_F32)
    # what K2 executes per pass: its tables before and after the trim, the
    # heaviest output tile against the mean (flops per column)
    for i, c in enumerate((c1, c2)):
        print(f"[6 helm2 partition] pass {i + 1}: K2 engine {K2.engine}; "
              f"matmul entries {c.num_entries[0]} before trimming, "
              f"{c.num_entries[1]} after, in {c.num_groups} groups; "
              f"heaviest tile {int(c.tile_work.max())} flops/col against a "
              f"mean of {c.tile_work.mean():.0f}; executed "
              f"{c.executed_flops_per_col()} flops/col (useful "
              f"{c.useful_flops_per_col()}, padded {c.flops_per_col()})",
              flush=True)
    print(f"[6 helm2 partition] K2 bound at 67 TFLOP/s: useful work "
          f"{bE_ms:.4f} ms, executed work {bE_ex_ms:.4f} ms, padded work "
          f"{bE_pad_ms:.4f} ms", flush=True)
    part = dict(
        shape=f"n={nE} k=60 leaf=32 r={rE} float32 (n2={pp.n2})",
        setup_fac_s=fac_s, setup_plan_s=plan_s,
        cells=[c1.num_cells, c2.num_cells],
        matmul_cells=[c1.num_matmul_cells, c2.num_matmul_cells],
        weight_mb=[c1.nbytes() / 1e6, c2.nbytes() / 1e6],
        t_rows=pp.t_rows, lr_classes=pp._lr_meta, oversized=pp.num_oversized,
        flops_per_col=pp.flops_per_col(),
        useful_flops_per_col=pp.useful_flops_per_col(),
        useful_flops_per_col_k2=[c1.useful_flops_per_col(),
                                 c2.useful_flops_per_col()],
        padded_flops_per_col_k2=[c1.flops_per_col(), c2.flops_per_col()],
        executed_flops_per_col_k2=[c1.executed_flops_per_col(),
                                   c2.executed_flops_per_col()],
        entries_k2=[list(c1.num_entries), list(c2.num_entries)],
        groups_k2=[c1.num_groups, c2.num_groups],
        heaviest_tile_k2=[int(c1.tile_work.max()), int(c2.tile_work.max())],
        mean_tile_k2=[float(c1.tile_work.mean()),
                      float(c2.tile_work.mean())],
        engine_k2=K2.engine,
        apply_ms=apply_ms, k2_pass_ms=[p1_ms, p2_ms], ms=p1_ms + p2_ms,
        tflops=pp.flops_per_col() * rE / apply_ms / 1e9,
        useful_tflops=pp.useful_flops_per_col() * rE / apply_ms / 1e9,
        bound_ms=bE_ms, bound_by=bE_by, bound_bytes=bytes_E,
        bound_ms_padded=bE_pad_ms, bound_by_padded=bE_pad_by,
        bound_ms_executed=bE_ex_ms, bound_by_executed=bE_ex_by,
        plain_ms=plain_ms, library_ms=library_ms, dense_ms=dense_ms,
        rel_err_vs_op=rel_E, rel_err_plain_vs_op=rel_plain,
        rel_err_f64_eval_vs_op=rel_f64,
        rel_err_vs_plain=[err_E, err_p1, err_p2],
        rel_err_library_vs_plain=err_lib, rel_err_dense_vs_apply=err_dense,
        max_abs_err=max_abs_E, launches=launches_E)
    print("[6 helm2 partition] " + json.dumps(part), flush=True)
    del pp, c1, c2, xE, yE, tK, tP, yK, yP, D, xz, x64
    torch.cuda.empty_cache()

    # ---- 7. the Helmholtz BIE solve at n=16384 (the scale twin) ---------
    nS, rS = 16384, 64
    prob = helm2_scale.setup(nS, 64.0, 64, device=dev)
    ps = prob.card.plan
    print(f"[7 helm2 scale] n={nS} k={prob.rec['k']}: host fac "
          f"{prob.rec['setup_fac_s']:.2f} s, plan {prob.rec['setup_plan_s']:.2f}"
          f" s, low-rank windows {ps.windows}, weights "
          f"{prob.rec['weights_mb']:.1f} MB, classes {ps._lr_meta}, oversized "
          f"{ps.num_oversized}", flush=True)
    require(ps.cells1 is not None and not ps._mega,
            "the n=16384 plan should hold low-rank classes and no oversized "
            "block")
    require(ps.windows == "device_f64",
            f"the n=16384 plan took its {ps.windows} path")
    # windows factored in float64: every class meets the probe tolerance
    require(all(c["rel"] <= 3e-7 for c in ps._lr_meta),
            f"n=16384 class probe residuals {[c['rel'] for c in ps._lr_meta]}")
    s1, s2 = ps.cells1, ps.cells2
    scale = {}
    for r in (1, rS):
        x = torch.randn((ps.n2, r), generator=gen(20 + r), device=dev)
        # K2 against the plain passes on this plan (not counted)
        y, y_plain = ps.apply(x), ps.apply_plain(x)
        err = rel_err(y, y_plain)
        require(y.shape == (ps.n2, r) and bool(torch.isfinite(y).all()),
                f"scale twin r={r}: output")
        require(err <= 1e-5, f"scale twin r={r}: K2 vs plain {err:.3e}")
        t = s1.apply([x])
        p1 = 1e3 * device_time(lambda: s1.apply([x]), warmup=2, iters=20)
        p2 = 1e3 * device_time(lambda: s2.apply([x, t]), warmup=2, iters=20)
        plain = 1e3 * device_time(
            lambda: (s1.apply_plain([x]), s2.apply_plain([x, t])), warmup=1,
            iters=10)
        nbytes_S = (s1.nbytes() + s2.nbytes() + 2 * nbytes_of(x)
                    + nbytes_of(t))
        b_ms, b_by = bound_ms(ps.useful_flops_per_col() * r, nbytes_S,
                              PEAK_F32)
        scale[r] = dict(
            ms=p1 + p2, k2_pass_ms=[p1, p2], plain_ms=plain, bound_ms=b_ms,
            bound_by=b_by, bound_bytes=nbytes_S,
            useful_flops=ps.useful_flops_per_col() * r,
            executed_flops=(s1.executed_flops_per_col()
                            + s2.executed_flops_per_col()) * r,
            rel_err_vs_plain=err,
            max_abs_err=float((y.double() - y_plain.double()).abs().max()))
        del y, y_plain, t
    # dense: the operator materialized through the plan, n2 x n2 float32
    D = materialize(ps)
    for r in (1, rS):
        x = torch.randn((ps.n2, r), generator=gen(20 + r), device=dev)
        scale[r]["dense_ms"] = 1e3 * device_time(lambda: D @ x, warmup=2,
                                                 iters=20)
        scale[r]["rel_err_dense_vs_apply"] = rel_err(D @ x, ps.apply(x))
        print(f"[7 helm2 scale] K2 r={r}: " + json.dumps(scale[r]),
              flush=True)
    # the same BIE solved through other applies of the same plan (not
    # counted), on the interleaved real embedding with a real Krylov basis
    # and the twin's GMRES settings: the plain passes, the materialized
    # operator in float32, and that operator in float64 with a float64
    # basis. Iterations that differ among them come from float32 rounding,
    # not from the compressed operator.
    b2 = prob.rhs()
    wp2 = prob.card.wp2
    D64 = D.double()
    wp64 = wp2.double()
    diag = {}
    for what, fn, b in (
            ("plain passes", lambda v: 0.5 * v + ps.apply_plain(
                (v * wp2)[:, None])[:, 0], b2),
            ("dense f32", lambda v: 0.5 * v + D @ (v * wp2), b2),
            ("dense f64", lambda v: 0.5 * v + D64 @ (v * wp64),
             b2.double())):
        res = solve_gmres_plan(fn, b, tol=3e-7, restart=80, max_iter=300)
        diag[what] = dict(iters=res.num_iter, converged=res.converged,
                          residuals=res.residuals)
        print(f"[7 helm2 scale] GMRES through the {what}: {res.num_iter} "
              f"iterations, residuals " + " ".join(
                  f"{x:.2e}" for x in res.residuals), flush=True)
    del D, D64
    torch.cuda.empty_cache()
    # the main path: the twin's apply timings, row oracle and GMRES solve
    K1.launches = 0
    K2.launches = 0
    row = helm2_scale.measure(prob, queries=rS)
    torch.cuda.synchronize()
    launches_S = K2.launches
    require(launches_S > 0 and K1.launches == 0,
            f"the scale twin launched K2 {launches_S} and K1 {K1.launches} "
            "times")
    require(row["rel_err_vs_dense"] <= 1e-6,
            f"scale twin row-oracle rel err {row['rel_err_vs_dense']:.3e}")
    require(row["gmres_converged"],
            f"GMRES did not converge: {row['gmres_iters']} iterations, rel "
            f"res {row['gmres_rel_res']:.3e}")
    # float64 windows, factored in float64: below the float32 windows' row
    # oracle (7.987e-7) and iterations (18) on the H100
    require(row["rel_err_vs_dense"] < 7.987e-7 and row["gmres_iters"] <= 18,
            f"scale twin with {row['windows']} windows: row oracle "
            f"{row['rel_err_vs_dense']:.3e}, {row['gmres_iters']} iterations")
    require(row["gmres_k2_launches"] >= 2 * row["gmres_iters"],
            f"GMRES launched K2 {row['gmres_k2_launches']} times in "
            f"{row['gmres_iters']} iterations")
    print("[7 helm2 scale] row: " + json.dumps(row), flush=True)
    print(f"[7 helm2 scale] GMRES through K2: complex64 basis "
          f"{row['gmres_iters']} iterations, "
          f"{row['gmres_ms_per_iter']:.3f} ms an iteration, K2 "
          f"{row['gmres_k2_launches']} launches, residuals " + " ".join(
              f"{x:.2e}" for x in row["gmres_residuals"]), flush=True)
    tpu = next(t for t in json.loads(
        (ROOT / "HELM2_SCALE_r05.json").read_text()) if t.get("n") == nS)
    print(f"[7 helm2 scale] windows {row['windows']}, plan "
          f"{row['setup_plan_s']:.2f} s: {row['gmres_iters']} GMRES "
          f"iterations, row-oracle rel err {row['rel_err_vs_dense']:.3e}; "
          f"with windows from a float32 materialization (H100): 18, 7.987e-7;"
          f" TPU record HELM2_SCALE_r05.json ({tpu['device']}, not this "
          f"card): {tpu['gmres_iters']}, {tpu['rel_err_vs_dense']}",
          flush=True)
    del prob, ps, s1, s2, x
    torch.cuda.empty_cache()

    # ---- 8. the fast direct solver's device substitution ---------------
    nF = 4096
    accF, fds, facF_s = fast_direct_solver.factor_operator(nF)
    rngF = np.random.default_rng(0)
    bF = rngF.standard_normal(nF)
    resF = float(np.linalg.norm(accF.matmat(fds.solve(bF)) - bF)
                 / np.linalg.norm(bF))
    require(resF <= 1e-8, f"fast direct solver host residual {resF:.3e}")
    K1.launches = 0
    K2.launches = 0
    dsolve = fast_direct_solver.run_device(accF, fds, rngF, device=dev)
    torch.cuda.synchronize()
    require(K1.launches == 0 and K2.launches == 0,
            "the device solve launched K1 or K2")
    require(dsolve["rel_vs_host"] <= 5e-4,
            f"device solve vs host {dsolve['rel_vs_host']:.3e} > 5e-4")
    require(dsolve["refined_residual"] <= 1e-8,
            f"refined residual {dsolve['refined_residual']:.3e} > 1e-8")
    dsolve.update(n=nF, host_fac_s=facF_s, host_residual=resF,
                  storage_mb=fds.nbytes() / 1e6, batch=fast_direct_solver.BATCH)
    print("[8 device solve] " + json.dumps(dsolve), flush=True)

    # ---- 9. retrieval -----------------------------------------------------
    k1_retrieval, launches_R = retrieval_phase(dev, device_time)
    torch.cuda.empty_cache()

    # ---- 10. the Helmholtz BIE family -------------------------------------
    bie, launches_B = bie_phase(dev, device_time)

    # ---- 11. the rest of the fac -> device bridge -------------------------
    k1_bridge, launches_F = bridge_phase(dev, device_time)
    torch.cuda.empty_cache()

    # ---- 12. the LBO and covariance workload; the LBO table on K1 ------
    k1_lbo, launches_L, lbo = lbo_phase(dev, device_time)
    torch.cuda.empty_cache()

    # ---- 13. radiosity: view factors, visibility, the solve -------------
    K1.launches = 0
    K2.launches = 0
    rad = radiosity_phase(dev, smi)
    torch.cuda.synchronize()
    require(K1.launches == 0 and K2.launches == 0,
            "the radiosity phase launched K1 or K2")
    torch.cuda.empty_cache()

    # ---- 14. multi-device: gloo ranks sharing the one card ---------------
    # A rank's failure is raised here (`run_ranks`) and ends the script;
    # either way the ranks' forkserver is stopped before the script exits.
    from butterfly_tpu_torch.entry import dryrun_multichip
    from butterfly_tpu_torch.examples import multidevice
    from butterfly_tpu_torch.parallel.launch import stop_rank_servers

    print("[14 multi-device] gloo ranks time-share this one card and stage "
          "their exchanges through the host: not scaling numbers",
          flush=True)
    try:
        md = multidevice.run(dev, ranks=4, stages=2, micro=4, r=256,
                             iters=10)
        launches_M = md["sharded"]["k1_launches"]
        md["sharded"]["phase4_f32_flagship_ms"] = results["flagship f32"][
            "ms"]
        print("[14 multi-device] (a) sharded flagship: "
              + json.dumps(md["sharded"]), flush=True)
        print("[14 multi-device] (b) pipelined flagship: "
              + json.dumps(md["pipelined"]), flush=True)
        t0 = time.perf_counter()
        dry = dryrun_multichip(4, device=dev, backend="gloo")
        dry = {k: v for k, v in dry.items()
               if not isinstance(v, (np.ndarray, list))}
        dry["wall_s"] = time.perf_counter() - t0
        print("[14 multi-device] (c) dryrun_multichip(4): "
              + json.dumps(dry), flush=True)
    finally:
        stop_rank_servers()
    torch.cuda.empty_cache()

    # ---- the record -----------------------------------------------------
    head = results["flagship bf16"]
    kernels = {"kernels": [{
        "name": "k1_pass",
        "route": "cuda",
        "source": "butterfly_tpu_torch/csrc/k1_pass.cu",
        "replaces": "butterfly_tpu/ops/pallas_butterfly.py:132",
        "launches": (launches + launches_R + launches_F + launches_L
                     + launches_M),
        "max_abs_err": head["max_abs_err"],
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "shape": head["shape"],
        "paths": ["4 flagship", "5 real fac", "9 retrieval deep_fused",
                  "11 bridge: fused_apply of distill_butterfly_device and "
                  "distill_butterfly_batch",
                  "12 LBO eigenvector table deep_fused",
                  "14 sharded butterfly (per rank)"],
        "cases": {"flagship f32": results["flagship f32"], "real fac": real,
                  "retrieval deep_fused": k1_retrieval,
                  "bridge fused_apply": k1_bridge,
                  "LBO table deep_fused": k1_lbo,
                  "sharded flagship (4 gloo ranks, one card)": md["sharded"],
                  "pipelined flagship (no kernel)": md["pipelined"],
                  "dryrun_multichip(4) (no kernel)": dry,
                  "LBO and covariance (no kernel)": lbo,
                  "radiosity (no kernel)": rad},
    }, {
        "name": "k2_cell",
        "route": "cuda",
        "source": "butterfly_tpu_torch/csrc/k2_cell.cu",
        "replaces": "butterfly_tpu/ops/cellsp.py:95",
        "launches": launches_E + launches_S + launches_B,
        "max_abs_err": part["max_abs_err"],
        "ms": part["ms"],
        "plain_ms": part["plain_ms"],
        "bound_ms": part["bound_ms"],
        "bound_by": part["bound_by"],
        "library_ms": part["library_ms"],
        "shape": "both cell passes of the helm2 partition apply, "
                 + part["shape"],
        "paths": ["6 helm2 partition", "7 helm2 scale GMRES",
                  "10 helm2_bie GMRES", "10 multiple_scattering GMRES"],
        "cases": {"helm2 partition": part,
                  "helm2 scale r=1 (GMRES)": dict(
                      scale[1], launches=row["gmres_k2_launches"],
                      gmres_iters=row["gmres_iters"]),
                  f"helm2 scale r={rS}": scale[rS],
                  "helm2 scale row": row,
                  "helm2 scale GMRES through other applies": diag,
                  **{f"bie {k}": v for k, v in bie.items()},
                  "device solve (no kernel)": dsolve},
    }]}
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
