"""Where a partition size class's probe residual stops when its windows
are factored in float32 or in float64, and which oversized blocks lose
accuracy in float32, and why.

The scale twin's operator (`helm2_scale.factorize`) is factorized once on
the host per size. Then:

1. the host factorization's own error on the 128-row oracle (`A.matmat`
   against the exact kernel rows, float64): no plan can read below it;
2. the first chunk of size class `--cls`, its member windows multiplied out
   on the host in float64 as the plan's host-chain path does, is factored
   on the device at the plan's starting rank and its doublings, with one
   sketch per rank: in float32 with a float32 probe (the JAX package's
   factoring), in float32 with the probe in float64, in float64, and in
   float64 with U and V rounded to float32 (what K2 applies). The plan's
   escalation (`_escalate`) then runs on the chunk in float64;
3. the plan is compiled and measured by `helm2_scale.measure` (apply, row
   oracle, GMRES) with its plan seconds, peak device memory and its error
   against `A.matmat` (the plan's own share of the row error);
4. each oversized block is packed alone, in float32 and in float64, and
   held against its chain applied on the host in float64 on 8 random
   columns; beside it, the growth of its product, || |F_L|...|F_1| |x| ||
   over || F_L...F_1 x ||, which bounds float32's loss to a multiple of
   its epsilon and which no diagonal rescaling of the factors changes. The
   plan's r=1 apply and its error against `A.matmat` are then read with
   the oversized blocks on one stage plan each, in float32 (the JAX
   package's layout and precision) and in float64, and on the plan's one
   merged float64 stage plan.

Usage:
  python -m butterfly_tpu_torch.examples.partition_floor --sizes 65536

Prints one JSON row per size. Needs the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from butterfly_tpu_torch.examples import helm2_scale
from butterfly_tpu_torch.fac import partition as part
from butterfly_tpu_torch.ops.linop import Scaled
from butterfly_tpu_torch.ops.packed import pack
from butterfly_tpu_torch.utils.device import resolve_device
from butterfly_tpu_torch.utils.oracle import row_oracle_rel_err
from butterfly_tpu_torch.utils.timer import device_time

# the plan's size classes (`PartitionPlan`'s default `bf_tiles`)
TILES = (256, 512, 1024, 2048, 4096)


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def class_probe(fac, cls: int, device, doublings: int = 2) -> dict:
    """Step 2 for the first chunk of class `cls` of `fac`'s operator."""
    _, _, lr_blks, _ = part._split_blocks(fac.A, True, TILES[-1])
    groups = [g for g in part._class_groups(lr_blks, TILES) if g[0] == cls]
    if not groups:
        return {"cls": cls, "members": 0}
    _, members = groups[0]
    with ThreadPoolExecutor(max_workers=part._HOST_WORKERS) as pool:
        Mb = np.stack(list(pool.map(
            lambda b: part._host_window(b, cls, True), members)))
    Z64 = torch.from_numpy(Mb).to(device)
    del Mb
    Z32 = Z64.float()
    rho0 = part._start_rank(members, 2, cls)
    rows, rho = [], rho0
    for _ in range(doublings + 1):
        Om, w = part._sketch(cls, rho, device)
        t0 = time.perf_counter()
        Q, V = part._low_rank(Z32, Om)
        _sync(device)
        t32 = time.perf_counter() - t0
        r32 = part._probe_rel(Z32, Q, V, w)
        r32_64 = part._probe_rel(Z64, Q, V, w)
        del Q, V
        t0 = time.perf_counter()
        Q, V = part._low_rank(Z64, Om)
        _sync(device)
        t64 = time.perf_counter() - t0
        r64 = part._probe_rel(Z64, Q, V, w)
        r64_cast = part._probe_rel(Z64, Q.float(), V.float(), w)
        del Q, V
        rows.append({"rho": rho, "f32": r32, "f32_probe_f64": r32_64,
                     "f64": r64, "f64_cast_f32": r64_cast,
                     "f32_s": t32, "f64_s": t64})
        print(f"  class {cls} rho {rho}: f32 {r32:.3e}, f32 probed in f64 "
              f"{r32_64:.3e}, f64 {r64:.3e}, f64 cast to f32 {r64_cast:.3e}",
              flush=True)
        if rho >= cls // 2:
            break
        rho = min(cls // 2, max(rho * 2, rho + 32))
    _, _, rel, rho_k, steps = part._escalate(Z64, rho0, part._LR_TOL)
    return {"cls": cls, "members": len(members), "rho0": rho0,
            "grid": rows, "escalation_f64": {"rho": rho_k, "rel": rel,
                                             "steps": steps}}


def _abs_apply(chain, xa: np.ndarray) -> np.ndarray:
    """|F_L| ... |F_1| xa for a positioned chain's factors (entrywise
    moduli), on the host in float64."""
    for f in chain.factors:
        y = np.zeros((f.out_dim, xa.shape[1]))
        for u in f.gemms:
            m, k = u.data.shape
            y[u.out_off:u.out_off + m] += np.abs(u.data) @ xa[u.in_off:
                                                              u.in_off + k]
        for u in f.scales:
            np.add.at(y, u.out_idx, np.abs(u.weights)[:, None] * xa[u.in_idx])
        xa = y
    return xa


def oversized_blocks(plan, A, zs: np.ndarray, Az: np.ndarray) -> dict:
    """Step 4 for `plan`, the partition plan of the operator A."""
    device = plan.device
    _, _, _, mega_blks = part._split_blocks(A, True, TILES[-1])
    rng = np.random.default_rng(7)
    blocks, sep = [], {"f32": [], "f64": []}
    for b in mega_blks:
        c = b.chain
        sub = c.src if c.src_scale == 1.0 else Scaled(c.src_scale, c.src)
        nr, nc = sub.shape
        x = rng.standard_normal((nc, 8)) + 1j * rng.standard_normal((nc, 8))
        x = x.astype(np.complex64).astype(np.complex128)
        y = sub.matmat(x)
        xs = torch.from_numpy(np.concatenate([x.real, x.imag]).astype(
            np.float32)).to(device)
        in_idx = torch.as_tensor(np.concatenate(
            [b.j0 + 2 * np.arange(nc), b.j0 + 2 * np.arange(nc) + 1]),
            device=device)
        out_idx = torch.as_tensor(np.concatenate(
            [b.i0 + 2 * np.arange(nr), b.i0 + 2 * np.arange(nr) + 1]),
            device=device)
        rec = {"rows": nr, "cols": nc, "stages": len(c.factors),
               "growth": float(np.linalg.norm(_abs_apply(c, np.abs(x)))
                               / np.linalg.norm(y))}
        for name, dt in (("f32", np.complex64), ("f64", np.complex128)):
            sp = pack(sub, dtype=dt, real_embed=True, block_align=32,
                      device=device)
            ys = sp.apply_stacked(xs).double().cpu().numpy()
            rec[f"err_{name}"] = _rel(ys[:nr] + 1j * ys[nr:], y)
            sep[name].append((sp, in_idx, out_idx))
        blocks.append(rec)
    merged = list(plan._mega)
    out = {}
    gen = torch.Generator(device=device).manual_seed(0)
    x1 = torch.randn((plan.n2, 1), generator=gen, device=device)
    for name, mega in (("separate_f32", sep["f32"]),
                       ("separate_f64", sep["f64"]), ("merged_f64", merged)):
        plan._mega = mega
        ms = (1e3 * device_time(lambda: plan.apply(x1), warmup=2, iters=20)
              if device.type == "cuda" else None)
        out[name] = {"apply_ms_r1": ms,
                     "plan_rel_err_vs_fac": _rel(plan.apply_complex(zs), Az),
                     "weights_mb": sum(sp.stats.weight_bytes
                                       for sp, _, _ in mega) / 1e6,
                     "stage_plans": len(mega)}
    plan._mega = merged
    eps = float(np.finfo(np.float32).eps)
    ratio = [m["err_f32"] / (eps * m["growth"]) for m in blocks]
    return {"blocks": blocks, "variants": out,
            "err_f32_over_eps_growth": [min(ratio), float(np.median(ratio)),
                                        max(ratio)] if ratio else None}


def run_size(n: int, cls: int, device, ppw: float = 64.0,
             leaf: int = 64) -> dict:
    fac = helm2_scale.factorize(n, ppw, leaf)
    row = {"n": n, "k": fac.rec["k"], "setup_fac_s": fac.rec["setup_fac_s"]}

    # (1) the host factorization against the exact rows
    rng = np.random.default_rng(0)
    zs = rng.standard_normal((n, 2)) + 1j * rng.standard_normal((n, 2))
    t0 = time.perf_counter()
    Az = fac.A.matmat(zs)
    row["host_matmat_s"] = time.perf_counter() - t0
    Xp, Np = fac.X[fac.tree.perm], fac.Nrm[fac.tree.perm]

    def exact_rows(rows):
        return fac.helm.kernel_matrix(Xp, Xp[rows], Np, None) @ zs

    row["fac_rel_err_vs_dense"], _ = row_oracle_rel_err(Az, exact_rows, n,
                                                        num_rows=128)
    print(f"n={n}: host fac vs exact rows {row['fac_rel_err_vs_dense']:.3e}",
          flush=True)

    # (2) one class's first chunk in both dtypes
    row["class_probe"] = class_probe(fac, cls, device)

    # (3) the plan, measured
    prob = helm2_scale.compile_plan(fac, device)
    got = prob.card.plan.apply_complex(zs)
    rec = helm2_scale.measure(prob)
    rec["plan_rel_err_vs_fac"] = _rel(got, Az)
    row["plan"] = {key: rec[key] for key in (
        "setup_plan_s", "setup_plan_peak_mb", "weights_mb", "lr_classes",
        "num_mega_blocks", "windows",
        "rel_err_vs_dense", "plan_rel_err_vs_fac", "apply_ms_r1",
        "gmres_iters", "gmres_rel_res", "gmres_converged")}
    print(f"  plan: rel err vs dense {rec['rel_err_vs_dense']:.3e}, vs the "
          f"host fac {rec['plan_rel_err_vs_fac']:.3e}, {rec['gmres_iters']} "
          f"GMRES iterations, plan {rec['setup_plan_s']:.1f} s, peak "
          f"{rec['setup_plan_peak_mb']} MB, {rec['num_mega_blocks']} "
          f"oversized blocks", flush=True)

    # (4) the oversized blocks
    row["oversized"] = ov = oversized_blocks(prob.card.plan, fac.A, zs, Az)
    over = [m for m in ov["blocks"] if m["err_f32"] > 1e-6]
    print(f"  oversized blocks above 1e-6 in float32: {over}", flush=True)
    print(f"  float32 error / (eps32 growth) min, median, max: "
          f"{ov['err_f32_over_eps_growth']}; variants {ov['variants']}",
          flush=True)
    del prob
    row["device"] = (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else str(device))
    return row


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="+", default=[65536])
    ap.add_argument("--cls", type=int, default=4096)
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rows = []
    for n in args.sizes:
        rows.append(run_size(n, args.cls, device))
        print(json.dumps(rows[-1]), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
