"""The flagship butterfly over ranks that share one card.

    python -m butterfly_tpu_torch.examples.multidevice [--ranks 4]
        [--stages 2] [--micro 4] [--r 256] [--iters 10]

Bench A's f32 butterfly (NB=1024 blocks of 128 rows, the leaf and 10
levels; drawn in bf16 from a card generator seeded 7, then cast to f32,
as `chip_smoke.py` phase 4 draws it) at r=256 columns (seeded 9), run two
ways on gloo ranks (`parallel.launch.run_ranks`), each rank building the
same weights from the seed:

  (a) `ShardedButterfly` on a ("model",) mesh of `--ranks`: each rank runs
      the leaf and its local levels on K1 over NB/D blocks, then the one
      all-to-all, then the top levels. Held against the single-process
      `FusedButterflyPlan` apply of the whole butterfly (1e-5 relative) and
      each rank's K1 passes against their plain passes (1e-5); the
      exchange's volume against `expected_exchange_elems`.
  (b) `PipelinedButterfly` on `--stages` ranks with `--micro`
      microbatches, held against the single-process `bf.apply` (1e-5).

The ranks time-share one card's SMs and gloo stages the exchange through
the host, so the times are those of that arrangement, not scaling numbers.
It needs a card (the times are CUDA-event and host-clock times on it).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from butterfly_tpu_torch.ops.butterfly import (
    UniformButterfly,
    random_butterfly,
)
from butterfly_tpu_torch.ops.fused_butterfly import K1, FusedButterflyPlan
from butterfly_tpu_torch.parallel.launch import (
    A2A,
    run_ranks,
    stop_rank_servers,
)
from butterfly_tpu_torch.parallel.pipeline import (
    PipelinedButterfly,
    make_stage_mesh,
)
from butterfly_tpu_torch.parallel.shmap_butterfly import (
    ShardedButterfly,
    unpermute_rows,
)
from butterfly_tpu_torch.utils.device import resolve_device
from butterfly_tpu_torch.utils.errors import RuntimeButterflyError, check
from butterfly_tpu_torch.utils.timer import device_time

NB, BLOCK = 1024, 128
TOL = 1e-5
# Data-sheet peaks of one H100 SXM (dense, at 700 W).
PEAK_F32 = 67e12         # FLOP/s, float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def flagship(device) -> UniformButterfly:
    """Bench A's f32 butterfly, the weights of `chip_smoke.py` phase 4."""
    bf16 = random_butterfly(NB, BLOCK, dtype=torch.bfloat16, device=device,
                            generator=torch.Generator(device).manual_seed(7))
    return bf16.astype(torch.float32)


def flagship_x(device, r: int) -> torch.Tensor:
    return torch.randn((NB * BLOCK, r), device=device,
                       generator=torch.Generator(device).manual_seed(9))


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


def _host_ms(fn, group, iters: int) -> float:
    """Median host-clock ms of `fn`, every rank of `group` starting it
    together and the card synchronised at both ends."""
    times = []
    for _ in range(iters + 1):
        dist.barrier(group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    times = sorted(times[1:])
    return times[len(times) // 2]


def sharded_rank(rank: int, world: int, device, r: int, iters: int) -> dict:
    """(a) on one rank: the counted apply, K1 against its plain passes, and
    the stage times. Returns this rank's output rows with the numbers."""
    mesh = init_device_mesh(device.type, (world,),
                            mesh_dim_names=("model",))
    sb = ShardedButterfly(flagship(device), mesh, use_kernel=True)
    rows = NB * BLOCK // world
    x = flagship_x(device, r)[rank * rows:(rank + 1) * rows].contiguous()
    torch.cuda.empty_cache()
    dist.barrier(sb.group)
    K1.launches = 0
    A2A.reset()
    y = sb.apply(x)
    torch.cuda.synchronize()
    out = dict(launches=K1.launches, a2a_calls=A2A.calls,
               a2a_elems=A2A.elems, y=y.cpu().numpy(),
               expected=sb.expected_exchange_elems(r),
               passes=[(p.k, p.r_tile, p.engine) for p in sb.plan.passes])
    local = sb.local_stage(x)
    plain = sb.plan.apply_plain(x).reshape(local.shape)
    out["rel_vs_plain"] = _rel(local, plain)
    out["max_abs_err"] = float((local.double() - plain.double()).abs().max())
    dist.barrier(sb.group)
    out["local_ms"] = 1e3 * device_time(lambda: sb.local_stage(x), warmup=2,
                                        iters=iters)
    dist.barrier(sb.group)
    out["plain_ms"] = 1e3 * device_time(lambda: sb.plan.apply_plain(x),
                                        warmup=1, iters=iters)
    # the same local stage as one library call a level (einsum), and its
    # bound: useful flops over the f32 peak, or each weight, input and
    # output byte once over the HBM rate
    local_bf = UniformButterfly(sb.leaf, sb.w1, sb.R)
    dist.barrier(sb.group)
    out["library_ms"] = 1e3 * device_time(lambda: local_bf.apply(x),
                                          warmup=1, iters=iters)
    nbytes = local_bf.nbytes() + 4 * (x.numel() + local.numel())
    t_ops = local_bf.flops_per_col() * r / PEAK_F32
    t_bytes = nbytes / HBM_BYTES_PER_S
    out["bound_ms"] = 1e3 * max(t_ops, t_bytes)
    out["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    out["exchange_ms"] = _host_ms(lambda: sb.exchange(local), sb.group,
                                  iters)
    mid = sb.exchange(local)
    dist.barrier(sb.group)
    out["top_ms"] = 1e3 * device_time(lambda: sb.top_stage(mid), warmup=1,
                                      iters=iters)
    out["apply_ms"] = _host_ms(lambda: sb.apply(x), sb.group, iters)
    return out


def pipelined_rank(rank: int, world: int, device, r: int, num_micro: int,
                   iters: int) -> dict | None:
    """(b) on one rank: the pipelined apply, timed; stage 0 returns the
    output."""
    mesh = make_stage_mesh(world, device=device)
    pipe = PipelinedButterfly(flagship(device), mesh, num_micro=num_micro)
    x = flagship_x(device, r)
    torch.cuda.empty_cache()
    A2A.reset()
    y = pipe.apply(x)
    torch.cuda.synchronize()
    out = dict(rotations=A2A.calls,
               message_bytes=A2A.elems // max(A2A.calls, 1) * 4,
               stage_weight_bytes=pipe.weights.numel() * 4,
               ms=_host_ms(lambda: pipe.apply(x), pipe.group, iters))
    if rank == 0:
        out["y"] = y.cpu().numpy()
    return out


def run(device=None, ranks: int = 4, stages: int = 2, micro: int = 4,
        r: int = 256, iters: int = 10, backend: str = "gloo") -> dict:
    """(a) and (b) with their checks; returns their numbers (raises on a
    failed check)."""
    device = resolve_device(device)
    check(device.type == "cuda", "the multi-device flagship times the card",
          RuntimeButterflyError)
    K1.load()  # build once here, not in every rank at once
    t0 = time.perf_counter()
    res = run_ranks(sharded_rank, ranks, device=device, backend=backend,
                    args=(r, iters))
    wall_a = time.perf_counter() - t0
    bf = flagship(device)
    x = flagship_x(device, r)
    want = FusedButterflyPlan(bf, fuse=8, device=device).apply(x)
    y = torch.as_tensor(np.concatenate([q.pop("y") for q in res]),
                        device=device)
    yb = unpermute_rows(y, ranks, NB, BLOCK)  # from low-digit block order
    rel = _rel(yb, want)
    moved = sum(q["a2a_elems"] for q in res) * (ranks - 1) // ranks
    sharded = dict(
        ranks=ranks, r=r, rel_vs_single_process=rel,
        bit_equal=bool(torch.equal(yb, want)),
        k1_launches=sum(q["launches"] for q in res),
        k1_rel_vs_plain=max(q["rel_vs_plain"] for q in res),
        max_abs_err=max(q["max_abs_err"] for q in res),
        exchange_elems=moved, expected_exchange_elems=res[0]["expected"],
        a2a_calls=[q["a2a_calls"] for q in res],
        passes_per_rank=res[0]["passes"],
        exchange_gb_s=moved * 4 / 1e9 / (max(q["exchange_ms"] for q in res)
                                         / 1e3),
        wall_s=wall_a,
        bound_ms=res[0]["bound_ms"], bound_by=res[0]["bound_by"],
        **{k: [q[k] for q in res] for k in ("local_ms", "plain_ms",
                                            "library_ms", "exchange_ms",
                                            "top_ms", "apply_ms")})
    check(rel <= TOL, f"sharded flagship vs single process {rel:.3e}",
          RuntimeButterflyError)
    check(sharded["k1_rel_vs_plain"] <= TOL,
          f"sharded flagship: K1 vs plain {sharded['k1_rel_vs_plain']:.3e}",
          RuntimeButterflyError)
    check(moved == sharded["expected_exchange_elems"]
          and all(c == 1 for c in sharded["a2a_calls"]),
          f"exchange moved {moved} elements in {sharded['a2a_calls']} "
          f"calls, expected {sharded['expected_exchange_elems']} in one",
          RuntimeButterflyError)
    check(sharded["k1_launches"] > 0, "the sharded apply launched no K1",
          RuntimeButterflyError)
    del y, yb, want

    t0 = time.perf_counter()
    res = run_ranks(pipelined_rank, stages, device=device, backend=backend,
                    args=(r, micro, iters))
    wall_b = time.perf_counter() - t0
    with torch.no_grad():
        want = bf.apply(x)
    y = torch.as_tensor(res[0].pop("y"), device=device)
    rel_p = _rel(y, want)
    T = micro + stages - 1
    pipelined = dict(
        stages=stages, micro=micro, r=r, steps=T,
        bubble_share=(stages - 1) / T, rel_vs_single_process=rel_p,
        rotations=res[0]["rotations"], message_bytes=res[0]["message_bytes"],
        stage_weight_bytes=res[0]["stage_weight_bytes"],
        ms=[q["ms"] for q in res], wall_s=wall_b)
    check(rel_p <= TOL, f"pipelined flagship vs single process {rel_p:.3e}",
          RuntimeButterflyError)
    return dict(sharded=sharded, pipelined=pipelined)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--stages", type=int, default=2)
    ap.add_argument("--micro", type=int, default=4)
    ap.add_argument("--r", type=int, default=256)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        rec = run(ranks=args.ranks, stages=args.stages, micro=args.micro,
                  r=args.r, iters=args.iters)
    finally:
        stop_rank_servers()
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
