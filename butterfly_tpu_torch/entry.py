"""Entry points: twins of the JAX package's `__graft_entry__.py`.

entry():             the flagship forward step (:16-43), butterfly-compressed
                     retrieval scoring + top-k, at the same shapes: a
                     CompressedTable of NB=32 blocks of s=128 rows at rank 32
                     over d=64, scored against q=16 queries, the (n, q)
                     scores run through a random UniformButterfly tower
                     (NB=32, block 128) and the top 100 rows taken per query.
dryrun_multichip(n): (:45-200) n ranks on a ("data", "model") mesh
                     (`parallel.launch.run_ranks`): part 1 takes two sharded
                     training steps of a tiny flagship model (table blocks
                     and butterfly levels over "model", queries over
                     "data"); part 2 streams and distills a real 512 x 256
                     DCT and runs it through `ShardedButterfly`'s one
                     all-to-all, then takes one training step through the
                     exchange.

The weights are normals from a `torch.Generator` (the dryrun's: numpy and
torch generators seeded 0), in place of `jax.random.key`, so they differ
from the JAX package's; the tests carry the same weights into both
packages to compare them.
"""

from __future__ import annotations

import numpy as np
import torch

import torch.distributed as dist
from torch.distributed.tensor import Shard

from butterfly_tpu_torch.config import FacSpec
from butterfly_tpu_torch.fac.distill import distill_butterfly
from butterfly_tpu_torch.fac.streamer import FacStreamer
from butterfly_tpu_torch.models.retrieval import CompressedTable
from butterfly_tpu_torch.ops.butterfly import (
    UniformButterfly,
    random_butterfly,
)
from butterfly_tpu_torch.parallel.launch import A2A, run_ranks
from butterfly_tpu_torch.parallel.sharding import (
    _level_spec,
    data_sharding,
    local_shard,
    make_mesh,
    mesh_axis,
    mesh_shape,
    shard_butterfly,
    shard_table,
)
from butterfly_tpu_torch.parallel.shmap_butterfly import (
    ShardedButterfly,
    unpermute_rows,
)
from butterfly_tpu_torch.trees import uniform_tree
from butterfly_tpu_torch.utils.device import resolve_device
from butterfly_tpu_torch.utils.errors import RuntimeButterflyError, check

__all__ = ["dryrun_fac", "dryrun_multichip", "dryrun_params", "entry",
           "forward"]

NB, S, RANK, D, Q = 32, 128, 32, 64, 16


def forward(ct: CompressedTable, bf: UniformButterfly,
            queries: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Score queries against the compressed table, refine the scores through
    the butterfly tower, return the top-100 (values, ids), (q, 100) each."""
    scores = ct.score(queries)  # (n, q)
    deep = bf.apply(scores)  # (n, q) butterfly tower
    return torch.topk(deep.T, 100)


def entry(device=None):
    """Return (forward, (ct, bf, queries)) on `device` (default: the card)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    ct = CompressedTable(
        (torch.randn((NB, S, RANK), generator=gen) / np.sqrt(RANK)).to(device),
        (torch.randn((NB, RANK, D), generator=gen) / np.sqrt(D)).to(device),
    )
    bf = random_butterfly(NB, S, generator=torch.Generator(
        device=device).manual_seed(0), device=device)
    queries = torch.randn((Q, D), generator=torch.Generator().manual_seed(7)
                          ).to(device)
    return forward, (ct, bf, queries)


# -- dryrun_multichip -------------------------------------------------------


def dryrun_params(n_devices: int, seed: int = 0) -> dict:
    """Part 1's model and data as numpy arrays, at the JAX dryrun's shapes:
    NB = max(8, 2 n_model) blocks (a power of two dividing by n_model) of
    s=16 rows, rank 8, d=32, q = 4 n_data queries; the target (NB s, q)."""
    n_data, n_model = mesh_shape(n_devices)
    NB = max(8, 2 * n_model)
    while NB % n_model or (NB & (NB - 1)):
        NB *= 2
    s, rank, d, q = 16, 8, 32, 4 * n_data
    rng = np.random.default_rng(seed)

    def normal(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    bf = random_butterfly(NB, s, generator=torch.Generator().manual_seed(
        seed), device="cpu")
    return dict(Psi=normal((NB, s, rank), 1 / np.sqrt(rank)),
                V=normal((NB, rank, d), 1 / np.sqrt(d)),
                leaf=bf.leaf.numpy(), levels=[W.numpy() for W in bf.levels],
                queries=normal((q, d), 1.0), target=normal((NB * s, q), 1.0))


def dryrun_fac(n_model: int, seed: int = 3) -> dict:
    """Part 2's operator and data: the 512 x 256 DCT streamed with the JAX
    dryrun's FacSpec and distilled (on the host, float32 weights) to NB >=
    n_model^2 blocks at rank mF/NB + 16; x (mF, 8) and the target."""
    nF, mF = 512, 256
    x1 = (np.arange(nF) + 0.5) / nF
    Phi = np.cos(np.pi * np.outer(x1, np.arange(mF))) * np.sqrt(2.0 / nF)
    spec = FacSpec(row_tree=uniform_tree(nF, 2, 4),
                   col_tree=uniform_tree(mF, 2, 2), row_tree_init_depth=1,
                   tol=1e-9, min_num_rows=8, min_num_cols=8)
    streamer = FacStreamer(spec)
    for leaf in spec.col_tree.nodes_at_depth(2):
        if leaf.num_points:
            streamer.feed(Phi[:, leaf.i0:leaf.i1])
    fac = streamer.get_fac()
    NB = 16
    while NB < n_model * n_model or nF % NB or mF % NB:
        NB *= 2
    dist_bf = distill_butterfly(fac.as_linop(), NB, rank=mF // NB + 16,
                                dtype=torch.float32, device="cpu")
    bf = dist_bf.bf
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((mF, 8)).astype(np.float32)
    target = rng.standard_normal((bf.NB * bf.m_out, 8)).astype(np.float32)
    return dict(Phi=Phi, row_perm=dist_bf.row_perm, rank=dist_bf.rank,
                NB=NB, leaf=bf.leaf.numpy(),
                levels=[W.numpy() for W in bf.levels], x=x, target=target)


def _dryrun_rank(rank: int, world: int, device: torch.device, p1: dict,
                 p2: dict, lr: float = 1e-2, lr_fac: float = 0.1) -> dict:
    """One rank of `dryrun_multichip`: its coordinates, part 1's losses
    and its pieces after the first step, part 2's output rows and losses."""
    mesh = make_mesh(world, device=device)
    _, dc, dgroup = mesh_axis(mesh, "data")
    _, mc, mgroup = mesh_axis(mesh, "model")

    def t(a):
        return torch.as_tensor(a, device=device)

    # ---- part 1: the sharded training step --------------------------------
    ct = shard_table(CompressedTable(t(p1["Psi"]), t(p1["V"])), mesh)
    pb = shard_butterfly(UniformButterfly(
        t(p1["leaf"]), [t(W) for W in p1["levels"]], 2,
        precision="highest"), mesh)
    queries = local_shard(t(p1["queries"]), mesh, data_sharding(mesh))
    # rows over "model", columns over "data"
    target = local_shard(t(p1["target"]), mesh, (Shard(1), Shard(0)))
    count = p1["target"].size
    params = [ct.Psi, ct.V] + [p.requires_grad_() for p in pb.params()]
    replicated = {id(p) for p in pb.replicated_params()}

    def step() -> float:
        for p in params:
            p.grad = None
        deep = pb.apply(ct.score(queries))
        part = ((deep - target) ** 2).sum() / count
        part.backward()
        with torch.no_grad():
            for p in params:
                dist.all_reduce(p.grad, group=dgroup)
                if id(p) in replicated:
                    dist.all_reduce(p.grad, group=mgroup)
                p -= lr * p.grad
            loss = part.detach().clone()
            dist.all_reduce(loss)
        return float(loss)

    def host(ts):  # copies: the next step updates the tensors in place
        return [p.detach().cpu().numpy().copy() for p in ts]

    A2A.reset()
    loss = step()
    out = dict(coord=(dc, mc), loss=loss, a2a_calls=A2A.calls,
               Psi=host([ct.Psi])[0], V=host([ct.V])[0],
               bf=host(pb.params()))
    out["loss2"] = step()

    # ---- part 2: the real fac through the explicit exchange --------------
    sb = ShardedButterfly(UniformButterfly(
        t(p2["leaf"]), [t(W) for W in p2["levels"]], 2,
        precision="highest"), mesh, axis="model")
    rows = p2["x"].shape[0] // sb.D
    x = t(p2["x"])[mc * rows:(mc + 1) * rows]
    rows_out = p2["target"].shape[0] // sb.D
    target = t(p2["target"])[mc * rows_out:(mc + 1) * rows_out]
    with torch.no_grad():
        out["y"] = sb.apply(x).cpu().numpy()
    weights = [p.requires_grad_() for p in sb.params()]

    def fac_loss() -> torch.Tensor:
        return ((sb.apply(x) - target) ** 2).sum() / p2["target"].size

    part = fac_loss()
    part.backward()
    with torch.no_grad():
        for p in weights:
            p -= lr_fac * p.grad
        part2 = fac_loss()
        losses = torch.stack([part.detach(), part2])
        dist.all_reduce(losses, group=mgroup)
    out["fac_loss"], out["fac_loss2"] = losses.tolist()
    out["exchanged"] = sb.exchanged
    return out


def _gather_levels(results: list, n_model: int, shapes: list) -> list:
    """Whole levels from the model ranks' pieces (data coordinate 0)."""
    pieces = sorted((r["coord"][1], r["bf"]) for r in results
                    if r["coord"][0] == 0)
    levels = []
    for l, shape in enumerate(shapes):
        spec = _level_spec(shape, n_model)
        parts = [bf[1 + l] for _, bf in pieces]
        levels.append(np.concatenate(parts, spec.dim)
                      if isinstance(spec, Shard) else parts[0])
    return levels


def dryrun_multichip(n_devices: int, device=None,
                     backend: str = "gloo") -> dict:
    """Run the two-part dryrun on `n_devices` ranks (on the card unless
    `device` names another) and print the JAX function's two lines.

    Part 1 checks the loss is finite and loss2 <= 1.5 loss; part 2 checks
    the sharded apply against the single-device apply (2e-5) and against
    the dense DCT (1e-3), and that the step through the exchange lowers the
    loss. Returns the numbers and part 1's gathered weights after step 1.
    """
    device = resolve_device(device)
    n_data, n_model = mesh_shape(n_devices)
    p1 = dryrun_params(n_devices)
    p2 = dryrun_fac(n_model)
    res = run_ranks(_dryrun_rank, n_devices, device=device, backend=backend,
                    args=(p1, p2))
    r0 = res[0]
    loss, loss2 = r0["loss"], r0["loss2"]
    check(np.isfinite(loss), "non-finite loss in sharded train step",
          RuntimeButterflyError)
    check(loss2 <= loss * 1.5, f"loss rose from {loss} to {loss2}",
          RuntimeButterflyError)
    mesh = {"data": n_data, "model": n_model}
    print(f"dryrun_multichip({n_devices}): mesh={mesh}, "
          f"loss {loss:.5f} -> {loss2:.5f}", flush=True)

    first = [r for r in res if r["coord"][0] == 0]
    first.sort(key=lambda r: r["coord"][1])
    y_sh = np.concatenate([r["y"] for r in first])
    bf = UniformButterfly(
        torch.as_tensor(p2["leaf"], device=device),
        [torch.as_tensor(W, device=device) for W in p2["levels"]], 2,
        precision="highest")
    if r0["exchanged"]:  # low-digit block order -> canonical
        y_sh = unpermute_rows(y_sh, n_model, bf.NB, bf.m_out)
    with torch.no_grad():
        y_1d = bf.apply(torch.as_tensor(p2["x"], device=device)).cpu().numpy()
    rel = float(np.linalg.norm(y_sh - y_1d) / np.linalg.norm(y_1d))
    check(rel < 2e-5, f"exchange apply mismatch: rel {rel:.2e}",
          RuntimeButterflyError)
    y_dense = p2["Phi"][p2["row_perm"]] @ p2["x"]
    rel_d = float(np.linalg.norm(y_sh - y_dense) / np.linalg.norm(y_dense))
    check(rel_d < 1e-3, f"distilled fac inaccurate: rel {rel_d:.2e}",
          RuntimeButterflyError)
    lv, lv2 = r0["fac_loss"], r0["fac_loss2"]
    check(lv2 < lv, f"exchange train step raised the loss: {lv} -> {lv2}",
          RuntimeButterflyError)
    print(f"dryrun_multichip({n_devices}): REAL fac 512x256 distilled "
          f"NB={p2['NB']} rank={p2['rank']}; explicit-exchange apply rel "
          f"{rel:.2e} vs single-device, {rel_d:.2e} vs dense; "
          f"exchange train loss {lv:.5f} -> {lv2:.5f} "
          f"(exchanged={r0['exchanged']})", flush=True)

    table = sorted((r["coord"][1], r["Psi"], r["V"]) for r in first)
    n_tab = p1["Psi"].shape[0]
    whole = n_tab % n_model != 0  # a replicated table
    return dict(
        mesh=mesh, loss=loss, loss2=loss2, a2a_calls=r0["a2a_calls"],
        Psi=table[0][1] if whole else np.concatenate([p for _, p, _ in table]),
        V=table[0][2] if whole else np.concatenate([v for _, _, v in table]),
        leaf=np.concatenate([r["bf"][0] for r in first]),
        levels=_gather_levels(res, n_model,
                              [W.shape for W in p1["levels"]]),
        rel=rel, rel_dense=rel_d, fac_loss=lv, fac_loss2=lv2,
        NB_fac=p2["NB"], rank_fac=p2["rank"])
