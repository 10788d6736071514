"""Partition-aware device apply for multilevel (HODLR-butterfly) operators.

Port counterpart of `butterfly_tpu/fac/partition.py` (`PartitionPlan`,
`partition_apply_plan`).

The reference's multilevel Helmholtz factorization is a recursive partition
(facHelm2MakeMultilevel_rec, src/fac_helm2.c:806-941): dense blocks where
target and source overlap, single butterflies where they are separated.
Its apply walks that recursive graph one tiny zgemv at a time
(src/mat_block_dense.c:574-630). Here, as in the JAX package, the
partition compiles into TWO chained block-sparse cell passes
(ops/cellsp.py, kernel K2):

  pass 1  t = V-cells(x)      compress: every separated block's rank-rho
                              row space, one (128, 128) tile per cell
  pass 2  y = U-cells(t) + dense-cells(x)
                              expand + near-field, two input buffers

Separated blocks are factored as LOW-RANK Z ~= U V on the device: a
randomized sketch Y = Z Omega (a `torch.Generator` seeded 7 in place of
`jax.random.key(7)`), QR, then V solved by least squares
V = (Q^T Q)^{-1} Q^T Z; the per-block residual is measured by an 8-column
random probe and the rank escalated until it meets `_LR_TOL` or stops
falling. The windows, the factoring and the probe are float64; U and V
are cast to float32 for K2. Factored in float32, as the JAX package does,
a class-4096 window of exact rank below 176 read 1.7-2.1e-6 at ranks 176,
352 and 704 (float32 rounding of the sketch, the QR and the 4096-long
probe sums), which the JAX package's escalation takes for a floor; in
float64 it reads 4e-15 at rank 176, 4e-8 once U and V are rounded to
float32. Ranks may differ from the JAX package's, whose random stream
differs; the applies agree.

Blocks wider than the largest size class (oversized) keep their native
butterfly chains, all packed into ONE float64 `StagePlan` whose buckets
batch the units of every block: gather x into its stacked layout, apply,
`index_add_` into y. These chains' products cancel: || |F_L|...|F_1| |x| ||
is 8e3 to 8e8 times || F_L...F_1 x || for the scale twin's combined-field
operator at n=65536, which no diagonal rescaling of the factors changes,
and in float32 each of its 166 blocks lost 1.2e-6 to 9.7e-5 of its
product (`examples/partition_floor.py` measures both). Packed together,
the whole r=1 apply took 19.3 ms on an H100, against 90.4 ms with one
float32 plan a block, whose launches bound it.

What changed for the card:
- the member windows are sliced from the whole operator materialized on
  the device in float64 when it fits (the host-chain path multiplies them
  out in float64 too), and factored in float64:
  by an explicit test against `torch.cuda.mem_get_info()` on the card, by
  the JAX package's 2 GB gather-buffer limit on the CPU
  (`dense_materialize_limit_bytes=0` still forces the host-chain path); a
  failure there raises instead of falling back to the host. The JAX
  package materializes and factors in float32, whose rounding caps the
  plan's accuracy, and at n=16384 took its host-chain path instead;
- no HBM guess from the device kind, no pinning or streaming of oversized
  blocks' weights, no dispatch throttle: the card's 80 GB holds them;
- `apply_with` and jit are gone: `apply(x)` runs eagerly.

Complex operators ride the interleaved 2x2 real embedding throughout
(row/col 2i = Re_i, 2i+1 = Im_i), so a complex chain block at complex
offset (i0, j0) occupies real rows [2*i0, 2*i0+2nr) — contiguity survives.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from butterfly_tpu_torch.fac.distill import stacked_to_interleaved
from butterfly_tpu_torch.fac.uniformize import materialize_on_device
from butterfly_tpu_torch.ops import packed as packed_mod
from butterfly_tpu_torch.ops.butterfly import _f32_precision
from butterfly_tpu_torch.ops.cellsp import (
    GK,
    GM,
    Cell,
    CellPlan,
    cells_from_dense_block,
)
from butterfly_tpu_torch.ops.linop import LinOp
from butterfly_tpu_torch.utils import profiling
from butterfly_tpu_torch.utils.device import resolve_device
from butterfly_tpu_torch.utils.errors import InvalidArgumentsError, check
from butterfly_tpu_torch.utils.logging import log_info

__all__ = ["PartitionPlan", "partition_apply_plan"]

# columns per identity chunk of the float64 device materialization: 128 x 8
# bytes, the gather working set of the JAX package's 256 float32 columns
_MATERIALIZE_CHUNK = 128
# the JAX package's gather-buffer limit, kept where there is no card
_HOST_GATHER_LIMIT_BYTES = 2 << 30
# per-block factorization target: relative probe residual of a class
_LR_TOL = 3e-7
# first rank tried: members' largest unit rank (embedded) plus this margin
_RANK_MARGIN = 32
# device bytes of the float64 member windows factored in one batch
_BATCH_BUDGET_BYTES = 1 << 30
# host threads multiplying member chains out on the host-chain path
_HOST_WORKERS = 2


def _interleave_embed(Z: np.ndarray, dtype=np.float32) -> np.ndarray:
    """(2m, 2k) interleaved real embedding of a complex (m, k) block."""
    m, k = Z.shape
    R = np.empty((2 * m, 2 * k), dtype)
    R[0::2, 0::2] = Z.real
    R[0::2, 1::2] = -Z.imag
    R[1::2, 0::2] = Z.imag
    R[1::2, 1::2] = Z.real
    return R


def _materialize_chain(chain) -> np.ndarray:
    """Dense (nr, nc) matrix of one positioned chain, multiplied out
    UNIT-WISE on the host: each factor's blocks hit only their own row/col
    ranges of the accumulator, so the cost is the chain's true block
    flops."""
    cur = None
    for f in chain.factors:
        dts = [u.data.dtype for u in f.gemms] + [
            u.weights.dtype for u in f.scales]
        dt = np.result_type(*dts) if dts else np.float64
        if cur is None:
            out = np.zeros((f.out_dim, f.in_dim), dt)
            for u in f.gemms:
                d = np.asarray(u.data)
                out[u.out_off:u.out_off + d.shape[0],
                    u.in_off:u.in_off + d.shape[1]] += d
            for u in f.scales:
                # ScaleUnits (Identity/Diag/Perm): scatter-scaled entries
                out[u.out_idx, u.in_idx] += u.weights
        else:
            out = np.zeros((f.out_dim, cur.shape[1]),
                           np.result_type(dt, cur.dtype))
            for u in f.gemms:
                d = np.asarray(u.data)
                out[u.out_off:u.out_off + d.shape[0]] += (
                    d @ cur[u.in_off:u.in_off + d.shape[1]])
            for u in f.scales:
                out[u.out_idx] += u.weights[:, None] * cur[u.in_idx]
        cur = out
    return cur


@dataclasses.dataclass
class _Blk:
    i0: int      # real row offset
    j0: int      # real col offset
    nr: int      # real rows (true)
    nc: int      # real cols (true)
    rmax: int = 0  # max unit rank of the source chain (pre-embedding)
    chain: object = None  # the positioned factor chain (for materialization)

    # the member window is placed so its row start is 8-aligned and its col
    # start is 128-aligned (cell grid); the residual shifts are embedded as
    # leading zero rows/cols of the member matrix
    @property
    def shift_r(self) -> int:
        return self.i0 % 8

    @property
    def shift_c(self) -> int:
        return self.j0 % GK

    @property
    def span(self) -> int:
        return max(self.nr + self.shift_r, self.nc + self.shift_c)


def _size_classes(sizes, tiles):
    """Map each size to the smallest tile >= size (closed list: oversized
    blocks take the per-block stage-plan path instead)."""
    out = []
    for s in sizes:
        for t in tiles:
            if s <= t:
                out.append(t)
                break
        else:
            raise InvalidArgumentsError(
                f"block size {s} exceeds largest tile {tiles[-1]}")
    return out


def _split_blocks(op: LinOp, complex_: bool, max_tile: int):
    """The operator's positioned chains, split into dense blocks (each
    with its embedded float32 weights), low-rank blocks up to `max_tile`
    and oversized blocks, all in interleaved real coordinates."""
    mul = 2 if complex_ else 1
    chains: list = []
    packed_mod._flatten(op, 0, 0, chains)
    dense_blks: list[tuple[_Blk, np.ndarray]] = []
    lr_blks: list[_Blk] = []
    for c in chains:
        nr_c = c.factors[-1].out_dim
        nc_c = c.factors[0].in_dim
        blk = _Blk(mul * c.i0, mul * c.j0, mul * nr_c, mul * nc_c)
        f0 = c.factors[0]
        if (len(c.factors) == 1 and len(f0.gemms) == 1 and not f0.scales
                and f0.gemms[0].in_off == 0 and f0.gemms[0].out_off == 0):
            Z = f0.gemms[0].data
            W = (_interleave_embed(Z) if complex_
                 else np.asarray(Z, np.float32))
            dense_blks.append((blk, W))
        else:
            # unit rank proxy: min dim for GEMMs, entry count for scale
            # units (a ScaleUnit is a scaled sub-permutation, rank = L)
            blk.rmax = max(
                [min(u.data.shape) for f in c.factors for u in f.gemms]
                + [u.weights.size for f in c.factors for u in f.scales]
            )
            blk.chain = c
            lr_blks.append(blk)
    # oversized blocks keep their native butterfly chains, which the plan
    # packs into a stage plan of their own
    mega_blks = [b for b in lr_blks if b.span > max_tile]
    lr_blks = [b for b in lr_blks if b.span <= max_tile]
    return chains, dense_blks, lr_blks, mega_blks


def _class_groups(lr_blks, bf_tiles):
    """[(cls, members)]: the low-rank blocks by size class, each class cut
    into chunks of `_BATCH_BUDGET_BYTES` of float64 windows."""
    keys = _size_classes([b.span for b in lr_blks], bf_tiles)
    groups = []
    for cls in sorted(set(keys)):
        members = [b for b, k in zip(lr_blks, keys) if k == cls]
        gmax = max(1, _BATCH_BUDGET_BYTES // (cls * cls * 8))
        for g0 in range(0, len(members), gmax):
            groups.append((cls, members[g0:g0 + gmax]))
    return groups


def _start_rank(members, mul: int, npad: int) -> int:
    """First rank tried for a chunk: its largest unit rank (embedded) plus
    `_RANK_MARGIN`, in 16s, at most half the window."""
    rmax = max(b.rmax for b in members)
    rho = min(mul * rmax + _RANK_MARGIN, npad // 2)
    return max(16, (rho + 15) // 16 * 16)


def _host_window(b: _Blk, npad: int, complex_: bool) -> np.ndarray:
    """(npad, npad) float64 member window of block b, its chain multiplied
    out on the host in float64 and embedded at the block's shifts."""
    Z = _materialize_chain(b.chain)
    Zr = (_interleave_embed(Z, np.float64) if complex_
          else np.asarray(Z, np.float64))
    Mz = np.zeros((npad, npad), np.float64)
    Mz[b.shift_r:b.shift_r + b.nr, b.shift_c:b.shift_c + b.nc] = Zr
    return Mz


def _slice_batch(M: torch.Tensor, members, npad: int) -> torch.Tensor:
    """(B, npad, npad) float64 member windows of the materialized operator
    M, each masked to its block's true rows and columns (indices past M's
    edge are clamped, then masked)."""
    dev = M.device
    ar = torch.arange(npad, device=dev)
    out = torch.empty((len(members), npad, npad), dtype=torch.float64,
                      device=dev)
    for i, b in enumerate(members):
        ri = (b.i0 - b.shift_r + ar).clamp_(max=M.shape[0] - 1)
        ci = (b.j0 - b.shift_c + ar).clamp_(max=M.shape[1] - 1)
        S = M.index_select(0, ri).index_select(1, ci)
        rok = (ar >= b.shift_r) & (ar < b.shift_r + b.nr)
        cok = (ar >= b.shift_c) & (ar < b.shift_c + b.nc)
        out[i] = torch.where(rok[:, None] & cok[None, :], S, 0.0)
    return out


def _sketch(npad: int, rho: int, device, seed: int = 7):
    """The sketch Omega (npad, rho) and the probe w (npad, 8), drawn in
    float32 from one generator, so that factorings of one window in float32
    and in float64 share them."""
    gen = torch.Generator(device=device).manual_seed(seed)
    Om = torch.randn((npad, rho), generator=gen, device=device)
    w = torch.randn((npad, 8), generator=gen, device=device)
    return Om, w


def _low_rank(Z: torch.Tensor, Om: torch.Tensor):
    """Q (B, npad, rho), V (B, rho, npad) with Z ~= Q V, in Z's dtype. V is
    the least-squares fit against Q, so QR orthogonality error cancels."""
    with _f32_precision("highest"):
        Q, _ = torch.linalg.qr(Z @ Om.to(Z.dtype))
        Qt = Q.transpose(1, 2)
        V = torch.linalg.solve(Qt @ Q, Qt @ Z)
    return Q, V


def _probe_rel(Z, Q, V, w) -> float:
    """max over members of the probe residual ||Z w - Q (V w)|| over the
    largest member's ||Z w||, computed in Z's dtype."""
    with _f32_precision("highest"):
        w = w.to(Z.dtype)
        Zw = Z @ w
        Rw = Zw - Q.to(Z.dtype) @ (V.to(Z.dtype) @ w)
    nrm = Zw.square().sum(dim=(1, 2)).sqrt()
    res = Rw.square().sum(dim=(1, 2)).sqrt()
    return float(res.max() / nrm.max().clamp(min=1e-30))


def _factor_batch(Z: torch.Tensor, rho: int, seed: int = 7):
    """Z: (B, npad, npad) on the device, factored and probed in its own
    dtype. Returns (U, V, rel): U (B, npad, rho), V (B, rho, npad), rel =
    max over members of probe-residual / max member norm."""
    Om, w = _sketch(Z.shape[2], rho, Z.device, seed)
    Q, V = _low_rank(Z, Om)
    return Q, V, _probe_rel(Z, Q, V, w)


def _escalate(Zd: torch.Tensor, rho: int, tol: float):
    """Factor the batch Zd at rank rho, doubling rho until the probe
    residual meets `tol`, reaches half the window, or stops falling (a
    residual above the last one: the smaller rank is then kept). Returns
    (U, V, rel, rho, [(rho, rel), ...])."""
    npad = Zd.shape[2]
    seq, prev = [], None
    while True:
        U, V, rel = _factor_batch(Zd, rho, seed=7)
        seq.append((rho, rel))
        if rel <= tol or rho >= npad // 2:
            break
        if prev is not None and rel > prev[2]:
            U, V, rel, rho = prev
            log_info("partition: class %d rel %.1e stopped falling; keeping "
                     "rho %d", npad, rel, rho)
            break
        prev = (U, V, rel, rho)
        rho_new = min(npad // 2, max(rho * 2, rho + 32))
        log_info("partition: class %d rho %d rel %.1e > %.0e; retrying at "
                 "rho %d", npad, rho, rel, tol, rho_new)
        rho = rho_new
    return U, V, rel, rho, seq


def _tiles(U: torch.Tensor, V: torch.Tensor, rho_pad: int):
    """U (B, npad, rho), V (B, rho, npad) -> float32 (V tiles, U tiles),
    each (n, GM, GK): V tile (b, rr, c) maps x block c of member b to t rows
    rr, U tile (b, rr, c) maps t block c to y rows rr."""
    B, npad, rho = U.shape
    rp, npc = rho_pad // GM, npad // GK
    U, V = U.to(torch.float32), V.to(torch.float32)
    Vp = torch.nn.functional.pad(V, (0, 0, 0, rho_pad - rho))
    Vt = Vp.reshape(B, rp, GM, npc, GK).permute(0, 1, 3, 2, 4)
    Up = torch.nn.functional.pad(U, (0, rho_pad - rho))
    Ut = Up.reshape(B, npc, GM, rp, GK).permute(0, 1, 3, 2, 4)
    return Vt.reshape(-1, GM, GK), Ut.reshape(-1, GM, GK)


class PartitionPlan:
    """Executable partition apply on `device` (default: the card).
    `apply(x)` takes interleaved real (n2, r) float32 in tree order;
    `apply_complex(Z)` takes and returns complex numpy arrays."""

    def __init__(self, op: LinOp,
                 bf_tiles=(256, 512, 1024, 2048, 4096),
                 dense_materialize_limit_bytes: int = 16 << 30,
                 device=None):
        device = resolve_device(device)
        self.device = device
        self._complex = bool(np.issubdtype(op.dtype, np.complexfloating))
        mul = 2 if self._complex else 1
        n_c, m_c = op.shape
        self.shape = (n_c, m_c)
        self.n2, self.m2 = n_c * mul, m_c * mul

        chains, dense_blks, lr_blks, mega_blks = _split_blocks(
            op, self._complex, bf_tiles[-1])
        log_info("partition: %d dense blocks, %d low-rank blocks, %d "
                 "oversized", len(dense_blks), len(lr_blks), len(mega_blks))

        self._flops = 0
        self._useful_flops = 0
        self._nbytes = 0
        cells1: list[Cell] = []   # pass 1: x -> t  (V cells)
        cells2: list[Cell] = []   # pass 2: [x, t] -> y  (dense + U cells)

        # ---- dense cells ------------------------------------------------
        for blk, Wb in dense_blks:
            cells_from_dense_block(Wb, blk.i0, blk.j0, cells2)
        n_dense_cells = len(cells2)

        # ---- low-rank classes: device sketch factorization --------------
        self._lr_meta = []
        self.windows = None   # where the low-rank member windows came from
        t_off = 0          # running row offset into the t buffer
        max_win_end = self.n2
        dev_tiles1: list = []   # V tile stacks (device)
        dev_tiles2: list = []   # U tile stacks (device)
        if lr_blks:
            groups = _class_groups(lr_blks, bf_tiles)

            # fast path: materialize the WHOLE operator on the device
            # once, in float64, and slice member windows from it; the host
            # chain materialization (float64 too) is the slow path
            M = None
            if self._materialize_fits(op, chains, mul,
                                      dense_materialize_limit_bytes):
                plan_p = packed_mod.pack(
                    op, dtype=np.complex128 if self._complex else np.float64,
                    block_align=64, real_embed=self._complex, device=device)
                M = materialize_on_device(plan_p, chunk=_MATERIALIZE_CHUNK)
                del plan_p
                if self._complex:
                    M = stacked_to_interleaved(M)
            self.windows = "device_f64" if M is not None else "host_chains"
            log_info("partition: member windows %s",
                     "sliced from the operator materialized on the device "
                     "in float64" if M is not None
                     else "multiplied out on the host in float64")

            cls_state: dict = {}  # cls -> (rho_star, rel_floor) memo so
            # later chunks of a class skip the escalation
            with ThreadPoolExecutor(max_workers=_HOST_WORKERS) as pool:
                for cls, members in groups:
                    npad = cls
                    if M is not None:
                        Zd = _slice_batch(M, members, npad)
                    else:
                        Mb = np.stack(list(pool.map(
                            lambda b: _host_window(b, npad, self._complex),
                            members)))
                        Zd = torch.from_numpy(Mb).to(device)

                    tol_eff = _LR_TOL
                    rho = _start_rank(members, mul, npad)
                    if cls in cls_state:
                        rho = max(rho, cls_state[cls][0])
                        tol_eff = max(_LR_TOL, 1.5 * cls_state[cls][1])
                    U, V, rel, rho, steps = _escalate(Zd, rho, tol_eff)
                    st_ = cls_state.get(cls, (0, 0.0))
                    cls_state[cls] = (max(st_[0], rho), max(st_[1], rel))
                    del Zd

                    # U/V stay on the device, retiled into (ntiles, GM, GK)
                    # stacks that CellPlan appends to its weight stack
                    rho_pad = -(-rho // GK) * GK
                    rp, npc = rho_pad // GM, npad // GK
                    Vt, Ut = _tiles(U, V, rho_pad)
                    del U, V
                    sid1, sid2 = len(dev_tiles1), len(dev_tiles2)
                    dev_tiles1.append(Vt)
                    dev_tiles2.append(Ut)

                    for bi, b in enumerate(members):
                        i0a = b.i0 - b.shift_r
                        j0a = b.j0 - b.shift_c
                        max_win_end = max(max_win_end, j0a + npad)
                        # V cells: t[t_off : +rho] += V_b @ x[j0a : +npad]
                        for rr in range(rp):
                            for ccx in range(npc):
                                cells1.append(Cell(
                                    dst=t_off + rr * GM, src_buf=0,
                                    src_blk=j0a // GK + ccx,
                                    w=("dev", sid1,
                                       (bi * rp + rr) * npc + ccx)))
                        # U cells: y[i0a : +npad] += U_b @ t[t_off : +rho]
                        for rr in range(npc):
                            for cct in range(rp):
                                cells2.append(Cell(
                                    dst=i0a + rr * GM, src_buf=1,
                                    src_blk=t_off // GK + cct,
                                    w=("dev", sid2,
                                       (bi * npc + rr) * rp + cct)))
                        t_off += rho_pad
                    self._lr_meta.append(
                        {"cls": cls, "B": len(members), "rho": rho,
                         "rel": rel, "steps": steps})
                    log_info("partition: lr class %d x%d rho=%d rel=%.2e",
                             cls, len(members), rho, rel)
            del M
        self.t_rows = max(t_off, GK)

        # ---- the two cell passes ----------------------------------------
        buf0_rows = max(self.n2, max_win_end)
        self.cells1 = None
        if cells1:
            self.cells1 = CellPlan(self.t_rows, [buf0_rows], cells1,
                                   dev_tiles=dev_tiles1, device=device)
            self._flops += self.cells1.flops_per_col()
            self._useful_flops += self.cells1.useful_flops_per_col()
            self._nbytes += self.cells1.nbytes()
        if not cells2:
            cells2.append(Cell(dst=0, src_buf=0, src_blk=0,
                               w=np.zeros((GM, GK), np.float32)))
        self.cells2 = CellPlan(self.n2, [buf0_rows, self.t_rows], cells2,
                               dev_tiles=dev_tiles2, device=device)
        self._flops += self.cells2.flops_per_col()
        self._useful_flops += self.cells2.useful_flops_per_col()
        self._nbytes += self.cells2.nbytes()
        log_info("partition: pass1 %d cells, pass2 %d cells (%d dense), "
                 "t rows %d, weights %.0f MB",
                 len(cells1), len(cells2), n_dense_cells, self.t_rows,
                 self._nbytes / 1e6)

        # ---- oversized butterfly blocks: ONE float64 stage plan ---------
        # all their chains packed together, so that its buckets batch the
        # units of every block; it reads x and writes y in its stacked
        # [Re; Im] layout
        self.num_oversized = len(mega_blks)
        self._mega = []
        if mega_blks:
            # block_align 32: oversized chains have ragged ranks ~20-80
            sp = packed_mod.pack(
                op, dtype=np.complex128 if self._complex else np.float64,
                real_embed=self._complex, block_align=32, device=device,
                chains=[b.chain for b in mega_blks])
            in_idx = torch.cat([torch.arange(k, self.m2, mul, device=device)
                                for k in range(mul)])
            out_idx = torch.cat([torch.arange(k, self.n2, mul, device=device)
                                 for k in range(mul)])
            self._mega.append((sp, in_idx, out_idx))
            self._flops += sp.stats.padded_flops_per_col
            self._useful_flops += sp.stats.useful_flops_per_col
            self._nbytes += sp.stats.weight_bytes

    def _materialize_fits(self, op: LinOp, chains, mul: int,
                          limit_bytes: int) -> bool:
        """Whether the whole operator is materialized on the device, in
        float64 (8-byte words throughout). The packed plan that builds it
        stages about one row per unit input for each identity chunk; on the
        card that working set, the plan's weights (each complex entry four
        real words) and the dense matrix (twice: stacked, then interleaved)
        must fit in the free memory, elsewhere the gather buffer must stay
        under the JAX package's 2 GB limit."""
        dense = self.n2 * self.m2 * 8
        if dense > limit_bytes:
            return False
        gather = (mul * sum(f.in_dim for c in chains for f in c.factors)
                  * _MATERIALIZE_CHUNK * 8)
        if self.device.type != "cuda":
            return gather <= _HOST_GATHER_LIMIT_BYTES
        weights = op.nbytes() // np.dtype(op.dtype).itemsize * mul * mul * 8
        free, _ = torch.cuda.mem_get_info(self.device)
        return 3 * gather + 2 * dense + 2 * weights <= free

    # -- application -----------------------------------------------------

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """x: (n2, r) float32 interleaved real, TREE index order, on the
        plan's device. Returns (n2, r): the two cell passes (K2 on the
        card, `cells_plain` on the CPU) plus each oversized block's own
        stage plan. Traced as `plan.apply` (`utils.profiling`)."""
        with profiling.span("plan.apply"):
            return self._run(x, plain=False)

    def apply_plain(self, x: torch.Tensor) -> torch.Tensor:
        """The same apply with both cell passes through `cells_plain`, on
        any device: K2's reference on the card."""
        return self._run(x, plain=True)

    def _run(self, x: torch.Tensor, plain: bool) -> torch.Tensor:
        check(x.ndim == 2 and x.shape[0] == self.n2,
              f"operand of shape {tuple(x.shape)}, expected ({self.n2}, r)",
              InvalidArgumentsError)
        check(x.device == self.device,
              f"operand on {x.device}, plan on {self.device}",
              InvalidArgumentsError)
        x = x.to(torch.float32).contiguous()

        def cells(plan, bufs):
            return plan.apply_plain(bufs) if plain else plan.apply(bufs)

        if self.cells1 is not None:
            t = cells(self.cells1, [x])
        else:
            t = torch.zeros((self.t_rows, x.shape[1]), dtype=torch.float32,
                            device=x.device)
        y = cells(self.cells2, [x, t])
        for sp, in_idx, out_idx in self._mega:
            xs = x.index_select(0, in_idx)
            ys = sp.apply_stacked(xs) if sp.real_embed else sp(xs)
            y.index_add_(0, out_idx, ys.to(y.dtype))
        return y

    def apply_complex(self, Z) -> np.ndarray:
        """Complex (n, r) numpy in, complex128 (n, r) numpy out."""
        Z = np.asarray(Z)
        x = np.empty((2 * Z.shape[0], Z.shape[1]), np.float32)
        x[0::2], x[1::2] = Z.real, Z.imag
        y = self.apply(torch.from_numpy(x).to(self.device))
        y = y.double().cpu().numpy()
        return y[0::2] + 1j * y[1::2]

    def flops_per_col(self) -> int:
        """Executed (padded) flops per RHS column of the device program."""
        return self._flops

    def useful_flops_per_col(self) -> int:
        """Flops per RHS column without the plan's zero padding (rank
        padding to whole tiles, block edges inside tiles)."""
        return self._useful_flops

    def nbytes(self) -> int:
        return self._nbytes


def partition_apply_plan(op: LinOp, **kw) -> PartitionPlan:
    """Compile a multilevel partition operator (e.g. fac/helm2.py
    make_multilevel output) into its batched device apply. Each low-rank
    class's rank is chosen adaptively, as the JAX package's `rank=None`."""
    return PartitionPlan(op, **kw)
