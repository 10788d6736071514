"""Fused multi-level butterfly apply on the K1 CUDA kernel.

Port counterpart of `butterfly_tpu/ops/pallas_butterfly.py`
(`FusedButterflyPlan`; the Pallas kernel `_pass_kernel`, :132-172).

A pass over levels [l0, l0+k) splits the NB block rows into groups of R^k
blocks that mix only among themselves across those k levels. The kernel K1
(`csrc/k1_pass.cu`) applies one pass: it reads each group's activation tile
once, applies the k levels (and, on pass 0, the block-diagonal leaf) out of
shared memory, and writes the tile back, so activation traffic is
2·ceil(L/k) sweeps instead of 2·L while every weight is read once.

What differs from the TPU design. A TPU pass holds a group of R^k blocks in
~100 MB of VMEM; a CTA on the H100 has 227 KB of shared memory. Each pass
therefore gets, at plan time, one of K1's three engines (`_engine_for`), a
fusion depth and a column tile, all visible in `plan.passes`:
  * float weights run on the FFMA engine, deepened while two CTAs of the
    deeper pass fit an SM's shared memory (`_pass_smem_bytes`, the
    kernel's own size, in place of the TPU's `_pass_vmem_bytes`) at its
    widest column tile, 64;
  * bf16 levels the WGMMA engine takes (`_wgmma_takes`: bf16 activations,
    radix 2, ranks 64 or 128) run one level per pass, 128 columns per
    work item; the plan pads the columns to a multiple of 8 for it;
  * every other bf16 pass runs on the MMA engine, deepened while one CTA
    fits at its widest tile, 128.
A pass that does not fit at the widest tile takes a narrower one. Ragged
columns are masked in the kernel (zero-filled by TMA for WGMMA).

Weight layout. At plan-build time each level's (hi, R, R, lo, m, k) tensor
is re-laid out once, on its device, into the per-pass form
(hiG, loG, U, V, R·m, R·k) whose trailing matrices fuse the radix mixing
into one product; the leaf becomes (hiG, 1, R^k, m0, k0). The public
layout stays the JAX one.

`FusedButterflyPlan.apply` (and the one-shot `fused_apply`, the JAX
package's `pallas_butterfly.py:414`) launches K1 for CUDA tensors and runs
the plain PyTorch version of the same pass (`pass_plain`: per-level products with the
same casts) for CPU tensors. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from butterfly_tpu_torch.ops.butterfly import UniformButterfly, _f32_precision
from butterfly_tpu_torch.utils.device import resolve_device
from butterfly_tpu_torch.utils.errors import (
    InvalidArgumentsError,
    RuntimeButterflyError,
    check,
)
from butterfly_tpu_torch.utils.nvcc import load_kernel

__all__ = ["FusedButterflyPlan", "K1", "fused_apply", "pass_plain"]

# Shared memory a CTA may use on the H100 (opt-in maximum per block), and
# an SM's, of which each resident CTA also takes 1 KB.
_SMEM_LIMIT_BYTES = 232448
_SMEM_PER_SM_BYTES = 233472
# CTAs per SM an FFMA pass keeps when it is deepened (16 warps: two warps
# per scheduler hide the shared-memory latency of the FMA loop).
_FFMA_MIN_CTAS = 2
# K1's engines (`Engine` in the .cu, same order): FFMA for float weights,
# WGMMA for the bf16 passes it takes (`_wgmma_takes`), MMA for the other
# bf16 passes.
_ENGINES = ("ffma", "mma", "wgmma")
# Column tiles each engine is built for, widest first.
_R_TILES = {"ffma": (64,), "mma": (128, 64, 32), "wgmma": (128,)}
# Rings, as the .cu sizes them: FFMA kFStages x (kFKC x kFWStride weights
# + kFKC x 64 inputs) floats; MMA kMStages x 256 x kMWStride bf16; a WGMMA
# stage is 256 weight rows and 64 x 128 inputs, bf16, in 128-byte rows.
_FFMA_RING = 3 * (16 * 260 + 16 * 64)
_MMA_RING = 3 * 256 * 40
_WGMMA_STAGE = 256 * 128 + 2 * 64 * 128
_MAX_FUSE = 16  # kMaxLevels of the kernel
_DTYPES = (torch.float32, torch.bfloat16)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _maxrows(dims, blk_in, leaf_dims) -> int:
    rows = [blk_in] + [x for mk in dims for x in mk]
    if leaf_dims is not None:
        rows.append(leaf_dims[0])
    return max(rows)


def _pass_smem_bytes(engine: str, R: int, dims, blk_in, leaf_dims,
                     r_tile: int) -> int:
    """Shared memory of one K1 CTA; mirrors `ffma_smem_bytes`,
    `mma_smem_bytes` and `wgmma_smem_bytes` in the .cu.

    FFMA: the ring, and one buffer of R^k float tiles (rows x r_tile) per
    intermediate, at most two (the leaf's output and every level's but the
    last; none at depth 1 without a leaf). MMA: two buffers of R^k bf16
    tiles of the widest rows rounded up to 16, each row padded to r_tile +
    8, and the ring. WGMMA: 1 KB of alignment slack, 3 stages, the output
    staging region (2·m rows of 128 bf16 columns, or 2·m0 rows when the
    leaf's output is taller) and two 8-byte barriers per stage."""
    Rk = R ** len(dims)
    if engine == "wgmma":
        rows = max(dims[0][0], leaf_dims[0] if leaf_dims else 0)
        return 1024 + 3 * _WGMMA_STAGE + 4 * rows * 128 + 16 * 3
    if engine == "mma":
        rows = _round_up(_maxrows(dims, blk_in, leaf_dims), 16)
        return 2 * (2 * Rk * rows * (r_tile + 8) + _MMA_RING)
    outs = ([leaf_dims[0]] if leaf_dims else []) + [m for m, _ in dims]
    inter = outs[:-1]  # the last factor writes global memory
    return 4 * (_FFMA_RING
                + min(len(inter), 2) * Rk * max(inter, default=0) * r_tile)


def _wgmma_takes(act_dtype, R: int, dims, leaf_dims) -> bool:
    """The passes the WGMMA engine runs (`wgmma_takes` in the .cu): bf16
    activations (with bf16 weights), radix 2, one level, ranks 64 or 128
    and inputs a multiple of 64 rows, for the level and the leaf. The plan
    pads columns to a multiple of 8 for it (TMA rows are 16-byte aligned)."""
    def rank_ok(m):
        return m in (64, 128)

    (m, k), = dims if len(dims) == 1 else ((0, 0),)
    return (act_dtype == torch.bfloat16 and R == 2 and rank_ok(m)
            and k % 64 == 0 and (leaf_dims is None or (
                rank_ok(leaf_dims[0]) and leaf_dims[1] % 64 == 0)))


def _engine_for(wdtype, act_dtype, R: int, dims, leaf_dims) -> str:
    if wdtype == torch.float32:
        return "ffma"
    return "wgmma" if _wgmma_takes(act_dtype, R, dims, leaf_dims) else "mma"


@dataclasses.dataclass(frozen=True)
class _PassMeta:
    """Static topology of one fused pass."""

    k: int           # number of levels fused in this pass (0: the leaf alone)
    hiG: int         # NB / R^(l0+k)
    loG: int         # R^l0
    dims: tuple      # ((m, k) per level in this pass)
    blk_in: int      # rows per block entering the pass
    blk_out: int     # rows per block leaving the pass
    leaf_dims: tuple | None  # (m0, k0) when pass 0 also applies the leaf
    r_tile: int      # columns per CTA (per work item for WGMMA)
    engine: str = "ffma"  # one of _ENGINES

    @property
    def has_leaf(self) -> bool:
        return self.leaf_dims is not None


def _r_tile_for(engine: str, R: int, dims, blk_in, leaf_dims) -> int | None:
    """Widest column tile whose CTA fits in shared memory, or None."""
    for rt in _R_TILES[engine]:
        if _pass_smem_bytes(engine, R, dims, blk_in, leaf_dims,
                            rt) <= _SMEM_LIMIT_BYTES:
            return rt
    return None


class _K1Kernel:
    """ctypes binding of `csrc/k1_pass.cu`. `launches` counts the kernel
    launches made through this wrapper; nothing else changes it."""

    def __init__(self):
        self.launches = 0
        self._lib = None

    def load(self) -> ctypes.CDLL:
        """Build (at first use) and load the kernel library."""
        if self._lib is None:
            lib = load_kernel("k1_pass.cu")
            P, I = ctypes.c_void_p, ctypes.c_int
            lib.k1_pass.argtypes = [P, P, P, P, P, P] + [I] * 13 + [P]
            lib.k1_pass.restype = I
            lib.k1_error_string.argtypes = [I]
            lib.k1_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def __call__(self, pm: _PassMeta, R: int, x: torch.Tensor, leafp,
                 ws) -> torch.Tensor:
        """One pass on CUDA tensors: x (hiG*R^k*loG*blk_in, r) in the
        activation dtype -> (hiG*R^k*loG*blk_out, r)."""
        check(x.is_cuda and x.is_contiguous() and x.dtype in _DTYPES,
              "K1 takes a contiguous float32/bfloat16 CUDA tensor",
              InvalidArgumentsError)
        Rk = R ** pm.k
        n_in = pm.hiG * Rk * pm.loG * pm.blk_in
        check(x.ndim == 2 and x.shape[0] == n_in,
              f"K1 input has shape {tuple(x.shape)}, expected ({n_in}, r)",
              InvalidArgumentsError)
        wlist = ([leafp] if pm.has_leaf else []) + list(ws)
        wdt = wlist[0].dtype
        for W in wlist:
            check(W.device == x.device and W.is_contiguous()
                  and W.dtype == wdt and wdt in _DTYPES,
                  "K1 weights must be contiguous float32/bfloat16 tensors "
                  "of one dtype on the input's device", InvalidArgumentsError)
        for t, (m, k) in enumerate(pm.dims):
            check(tuple(ws[t].shape)
                  == (pm.hiG, pm.loG, R ** (pm.k - 1 - t), R ** t, R * m,
                      R * k), f"K1 level {t} weights have the wrong shape",
                  InvalidArgumentsError)
        if pm.has_leaf:
            check(tuple(leafp.shape) == (pm.hiG, 1, Rk, *pm.leaf_dims),
                  "K1 leaf weights have the wrong shape",
                  InvalidArgumentsError)
        lib = self.load()
        r = x.shape[1]
        y = torch.empty((pm.hiG * Rk * pm.loG * pm.blk_out, r),
                        dtype=x.dtype, device=x.device)
        wptrs = (ctypes.c_void_p * pm.k)(*[W.data_ptr() for W in ws])
        dims_m = (ctypes.c_int * pm.k)(*[m for m, _ in pm.dims])
        dims_k = (ctypes.c_int * pm.k)(*[k for _, k in pm.dims])
        m0, k0 = pm.leaf_dims if pm.has_leaf else (0, 0)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        with torch.cuda.device(x.device):
            err = lib.k1_pass(
                x.data_ptr(), y.data_ptr(),
                leafp.data_ptr() if pm.has_leaf else None,
                wptrs, dims_m, dims_k, pm.k, R, pm.hiG, pm.loG, pm.blk_in,
                pm.blk_out, m0, k0, r, int(x.dtype == torch.bfloat16),
                int(wdt == torch.bfloat16), _ENGINES.index(pm.engine),
                pm.r_tile, stream)
        if err != 0:
            raise RuntimeButterflyError(
                f"K1 launch failed: {lib.k1_error_string(err).decode()}")
        self.launches += 1
        return y


K1 = _K1Kernel()


def pass_plain(pm: _PassMeta, R: int, x: torch.Tensor, leafp,
               ws) -> torch.Tensor:
    """Plain PyTorch version of one K1 pass, with the kernel's casts: each
    factor's input rounded to the weight dtype, products summed in IEEE
    float32, each level's output rounded to the activation dtype."""
    act = x.dtype
    wdt = (leafp if pm.has_leaf else ws[0]).dtype
    Rk, r = R ** pm.k, x.shape[1]

    def rounded_in(t):
        return t.to(wdt).to(torch.float32)

    with _f32_precision("highest"):
        cur = x.reshape(pm.hiG, Rk, pm.loG, pm.blk_in, r)
        if pm.has_leaf:
            cur = torch.einsum("agmk,agckr->agcmr", leafp[:, 0].float(),
                               rounded_in(cur)).to(act)
        for t, (m, k) in enumerate(pm.dims):
            U, V = R ** (pm.k - 1 - t), R ** t
            c7 = cur.reshape(pm.hiG, U, R, V, pm.loG, k, r)
            W8 = ws[t].reshape(pm.hiG, pm.loG, U, V, R, m, R, k).float()
            y = torch.einsum("aluvcmdk,audvlkr->aucvlmr", W8, rounded_in(c7))
            cur = y.to(act).reshape(pm.hiG, Rk, pm.loG, m, r)
    return cur.reshape(-1, r)


class FusedButterflyPlan:
    """Executable fused-pass form of a UniformButterfly.

    Requires level-uniform ranks (each level one (m, k); different levels
    may differ — the distilled-real-fac case), a real float32/bfloat16
    dtype and at least one level. Use `UniformButterfly.apply` for anything
    else. `fuse` caps the levels per pass; shared memory may cap it lower.
    """

    def __init__(self, bf: UniformButterfly, fuse: int = 3, act_dtype=None,
                 device=None):
        R = bf.radix
        check(bf.dtype in _DTYPES,
              f"fused plan takes float32/bfloat16 weights, not {bf.dtype} "
              "(it is real-only)", InvalidArgumentsError)
        check(bf.num_levels > 0, "fused plan needs at least one level",
              InvalidArgumentsError)
        act_dtype = act_dtype or torch.float32
        check(act_dtype in _DTYPES, "act_dtype must be float32 or bfloat16",
              InvalidArgumentsError)
        device = resolve_device(device)

        Lv = bf.num_levels
        max_k = int(round(math.log(bf.NB, R)))
        levels = [W.to(device) for W in bf.levels]
        level_dims = [(int(W.shape[4]), int(W.shape[5])) for W in levels]
        leaf_dims = (None if bf.leaf is None
                     else (int(bf.leaf.shape[1]), int(bf.leaf.shape[2])))

        def blk_in_at(l0, with_leaf):
            return leaf_dims[1] if with_leaf else level_dims[l0][1]

        def engine_at(l0, k, with_leaf):
            return _engine_for(bf.dtype, act_dtype, R, level_dims[l0:l0 + k],
                               leaf_dims if with_leaf else None)

        def smem(l0, k, with_leaf):
            engine = engine_at(l0, k, with_leaf)
            return engine, _pass_smem_bytes(
                engine, R, level_dims[l0:l0 + k], blk_in_at(l0, with_leaf),
                leaf_dims if with_leaf else None, _R_TILES[engine][0])

        def two_ctas(nbytes):
            return (nbytes + 1024) * _FFMA_MIN_CTAS <= _SMEM_PER_SM_BYTES

        def fits(l0, k, with_leaf):
            # a deeper pass stays on its engine (a bf16 level the WGMMA
            # engine takes thus runs alone) and fits at its widest tile
            engine, nbytes = smem(l0, k, with_leaf)
            if engine != engine_at(l0, 1, with_leaf):
                return False
            if engine == "ffma":
                return two_ctas(nbytes)
            return nbytes <= _SMEM_LIMIT_BYTES

        # An FFMA leaf that would cost level 0 its second CTA per SM gets a
        # pass of its own (k = 0); FFMA is bound by operations, so the extra
        # round trip of the activation is cheap.
        engine0, nbytes0 = smem(0, 1, leaf_dims is not None)
        leaf_alone = (leaf_dims is not None and engine0 == "ffma"
                      and not two_ctas(nbytes0))
        # pass sizes: greedy, as on the TPU, but against shared memory
        fuse = max(1, min(fuse, max_k, _MAX_FUSE))
        sizes = [0] if leaf_alone else []
        l0 = 0
        while l0 < Lv:
            wl = l0 == 0 and leaf_dims is not None and not leaf_alone
            k = 1
            while (l0 + k < Lv and k < fuse and l0 + k + 1 <= max_k
                   and fits(l0, k + 1, wl)):
                k += 1
            sizes.append(k)
            l0 += k

        passes, pass_weights = [], []
        l0 = 0
        for p, k in enumerate(sizes):
            hiG = bf.NB // R ** (l0 + k)
            loG = R ** l0
            ws = []
            for t in range(k):
                m_t, k_t = level_dims[l0 + t]
                U, V = R ** (k - 1 - t), R ** t
                # (hiG*U, R, R, V*loG, m, kk)
                #   -> (hiG, loG, U, V, (c, m), (d, kk)) fused mixing matrices
                Wr = levels[l0 + t].reshape(hiG, U, R, R, V, loG, m_t, k_t)
                ws.append(Wr.permute(0, 5, 1, 4, 2, 6, 3, 7).reshape(
                    hiG, loG, U, V, R * m_t, R * k_t).contiguous())
            wl = p == 0 and leaf_dims is not None
            pleaf = leaf_dims if wl else None
            dims = tuple(level_dims[l0:l0 + k])
            engine = "ffma" if k == 0 else engine_at(l0, k, wl)
            r_tile = _r_tile_for(engine, R, dims, blk_in_at(l0, wl), pleaf)
            check(r_tile is not None,
                  f"levels {l0}..{l0 + k - 1} do not fit one CTA's shared "
                  "memory even at the narrowest column tile",
                  InvalidArgumentsError)
            passes.append(_PassMeta(
                k=k, hiG=hiG, loG=loG, dims=dims, blk_in=blk_in_at(l0, wl),
                blk_out=level_dims[l0 + k - 1][0] if k else leaf_dims[0],
                leaf_dims=pleaf, r_tile=r_tile, engine=engine))
            pass_weights.append(ws)
            l0 += k

        leafp = None
        if bf.leaf is not None:
            Rk0 = R ** sizes[0]
            m0, k0 = leaf_dims
            leafp = bf.leaf.to(device).reshape(
                bf.NB // Rk0, 1, Rk0, m0, k0).contiguous()

        self.NB, self.radix = bf.NB, R
        self.blk = bf.k_in
        self.shape = bf.shape
        self.device = device
        self.act_dtype = act_dtype
        self.passes = tuple(passes)
        self.num_passes = len(passes)
        # WGMMA passes read rows by TMA, which needs 16-byte row strides
        self._col_align = 8 if any(p.engine == "wgmma" for p in passes) else 1
        self._leafp = leafp
        self._pass_weights = pass_weights

    def _run(self, x: torch.Tensor, run_pass) -> torch.Tensor:
        was_vec = x.ndim == 1
        if was_vec:
            x = x[:, None]
        check(x.ndim == 2 and x.shape[0] == self.shape[1],
              f"operand of shape {tuple(x.shape)} does not match the plan's "
              f"{self.shape}", InvalidArgumentsError)
        r = x.shape[1]
        cur = x.to(self.act_dtype)
        if r % self._col_align or cur.data_ptr() % 16:
            # zero columns up to the alignment, on a fresh 16-byte-aligned
            # tensor; they give zero columns, cut off below
            cur = torch.nn.functional.pad(cur, (0, -r % self._col_align))
        cur = cur.contiguous()
        for pm, ws in zip(self.passes, self._pass_weights):
            cur = run_pass(pm, self.radix, cur,
                           self._leafp if pm.has_leaf else None, ws)
        cur = cur[:, :r]
        return cur[:, 0] if was_vec else cur

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Apply to (n,) or (n, r) on the plan's device; the result has the
        activation dtype. CUDA tensors run through K1, CPU tensors through
        `pass_plain`."""
        check(x.device == self.device,
              f"operand on {x.device}, plan on {self.device}",
              InvalidArgumentsError)
        return self._run(x, K1 if x.is_cuda else pass_plain)

    def apply_plain(self, x: torch.Tensor) -> torch.Tensor:
        """The same apply through `pass_plain` on any device: the kernel's
        reference on the card."""
        return self._run(x, pass_plain)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(x)

    def nbytes(self) -> int:
        ts = [w for ws in self._pass_weights for w in ws]
        if self._leafp is not None:
            ts.append(self._leafp)
        return sum(t.numel() * t.element_size() for t in ts)


def fused_apply(bf: UniformButterfly, x: torch.Tensor,
                fuse: int = 3) -> torch.Tensor:
    """One-shot fused apply on x's device (builds and caches nothing;
    prefer the plan). The JAX package's `r_tile` is a TPU VMEM size: here
    each pass's column tile is set by the plan (`FusedButterflyPlan`)."""
    return FusedButterflyPlan(bf, fuse=fuse, device=x.device).apply(x)
