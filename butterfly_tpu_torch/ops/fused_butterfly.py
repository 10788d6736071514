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
~100 MB of VMEM; a CTA on the H100 has 227 KB of shared memory. The fusion
depth of each pass and its column tile are therefore chosen from
`_pass_smem_bytes` (the kernel's own shared-memory size) in place of the
TPU's `_pass_vmem_bytes`: a pass is deepened while its group fits with the
widest column tile of its engine (64 for float weights, 128 for bf16), and
a pass that does not fit at that width takes a narrower one. Ragged
columns are masked in the kernel instead of padded.

Weight layout. At plan-build time each level's (hi, R, R, lo, m, k) tensor
is re-laid out once, on its device, into the per-pass form
(hiG, loG, U, V, R·m, R·k) whose trailing matrices fuse the radix mixing
into one product; the leaf becomes (hiG, 1, R^k, m0, k0). The public
layout stays the JAX one.

`FusedButterflyPlan.apply` launches K1 for CUDA tensors and runs the plain
PyTorch version of the same pass (`pass_plain`: per-level products with the
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

__all__ = ["FusedButterflyPlan", "K1", "pass_plain"]

# Shared memory a CTA may use on the H100 (opt-in maximum per block).
_SMEM_LIMIT_BYTES = 232448
# Column tiles each engine of the kernel is built for, widest first: FFMA
# (float weights) and MMA (bf16 weights).
_R_TILES = {torch.float32: (64, 16), torch.bfloat16: (128, 64, 32)}
# Staged weights of each engine, in elements: rings of kFStages chunks of
# kFKC x kFWStride (FFMA) and of kMStages chunks of 256 x kMWStride (MMA).
_W_STAGE = {torch.float32: 2 * 32 * 260, torch.bfloat16: 3 * 256 * 40}
_MAX_FUSE = 16  # kMaxLevels of the kernel
_DTYPES = (torch.float32, torch.bfloat16)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pass_smem_bytes(wdtype, Rk: int, maxrows: int, r_tile: int) -> int:
    """Shared memory of one K1 CTA (mirrors `smem_bytes` in the .cu):
    two buffers of Rk activation tiles and the weight ring. Float weights
    keep float tiles of maxrows x r_tile; bf16 weights keep bf16 tiles of
    maxrows rounded up to 16 rows, each padded to r_tile + 8 elements."""
    if wdtype == torch.bfloat16:
        tiles = 2 * Rk * _round_up(maxrows, 16) * (r_tile + 8)
        return 2 * (tiles + _W_STAGE[wdtype])
    return 4 * (2 * Rk * maxrows * r_tile + _W_STAGE[wdtype])


@dataclasses.dataclass(frozen=True)
class _PassMeta:
    """Static topology of one fused pass."""

    k: int           # number of levels fused in this pass
    hiG: int         # NB / R^(l0+k)
    loG: int         # R^l0
    dims: tuple      # ((m, k) per level in this pass)
    blk_in: int      # rows per block entering the pass
    blk_out: int     # rows per block leaving the pass
    leaf_dims: tuple | None  # (m0, k0) when pass 0 also applies the leaf
    r_tile: int      # columns per CTA

    @property
    def has_leaf(self) -> bool:
        return self.leaf_dims is not None


def _maxrows(dims, blk_in, leaf_dims) -> int:
    rows = [blk_in] + [x for mk in dims for x in mk]
    if leaf_dims is not None:
        rows.append(leaf_dims[0])
    return max(rows)


def _r_tile_for(wdtype, R: int, dims, blk_in, leaf_dims) -> int | None:
    """Widest column tile whose CTA fits in shared memory, or None."""
    Rk, rows = R ** len(dims), _maxrows(dims, blk_in, leaf_dims)
    for rt in _R_TILES[wdtype]:
        if _pass_smem_bytes(wdtype, Rk, rows, rt) <= _SMEM_LIMIT_BYTES:
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
            lib.k1_pass.argtypes = [P, P, P, P, P, P] + [I] * 12 + [P]
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
                int(wdt == torch.bfloat16), pm.r_tile, stream)
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

        def blk_in_at(l0):
            return leaf_dims[1] if l0 == 0 and leaf_dims else level_dims[l0][1]

        def fits(l0, k):
            return _r_tile_for(
                bf.dtype, R, level_dims[l0:l0 + k], blk_in_at(l0),
                leaf_dims if l0 == 0 else None,
            ) == _R_TILES[bf.dtype][0]

        # pass sizes: greedy, as on the TPU, but against shared memory
        fuse = max(1, min(fuse, max_k, _MAX_FUSE))
        sizes = []
        l0 = 0
        while l0 < Lv:
            k = 1
            while (l0 + k < Lv and k < fuse and l0 + k + 1 <= max_k
                   and fits(l0, k + 1)):
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
            pleaf = leaf_dims if p == 0 else None
            dims = tuple(level_dims[l0:l0 + k])
            r_tile = _r_tile_for(bf.dtype, R, dims, blk_in_at(l0), pleaf)
            check(r_tile is not None,
                  f"levels {l0}..{l0 + k - 1} do not fit one CTA's shared "
                  "memory even at the narrowest column tile",
                  InvalidArgumentsError)
            passes.append(_PassMeta(
                k=k, hiG=hiG, loG=loG, dims=dims, blk_in=blk_in_at(l0),
                blk_out=level_dims[l0 + k - 1][0], leaf_dims=pleaf,
                r_tile=r_tile))
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
        self._leafp = leafp
        self._pass_weights = pass_weights

    def _run(self, x: torch.Tensor, run_pass) -> torch.Tensor:
        was_vec = x.ndim == 1
        if was_vec:
            x = x[:, None]
        check(x.ndim == 2 and x.shape[0] == self.shape[1],
              f"operand of shape {tuple(x.shape)} does not match the plan's "
              f"{self.shape}", InvalidArgumentsError)
        cur = x.to(self.act_dtype).contiguous()
        for pm, ws in zip(self.passes, self._pass_weights):
            cur = run_pass(pm, self.radix, cur,
                           self._leafp if pm.has_leaf else None, ws)
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
