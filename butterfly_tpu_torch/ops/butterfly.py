"""UniformButterfly: the FFT-form butterfly operator, in PyTorch.

Port counterpart of `butterfly_tpu/ops/butterfly.py`. Each level is stored
in "FFT form" and applied as one einsum with no gathers or scatters:

    level l weights:  W_l of shape (hi, c, d, lo, m, k),  hi = NB / (R^{l+1}),
                      lo = R^l, c,d in [R] (the radix),
    activations:      x of shape (NB, k, r) viewed as (hi, d, lo, k, r),
    apply:            y[h,c,l] = sum_d W[h,c,d,l] @ x[h,d,l]
                      == einsum('hcdlmk,hdlkr->hclmr', W, x).

Block i mixes with the blocks that differ in base-R digit l of the block
index: the butterfly sparsity pattern of the reference's MatBlockCoo
factors (src/fac_helm2.c:309-312).

The module holds its factors as buffers. Gradients come from autograd
through the einsums, in place of the JAX package's pytree registration.
This einsum apply is the unfused path (cuBLAS on the card); the fused
kernel path is `ops/fused_butterfly.py`.
"""

from __future__ import annotations

import contextlib
import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

from butterfly_tpu_torch.ops import linop as L
from butterfly_tpu_torch.utils.device import resolve_device
from butterfly_tpu_torch.utils.errors import InvalidArgumentsError, check

__all__ = ["UniformButterfly", "random_butterfly"]

_EXACT_FLOATS = (torch.float32, torch.float64, torch.complex64,
                 torch.complex128)


@contextlib.contextmanager
def _f32_precision(precision):
    """precision="highest" pins IEEE float32 for the matmuls inside: TF32
    keeps about three decimal digits, which would break the 1e-6 accuracy
    lines (the JAX package pins Precision.HIGHEST for the same reason)."""
    if precision != "highest":
        yield
        return
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _contract(eq: str, W: torch.Tensor, x: torch.Tensor,
              out_dtype: torch.dtype) -> torch.Tensor:
    """einsum(eq, W, x.astype(W.dtype)) with products summed in `out_dtype`
    (the JAX `preferred_element_type`)."""
    xw = x.to(W.dtype)
    if out_dtype == W.dtype:
        return torch.einsum(eq, W, xw)
    return torch.einsum(eq, W.to(out_dtype), xw.to(out_dtype))


class UniformButterfly(nn.Module):
    """A uniform-rank butterfly operator: optional block-diagonal leaf factor
    followed by `L` FFT-form mixing levels.

    Attributes:
      leaf: (NB, m0, k0) block-diagonal leaf factor or None (identity).
      levels: list of (hi, R, R, lo, m, k) tensors, level l has
        hi = NB/R^{l+1}, lo = R^l; level l's k must equal level l-1's m
        (or leaf m0).
      precision: "highest" pins IEEE float32 matmuls (see `_f32_precision`).
    """

    def __init__(self, leaf, levels: Sequence, radix: int = 2,
                 precision=None):
        super().__init__()
        self.register_buffer("leaf", leaf)
        levels = list(levels)
        self._num_levels = len(levels)
        for l, W in enumerate(levels):
            self.register_buffer(f"level{l}", W)
        self.radix = radix
        self.precision = precision
        if leaf is not None:
            self.NB = leaf.shape[0]
            k_in = leaf.shape[2]
            m_prev = leaf.shape[1]
        else:
            check(len(levels) > 0, "butterfly needs at least one factor")
            W0 = levels[0]
            self.NB = W0.shape[0] * W0.shape[1] * W0.shape[3]
            k_in = W0.shape[5]
            m_prev = k_in
        for l, W in enumerate(levels):
            hi, c, d, lo, m, k = W.shape
            check(c == radix and d == radix, "level radix mismatch")
            check(hi * radix * lo == self.NB, f"level {l} shape inconsistent")
            check(lo == radix**l, f"level {l} lo must be radix^l")
            check(k == m_prev,
                  f"level {l} input rank {k} != previous output {m_prev}")
            m_prev = m
        self.m_out = m_prev
        self.k_in = k_in
        self.shape = (self.NB * self.m_out, self.NB * self.k_in)

    @property
    def levels(self) -> list[torch.Tensor]:
        return [getattr(self, f"level{l}") for l in range(self._num_levels)]

    @property
    def dtype(self) -> torch.dtype:
        return (self.levels[0] if self._num_levels else self.leaf).dtype

    # -- apply -----------------------------------------------------------

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Apply to x of shape (n,) or (n, r).

        Dtype rules are the JAX package's (`ops/butterfly.py:105-120`): each
        factor casts its input to its own dtype; the leaf sums in x's dtype
        (float32 for bfloat16 x), a bfloat16 level sums in float32. Where a
        bfloat16 factor feeds another bfloat16 factor the sum is rounded to
        bfloat16 at once: the next factor would round its input to
        bfloat16 anyway, and the product then runs on the tensor cores.
        """
        was_vec = x.ndim == 1
        if was_vec:
            x = x[:, None]
        r = x.shape[1]
        stages = ([self.leaf] if self.leaf is not None else []) + self.levels
        cur = x.reshape(self.NB, self.k_in, r)
        R = self.radix
        with _f32_precision(self.precision):
            for s, W in enumerate(stages):
                nxt = stages[s + 1] if s + 1 < len(stages) else None
                if (W.dtype == torch.bfloat16 and nxt is not None
                        and nxt.dtype == torch.bfloat16):
                    out_dtype = torch.bfloat16
                elif W is self.leaf:
                    out_dtype = (cur.dtype if cur.dtype in _EXACT_FLOATS
                                 else torch.float32)
                else:
                    out_dtype = (torch.float32 if W.dtype == torch.bfloat16
                                 else W.dtype)
                if W is self.leaf:
                    cur = _contract("bmk,bkr->bmr", W, cur, out_dtype)
                    continue
                hi, _, _, lo, m, k = W.shape
                c5 = cur.reshape(hi, R, lo, k, r)
                y = _contract("hcdlmk,hdlkr->hclmr", W, c5, out_dtype)
                cur = y.reshape(self.NB, m, r)
        out = cur.reshape(self.NB * self.m_out, r)
        return out[:, 0] if was_vec else out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(x)

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        """Batched multi-RHS apply (alias for solver interop)."""
        return self.apply(X)

    # -- introspection ---------------------------------------------------

    @property
    def num_levels(self) -> int:
        return self._num_levels

    def nbytes(self) -> int:
        total = 0 if self.leaf is None else (
            self.leaf.numel() * self.leaf.element_size())
        return total + sum(W.numel() * W.element_size() for W in self.levels)

    def flops_per_col(self) -> int:
        """Useful multiply-add flops (x2) per RHS column."""
        total = 0
        if self.leaf is not None:
            NB, m, k = self.leaf.shape
            total += 2 * NB * m * k
        for W in self.levels:
            hi, c, d, lo, m, k = W.shape
            total += 2 * hi * c * d * lo * m * k
        return total

    def astype(self, dtype) -> "UniformButterfly":
        leaf = None if self.leaf is None else self.leaf.to(dtype)
        return UniformButterfly(
            leaf, [W.to(dtype) for W in self.levels], self.radix,
            precision=self.precision,
        )

    # -- oracle conversion ----------------------------------------------

    def to_linop(self) -> L.LinOp:
        """Equivalent host LinOp (BlockDiag/BlockCoo chain) for testing."""
        R = self.radix
        factors: list[L.LinOp] = []

        def host(t):
            t = t.detach().cpu()
            if t.dtype == torch.bfloat16:
                t = t.to(torch.float32)
            return t.numpy().astype(
                np.complex128 if t.is_complex() else np.float64)

        if self.leaf is not None:
            leaf = host(self.leaf)
            factors.append(
                L.BlockDiag([L.Dense(leaf[i]) for i in range(self.NB)]))
        for W in self.levels:
            Wn = host(W)
            hi, _, _, lo, m, k = Wn.shape
            row_offsets = np.arange(self.NB + 1) * m
            col_offsets = np.arange(self.NB + 1) * k
            row_inds, col_inds, blocks = [], [], []
            for h in range(hi):
                for c in range(R):
                    for ll in range(lo):
                        i = (h * R + c) * lo + ll
                        for d in range(R):
                            j = (h * R + d) * lo + ll
                            row_inds.append(i)
                            col_inds.append(j)
                            blocks.append(L.Dense(Wn[h, c, d, ll]))
            factors.append(
                L.BlockCoo(row_offsets, col_offsets, row_inds, col_inds,
                           blocks)
            )
        return L.Product(list(reversed(factors)))


def random_butterfly(
    num_blocks: int,
    block: int,
    num_levels: int | None = None,
    radix: int = 2,
    dtype=torch.float32,
    generator: torch.Generator | None = None,
    with_leaf: bool = True,
    device=None,
) -> UniformButterfly:
    """A random orthonormal-ish uniform butterfly (scaled so products neither
    explode nor vanish): NB=num_blocks leaf blocks of size `block`.

    The normals are drawn in float32 on `device` from `generator` (a
    generator on that device; seed 0 when None), then cast to `dtype`.
    """
    check(num_blocks >= radix, "need at least radix blocks",
          InvalidArgumentsError)
    max_levels = int(round(math.log(num_blocks, radix)))
    check(radix**max_levels == num_blocks,
          "num_blocks must be a power of radix", InvalidArgumentsError)
    if num_levels is None:
        num_levels = max_levels
    check(num_levels <= max_levels, "too many levels", InvalidArgumentsError)
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    def normal(shape, scale):
        t = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return t.mul_(scale).to(dtype)

    leaf = None
    if with_leaf:
        leaf = normal((num_blocks, block, block), 1.0 / np.sqrt(block))
    levels = []
    for l in range(num_levels):
        hi, lo = num_blocks // radix ** (l + 1), radix**l
        levels.append(normal((hi, radix, radix, lo, block, block),
                             1.0 / np.sqrt(radix * block)))
    return UniformButterfly(leaf, levels, radix)
