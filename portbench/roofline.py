"""Roofline arithmetic of the benchmark: the chip's published peaks and
the work a compressed operator needs.

The peaks are NVIDIA's data-sheet figures for one H100 SXM (dense, no
sparsity, at the full 700 W power limit): 67 TFLOP/s in float32 outside
the tensor cores and 3.35 TB/s of HBM. A card set below 700 W runs
slower under load; the run reports its power limit beside the share.

`operator_work` counts what applying the host factorization needs, read
from its blocks: every stored entry is one multiply-add per column
(complex: 8 real flops; real: 2), its weight read once in the apply's
precision (complex64: 8 bytes; float32: 4), and each input and output
element of the block read or written once. It does not count what any
implementation adds (padding, trimmed tables, the real embedding's
doubled weights), so the share reads the same work whatever implements
the apply. `roofline_share` is the arithmetic of the program's
`utils/profiling.py` `roofline_report`, copied.
"""

from __future__ import annotations

import dataclasses

import numpy as np

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32_flops": 67e12, "hbm_bytes_per_s": 3.35e12},
}


@dataclasses.dataclass(frozen=True)
class Work:
    flops: float
    bytes: float


def _leaves(op):
    kids = op.children() if hasattr(op, "children") else ()
    if not kids:
        yield op
        return
    for k in kids:
        yield from _leaves(k)


def stored_entries(op) -> tuple[int, bool]:
    """(entries, complex) of the operator's stored weights. Leaves must be
    dense (`data`) or hold no weights (identity, permutation, zero): any
    other leaf with storage raises, so a change of structure cannot drop
    work unseen."""
    entries, cplx = 0, False
    for leaf in _leaves(op):
        data = getattr(leaf, "data", None)
        if isinstance(data, np.ndarray):
            entries += data.size
            cplx = cplx or np.iscomplexobj(data)
        elif leaf.nbytes() > 0 and type(leaf).__name__ not in ("Perm",):
            raise TypeError(f"no work model for a {type(leaf).__name__} "
                            "leaf with stored weights")
    return entries, cplx


def operator_work(op, cols: int) -> Work:
    """The work of applying `op` (the host factorization) to `cols`
    columns in the float32 apply."""
    entries, cplx = stored_entries(op)
    m, n = op.shape
    word = 8 if cplx else 4            # complex64 or float32
    flops = (8 if cplx else 2) * entries * cols
    return Work(flops, word * entries + word * (m + n) * cols)


def roofline_share(work: Work, seconds: float, device_kind: str) -> dict:
    """The least time at the published peaks over the measured time, in %,
    and which peak bounds it."""
    peak = PEAKS[device_kind]
    t_flops = work.flops / peak["f32_flops"]
    t_bytes = work.bytes / peak["hbm_bytes_per_s"]
    return {"share_pct": 100.0 * max(t_flops, t_bytes) / seconds,
            "bound": "flops" if t_flops >= t_bytes else "bytes",
            "t_min_s": max(t_flops, t_bytes), "measured_s": seconds}
