"""Per-operator roofline accounting and the profiler hook.

Replacement (and upgrade) for the reference's wall-clock-only instrumentation
(bfToc sprinkled through examples, src/timer.c): every hot operator exposes
flops/bytes, and `roofline_report` turns a measured apply time into
achieved-vs-speed-of-light fractions against the peaks the caller passes
(there are no defaults: a card's rates and its power limit belong to the
measurement). `device_trace` wraps `torch.profiler`.

Port counterpart of `butterfly_tpu/utils/profiling.py`, with the same cost
model and arithmetic. Its `device_trace` swallows every profiler error;
this one raises them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import torch

__all__ = ["OpCost", "op_cost", "roofline_report", "device_trace"]


@dataclasses.dataclass
class OpCost:
    flops_per_col: int  # useful multiply-add flops (x2) per RHS column
    weight_bytes: int  # parameter bytes streamed per apply
    io_bytes_per_col: int  # input+output bytes per RHS column


def op_cost(op, dtype_bytes: int = 4) -> OpCost:
    """Cost model for UniformButterfly, StagePlan, CompressedTable, LinOp."""
    from butterfly_tpu_torch.models.retrieval import CompressedTable
    from butterfly_tpu_torch.ops.butterfly import UniformButterfly
    from butterfly_tpu_torch.ops.linop import LinOp
    from butterfly_tpu_torch.ops.packed import StagePlan

    if isinstance(op, UniformButterfly):
        m, n = op.shape
        return OpCost(op.flops_per_col(), op.nbytes(), (m + n) * dtype_bytes)
    if isinstance(op, StagePlan):
        m, n = op.shape
        return OpCost(
            op.stats.useful_flops_per_col, op.stats.weight_bytes,
            (m + n) * dtype_bytes,
        )
    if isinstance(op, CompressedTable):
        NB, s, r = op.Psi.shape
        d = op.dim
        fl = 2 * NB * (s * r + r * d)
        return OpCost(fl, op.nbytes(), (op.num_rows + d) * dtype_bytes)
    if isinstance(op, LinOp):
        m, n = op.shape
        # conservative: count stored bytes as streamed, dense-equivalent flops
        return OpCost(2 * m * n, op.nbytes(), (m + n) * dtype_bytes)
    raise TypeError(f"no cost model for {type(op).__name__}")


def roofline_report(
    op,
    num_cols: int,
    measured_seconds: float,
    peak_tflops: float,
    hbm_gbps: float,
    dtype_bytes: int = 4,
) -> dict:
    """Achieved throughput vs the op's speed of light on one device.

    Speed-of-light time = max(compute-limit, minimum-traffic-limit) where the
    minimum traffic reads every weight byte once and the input/output once.
    """
    c = op_cost(op, dtype_bytes)
    flops = c.flops_per_col * num_cols
    bytes_min = c.weight_bytes + c.io_bytes_per_col * num_cols
    t_compute = flops / (peak_tflops * 1e12)
    t_bw = bytes_min / (hbm_gbps * 1e9)
    t_sol = max(t_compute, t_bw)
    return {
        "useful_tflops": flops / measured_seconds / 1e12,
        "achieved_frac_sol": t_sol / measured_seconds,
        "bound": "compute" if t_compute >= t_bw else "bandwidth",
        "t_compute_limit_ms": t_compute * 1e3,
        "t_bandwidth_limit_ms": t_bw * 1e3,
        "measured_ms": measured_seconds * 1e3,
        "arithmetic_intensity": flops / max(bytes_min, 1),
    }


@contextlib.contextmanager
def device_trace(log_dir: str):
    """`torch.profiler` over the block: CPU activity, and CUDA activity
    where there is a card. Yields the profiler (read `key_averages()`
    after the block); on exit writes the Chrome trace
    `log_dir/trace.json`. Errors of the profiler propagate."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
