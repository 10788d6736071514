"""Wall-clock and CUDA-event timing helpers.

Port counterpart of `butterfly_tpu/utils/timer.py` (reference: the
clock()-based timer, src/timer.c:3-11, and `bfToc()`, include/bf/util.h:10).
`device_time` times a batch of calls on the card between CUDA events
recorded on the current stream, in place of the JAX package's
`block_until_ready`.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import torch

from butterfly_tpu_torch.utils.errors import RuntimeButterflyError, check

_TOC_T0 = time.perf_counter()


def toc() -> float:
    """Seconds since the last call to `toc` (reference: bfToc, src/util.c)."""
    global _TOC_T0
    now = time.perf_counter()
    elapsed = now - _TOC_T0
    _TOC_T0 = now
    return elapsed


class Timer:
    """Resettable stopwatch (reference: BfTimer, src/timer.c)."""

    def __init__(self) -> None:
        self._t0 = time.perf_counter()

    def reset(self) -> None:
        self._t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0


def device_time(fn: Callable[[], Any], *, warmup: int = 1,
                iters: int = 10) -> float:
    """Mean seconds per call of `fn` on the card.

    After `warmup` calls, `iters` calls run between one pair of CUDA events
    on the current stream, so the time is the device's, not the host's
    enqueue time, and a launch-bound call is not read as one launch's
    latency. Raises where there is no card: a CPU time is never reported
    as a device time.
    """
    check(torch.cuda.is_available(), "device_time needs a CUDA device",
          RuntimeButterflyError)
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters
