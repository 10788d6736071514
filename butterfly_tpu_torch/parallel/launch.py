"""Ranks as processes on `torch.distributed`, and the port's exchange call.

The JAX package has no counterpart: JAX is single-controller, one process
owns every device of a `Mesh`, and `shard_map`/GSPMD insert the
collectives. PyTorch is multi-controller: one process per rank, each
running the same program, with collectives through `torch.distributed`.
`run_ranks` starts those processes, makes the default group over a
`FileStore` in a fresh temporary directory (no port, so parallel test
workers never collide), runs `fn(rank, world, device, *args)` on each and
returns the ranks' results to the caller in rank order. The ranks fork
from multiprocessing's forkserver: a fresh, single-threaded interpreter
that has imported torch and the port once and never touches CUDA, so a
rank starts in milliseconds, where a spawned one re-imports torch (~4 s of
CPU each) and a rank forked from the caller would inherit its threads and
its CUDA context. The forkserver (and multiprocessing's resource tracker
beside it) stays up for the next `run_ranks` and would end only some time
after the caller has exited: a program that ran ranks calls
`stop_rank_servers` before it exits, so it leaves no process behind.

Backends are named by the caller; nothing switches between them.
  * gloo runs the collectives on CPU tensors and stages CUDA tensors
    through the host (all-to-all, all-reduce; its send/recv do not take
    CUDA tensors, and the port does not use them). It lets several ranks
    share one card, which is how the port's multi-device path runs on one
    H100.
  * NCCL needs a card per rank: a CUDA run with more ranks than cards
    raises. On a machine with one card per rank, NCCL is a change of
    `backend=` and nothing else (not exercised: no such machine was used).

`A2A` is the port's one exchange call: `all_to_all_single`, made
differentiable by `_functional_collectives.all_to_all_single_autograd`. It
counts its calls and the elements of their send buffers.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import tempfile
import traceback
from datetime import timedelta
from typing import Callable, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as tmp
from torch.multiprocessing.spawn import ProcessException

from butterfly_tpu_torch.utils.device import resolve_device
from butterfly_tpu_torch.utils.errors import (
    InvalidArgumentsError,
    RuntimeButterflyError,
    check,
)

__all__ = ["A2A", "RankTraceback", "run_programs", "run_ranks",
           "stop_rank_servers"]


class RankTraceback(Exception):
    """A rank's traceback, text carried to the caller as the `__cause__`
    of the exception the rank raised."""

    def __init__(self, rank: int, tb: str):
        super().__init__(f"rank {rank} failed:\n{tb}")


def _rank_main(rank: int, world: int, device_type: str, backend: str,
               workdir: str, timeout_s: float) -> None:
    try:
        torch.set_num_threads(1)
        with open(os.path.join(workdir, "job.pkl"), "rb") as f:
            fn, args = pickle.load(f)
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
            device = torch.device("cuda", torch.cuda.current_device())
        else:
            device = torch.device(device_type)
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(workdir, "store"),
                                          world),
            rank=rank, world_size=world,
            timeout=timedelta(seconds=timeout_s))
        try:
            result = fn(rank, world, device, *args)
        finally:
            dist.destroy_process_group()
    except BaseException as exc:
        tb = traceback.format_exc()
        with open(os.path.join(workdir, f"error{rank}.pkl"), "wb") as f:
            try:
                pickle.dump((exc, tb), f)
            except (pickle.PicklingError, TypeError, AttributeError):
                f.seek(0)
                f.truncate()
                pickle.dump((RuntimeButterflyError(repr(exc)), tb), f)
        raise
    with open(os.path.join(workdir, f"result{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def run_ranks(fn: Callable, world: int, *, device=None, backend: str,
              args: Sequence = (), timeout_s: float = 120.0) -> list:
    """Run `fn(rank, world, device, *args)` on `world` ranks and return
    their results (picklable: numpy, numbers) in rank order.

    `fn` must be importable by name: a function of a module, not of the
    caller's `__main__` (a rank re-imports a script's `__main__` under
    another name, so a script needs a `__main__` guard and a file).
    `device=None` means the card and raises without one. A rank on CUDA
    first sets its card (rank mod the card count). `timeout_s` bounds each
    collective, so a hung exchange fails.
    The first rank's exception to fail is raised here, its traceback text
    as the cause; the other ranks are stopped.
    """
    check(world >= 1, "world must be at least 1", InvalidArgumentsError)
    kind = resolve_device(None) if device is None else torch.device(device)
    if kind.type == "cuda" and backend == "nccl":
        cards = torch.cuda.device_count()
        check(world <= cards,
              f"NCCL runs one rank per GPU: {world} ranks on {cards} "
              "card(s) would share a GPU, which NCCL refuses; pass "
              "backend='gloo' to share a card", InvalidArgumentsError)
    device = resolve_device(device)
    # what the forkserver imports when this process's first run starts it
    mp.set_forkserver_preload(["butterfly_tpu_torch.entry"])
    with tempfile.TemporaryDirectory(prefix="bf_ranks_") as workdir:
        # the job goes by file: through the start pipe, a large argument
        # would hold each rank's start until the rank before had read it
        with open(os.path.join(workdir, "job.pkl"), "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        try:
            tmp.start_processes(
                _rank_main, nprocs=world, join=True,
                start_method="forkserver",
                args=(world, device.type, backend, workdir, timeout_s))
        except ProcessException as exc:
            path = os.path.join(workdir, f"error{exc.error_index}.pkl")
            if not os.path.exists(path):
                raise
            with open(path, "rb") as f:
                err, tb = pickle.load(f)
            raise err from RankTraceback(exc.error_index, tb)
        results = []
        for rank in range(world):
            with open(os.path.join(workdir, f"result{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results


def stop_rank_servers() -> None:
    """Stop the forkserver that `run_ranks` starts ranks from, then the
    resource tracker (the forkserver holds its pipe open), and wait for
    both to exit. Each is started again by the next `run_ranks`."""
    from multiprocessing import forkserver, resource_tracker

    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


def run_programs(rank: int, world: int, device: torch.device,
                 programs: Sequence[tuple[Callable, tuple]]) -> list:
    """Spawn target running several programs in one rank group, in order:
    [fn(rank, world, device, *args) for fn, args in programs]."""
    return [fn(rank, world, device, *args) for fn, args in programs]


class _AllToAll:
    """`all_to_all_single` over a group, differentiable. `calls` counts the
    calls made through it and `elems` the elements of their send buffers;
    nothing else changes them."""

    def __init__(self):
        self.calls = 0
        self.elems = 0

    def reset(self) -> None:
        self.calls = 0
        self.elems = 0

    def __call__(self, x: torch.Tensor, group, out_splits=None,
                 in_splits=None) -> torch.Tensor:
        """Send `x`'s rows split by `in_splits` (equal parts when None) to
        the group's ranks in order; return the rows received, by source
        rank, `out_splits` from each."""
        from torch.distributed import _functional_collectives as fc

        self.calls += 1
        self.elems += x.numel()
        y = fc.all_to_all_single_autograd(
            x.contiguous(), None if out_splits is None else list(out_splits),
            None if in_splits is None else list(in_splits), group)
        return fc.wait_tensor(y)


A2A = _AllToAll()
