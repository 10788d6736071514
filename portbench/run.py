"""Run one cell of the benchmark and print its result as the last line.

  python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
      --trace <0|1>

It refuses (exit 2, no result) where there is no CUDA device or fewer
than the cell asks for, and (exit 3, no result) where JAX, Flax or the
JAX package was loaded in the process. The numbers that decide `correct`
are printed beside their limits as the last lines of standard error and
under the result's last key, `checks`.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout. The
    port's kernels build into build/kernels/ beside its package."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(ROOT / "build" / "portbench_cache" / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))

    import torch

    from portbench import harness

    bench = harness.Bench(ROOT)
    cell = bench.cell(args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {found}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = harness.execute(bench, cell.name, args.seed, args.seconds,
                          bool(args.trace), "cuda:0", T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"portbench: the process loaded {loaded}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
