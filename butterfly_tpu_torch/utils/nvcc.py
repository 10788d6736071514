"""Build a source of `csrc/` into a shared library and load it.

Each source has a plain C interface. A CUDA kernel (`.cu`) is compiled with
`nvcc` for Hopper (`sm_90a`); a host kit (`.cpp`: the tree and mesh kits) is
compiled with `g++`. Either is built at first use into `build/kernels/`
beside the package (listed in `.gitignore`), under a name that carries a
hash of the source and the flags, so an edited source is rebuilt and an
unchanged one is not, and loaded with `ctypes`. A build is written to a
temporary file and moved into place, so processes that build at once never
load half a file. Nothing here runs when the package is imported; a failed
build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from butterfly_tpu_torch.utils.errors import RuntimeButterflyError

__all__ = ["BUILD_DIR", "build_host_library", "build_kernel", "load_kernel"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# no FMA contraction: the kits' float64 arithmetic then rounds as NumPy's
HOST_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared", "-ffp-contract=off")


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeButterflyError("nvcc not found: the CUDA toolkit is needed "
                                "to build the port's kernels")


def gxx_path() -> str:
    cand = shutil.which("g++")
    if cand is None:
        raise RuntimeButterflyError("g++ not found: it builds the port's "
                                    "native tree and mesh kits")
    return cand


def _build(source: str, compiler: str, flags: tuple) -> Path:
    """Compile `csrc/<source>` with `compiler` and `flags` unless an
    up-to-date build exists; return the library's path. The compiler's
    report is kept beside it as `<library>.log`."""
    src = CSRC_DIR / source
    key = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    lib = BUILD_DIR / f"lib{src.stem}-{key.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([compiler, *flags, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeButterflyError(
            f"{Path(compiler).name} failed on {src.name}:\n"
            f"{proc.stdout}{proc.stderr}")
    lib.with_name(lib.name + ".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: concurrent builders never see half a file
    return lib


def build_kernel(source: str) -> Path:
    """Build the CUDA source `csrc/<source>` with nvcc (the log holds the
    ptxas report: registers, shared memory, spills per kernel)."""
    return _build(source, nvcc_path(), NVCC_FLAGS)


def build_host_library(source: str) -> Path:
    """Build the host C++ source `csrc/<source>` with g++."""
    return _build(source, gxx_path(), HOST_FLAGS)


def load_kernel(source: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build_kernel(source)))
