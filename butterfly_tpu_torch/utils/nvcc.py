"""Build a CUDA source of `csrc/` into a shared library and load it.

Each kernel source has a plain C interface. It is compiled with `nvcc` for
Hopper (`sm_90a`) at first use into `build/kernels/` beside the package
(listed in `.gitignore`), under a name that carries a hash of the source and
the flags, so an edited source is rebuilt and an unchanged one is not. The
library is loaded with `ctypes`. Nothing here runs when the package is
imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from butterfly_tpu_torch.utils.errors import RuntimeButterflyError

__all__ = ["BUILD_DIR", "build_kernel", "load_kernel"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeButterflyError("nvcc not found: the CUDA toolkit is needed "
                                "to build the port's kernels")


def build_kernel(source: str) -> Path:
    """Compile `csrc/<source>` unless an up-to-date build exists; return
    the library's path. The compiler's report (registers, shared memory,
    spills) is kept beside it as `<library>.log`."""
    src = CSRC_DIR / source
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"lib{src.stem}-{key.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeButterflyError(
            f"nvcc failed on {src.name}:\n{proc.stdout}{proc.stderr}")
    lib.with_name(lib.name + ".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: concurrent builders never see half a file
    return lib


def load_kernel(source: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build_kernel(source)))
