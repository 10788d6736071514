"""ctypes binding for the native C++ mesh kit (`csrc/meshkit.cpp`).

Port counterpart of `butterfly_tpu/geom/native.py`. The reference's mesh
pipeline is native C (src/trimesh.c: OBJ loading, boundary detection, P1
FEM LBO assembly src/trimesh.c:1470-1610); this is its native equivalent
for the host (setup-time) path. The library is built from the port's own
copy of the source with g++ at first use, into `build/kernels/`
(`utils/nvcc.py`, `build_host_library`); nothing is built when the module
is imported and nothing under the JAX package's `native/` is read.
`Trimesh.from_obj`, `boundary_edges` and `lbo_fem` take these unless called
with `use_native=False`, which runs the vectorized NumPy code, the oracle
they are tested against (`tests/test_torch_native.py`). Unlike the JAX
package, which returns None and quietly takes NumPy, every failure here
raises: a library that does not build or load, a degenerate face, an OBJ
file that does not parse.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from butterfly_tpu_torch.utils.errors import (
    InvalidArgumentsError,
    RuntimeButterflyError,
)
from butterfly_tpu_torch.utils.nvcc import build_host_library

__all__ = ["boundary_edges_native", "lbo_fem_native", "load_obj_native",
           "native_available"]


@functools.cache
def _load() -> ctypes.CDLL:
    try:
        lib = ctypes.CDLL(str(build_host_library("meshkit.cpp")))
    except (OSError, RuntimeButterflyError) as exc:
        raise RuntimeButterflyError(
            f"the native meshkit did not build or load ({exc}); "
            "use_native=False takes the NumPy path") from exc
    c_i64p = ctypes.POINTER(ctypes.c_int64)
    c_f64p = ctypes.POINTER(ctypes.c_double)
    lib.meshkit_lbo_fem.restype = ctypes.c_int64
    lib.meshkit_lbo_fem.argtypes = [
        c_f64p, ctypes.c_int64, c_i64p, ctypes.c_int64,
        c_i64p, c_i64p, c_f64p, c_f64p,
    ]
    lib.meshkit_obj_count.restype = ctypes.c_int64
    lib.meshkit_obj_count.argtypes = [ctypes.c_char_p, c_i64p, c_i64p]
    lib.meshkit_obj_read.restype = ctypes.c_int64
    lib.meshkit_obj_read.argtypes = [ctypes.c_char_p, c_f64p, c_i64p]
    lib.meshkit_boundary_edges.restype = ctypes.c_int64
    lib.meshkit_boundary_edges.argtypes = [c_i64p, ctypes.c_int64, c_i64p]
    return lib


def native_available() -> bool:
    """Whether the meshkit builds and loads here (it is built if need be)."""
    try:
        _load()
    except RuntimeButterflyError:
        return False
    return True


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _f64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def lbo_fem_native(verts: np.ndarray, faces: np.ndarray):
    """P1 FEM LBO element triplets via the native kit: (rows, cols, Lvals,
    Mvals), flat, 9 per face. A degenerate (zero-area) face raises."""
    lib = _load()
    verts = np.ascontiguousarray(verts, dtype=np.float64)
    faces = np.ascontiguousarray(faces, dtype=np.int64)
    nf = len(faces)
    rows = np.empty(9 * nf, dtype=np.int64)
    cols = np.empty(9 * nf, dtype=np.int64)
    Lv = np.empty(9 * nf, dtype=np.float64)
    Mv = np.empty(9 * nf, dtype=np.float64)
    rc = lib.meshkit_lbo_fem(
        _f64p(verts), len(verts), _i64p(faces), nf,
        _i64p(rows), _i64p(cols), _f64p(Lv), _f64p(Mv),
    )
    if rc != 0:
        raise InvalidArgumentsError("degenerate faces in mesh")
    return rows, cols, Lv, Mv


def load_obj_native(path: str):
    """Parse an OBJ file via the native kit: (verts (nv, 3), faces (nf, 3)),
    polygons fan-triangulated, /vt/vn suffixes and negative indices taken.
    A file that does not open or parse raises."""
    lib = _load()
    bpath = os.fsencode(path)
    nv = ctypes.c_int64(0)
    nf = ctypes.c_int64(0)
    if lib.meshkit_obj_count(bpath, ctypes.byref(nv), ctypes.byref(nf)) != 0:
        raise InvalidArgumentsError(f"cannot open OBJ file {path!r}")
    verts = np.empty((nv.value, 3), dtype=np.float64)
    faces = np.empty((nf.value, 3), dtype=np.int64)
    if lib.meshkit_obj_read(bpath, _f64p(verts), _i64p(faces)) != 0:
        raise InvalidArgumentsError(f"OBJ file {path!r} does not parse")
    return verts, faces


def boundary_edges_native(faces: np.ndarray) -> np.ndarray:
    """Boundary edges (ne, 2), sorted, via the native kit."""
    lib = _load()
    faces = np.ascontiguousarray(faces, dtype=np.int64)
    nf = len(faces)
    out = np.empty((3 * nf, 2), dtype=np.int64)
    count = lib.meshkit_boundary_edges(_i64p(faces), nf, _i64p(out))
    if count < 0:
        raise RuntimeButterflyError("meshkit_boundary_edges failed")
    return out[:count].copy()
