"""ctypes binding for the native C++ tree builder (`csrc/treekit.cpp`).

Port counterpart of `butterfly_tpu/trees/native.py`. The library is built
from the port's own copy of the source with g++ at first use, into
`build/kernels/` (`utils/nvcc.py`, `build_host_library`); nothing is built
when the module is imported and nothing under the JAX package's `native/`
is read. `build_point_tree_native` returns the (perm, node table) contract
of the NumPy builder; `PointTree` takes it unless called with
`use_native=False`. Unlike the JAX package, which returns None and quietly
takes NumPy, a build or load failure here raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from butterfly_tpu_torch.utils.errors import RuntimeButterflyError
from butterfly_tpu_torch.utils.nvcc import build_host_library

__all__ = ["build_point_tree_native", "native_available"]


@functools.cache
def _load() -> ctypes.CDLL:
    try:
        lib = ctypes.CDLL(str(build_host_library("treekit.cpp")))
    except (OSError, RuntimeButterflyError) as exc:
        raise RuntimeButterflyError(
            f"the native treekit did not build or load ({exc}); "
            "PointTree(..., use_native=False) takes the NumPy builder"
        ) from exc
    lib.treekit_build.restype = ctypes.c_int64
    lib.treekit_build.argtypes = [
        ctypes.POINTER(ctypes.c_double),  # points
        ctypes.c_int64,  # n
        ctypes.c_int32,  # d
        ctypes.c_int64,  # leaf_size
        ctypes.c_int32,  # max_depth
        ctypes.POINTER(ctypes.c_int64),  # perm
        ctypes.POINTER(ctypes.c_int64),  # node_parent
        ctypes.POINTER(ctypes.c_int32),  # node_depth
        ctypes.POINTER(ctypes.c_int64),  # node_i0
        ctypes.POINTER(ctypes.c_int64),  # node_i1
        ctypes.POINTER(ctypes.c_int32),  # node_octant
        ctypes.POINTER(ctypes.c_double),  # node_lo
        ctypes.POINTER(ctypes.c_double),  # node_hi
        ctypes.c_int64,  # max_nodes
    ]
    return lib


def native_available() -> bool:
    """Whether the treekit builds and loads here (it is built if need be)."""
    try:
        _load()
    except RuntimeButterflyError:
        return False
    return True


def build_point_tree_native(points: np.ndarray, leaf_size: int,
                            max_depth: int):
    """Run the native builder. Returns (perm, nodes): nodes is a dict of
    flat arrays (parent, depth, i0, i1, octant, lo, hi) in discovery order,
    siblings consecutive in ascending octant order."""
    lib = _load()
    points = np.ascontiguousarray(points, dtype=np.float64)
    n, d = points.shape
    perm = np.arange(n, dtype=np.int64)
    # every split makes >= 2 children and a leaf holds >= 1 point, so a
    # tree has < 2n nodes; the table is sized generously
    max_nodes = 4 * n + 16
    parent = np.empty(max_nodes, dtype=np.int64)
    depth = np.empty(max_nodes, dtype=np.int32)
    i0 = np.empty(max_nodes, dtype=np.int64)
    i1 = np.empty(max_nodes, dtype=np.int64)
    octant = np.empty(max_nodes, dtype=np.int32)
    lo = np.empty((max_nodes, 3), dtype=np.float64)
    hi = np.empty((max_nodes, 3), dtype=np.float64)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    count = lib.treekit_build(
        ptr(points, ctypes.c_double), n, d, int(leaf_size), int(max_depth),
        ptr(perm, ctypes.c_int64),
        ptr(parent, ctypes.c_int64), ptr(depth, ctypes.c_int32),
        ptr(i0, ctypes.c_int64), ptr(i1, ctypes.c_int64),
        ptr(octant, ctypes.c_int32),
        ptr(lo, ctypes.c_double), ptr(hi, ctypes.c_double),
        max_nodes,
    )
    if count < 0:
        raise RuntimeButterflyError(
            f"treekit_build refused n={n}, d={d}, leaf_size={leaf_size}")
    return perm, {
        "parent": parent[:count].copy(),
        "depth": depth[:count].copy(),
        "i0": i0[:count].copy(),
        "i1": i1[:count].copy(),
        "octant": octant[:count].copy(),
        "lo": lo[:count].copy(),
        "hi": hi[:count].copy(),
    }
