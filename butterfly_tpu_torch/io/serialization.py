"""Checkpointing of factorizations and operators.

Replacement for the reference's ad-hoc per-type binary dumps
(bfMatSave/Dump, e.g. src/mat_product.c:123-140,
examples/simple/bf_one_block.c:168-258 — which can save but never
load-resume): every LinOp tree serializes to a single .npz with a typed
structural manifest, loads back exactly, and the streaming factorizer's
state (partial facs + column cursor) checkpoints mid-stream and resumes.

Port counterpart of `butterfly_tpu/io/serialization.py`, with the same
file formats, so that files cross between the two packages both ways:

- LinOp trees: arrays `a0, a1, ...` plus the JSON manifest `__spec__`.
- `UniformButterfly` / `CompressedTable`: `__cls__`, the leaves `l0, l1,
  ...` in the JAX pytree's order (the leaf, then the levels; Psi, then V)
  and `__treedef__`, a JAX pytree string there. The port writes a plain
  description in its place and ignores it on load. This is the file form
  of carrying weights across, next to `convert.py`.
- `FacStreamer`: the manifest of the stack of partial facs and the cursor.
"""

from __future__ import annotations

import json
import re
from typing import Any

import numpy as np
import torch

from butterfly_tpu_torch.ops import linop as L
from butterfly_tpu_torch.utils.device import resolve_device
from butterfly_tpu_torch.utils.errors import InvalidArgumentsError, check

__all__ = [
    "save_linop",
    "load_linop",
    "save_butterfly",
    "load_butterfly",
    "save_streamer",
    "load_streamer",
]


def _flatten(op: L.LinOp, arrays: dict[str, np.ndarray], counter: list[int]) -> Any:
    """Return a JSON-able spec; arrays are stored in `arrays` by unique key."""

    def put(a: np.ndarray) -> str:
        key = f"a{counter[0]}"
        counter[0] += 1
        arrays[key] = np.asarray(a)
        return key

    if isinstance(op, L.Dense):
        return {"t": "dense", "data": put(op.data)}
    if isinstance(op, L.Diag):
        return {"t": "diag", "d": put(op.diag), "shape": list(op.shape)}
    if isinstance(op, L.Identity):
        return {"t": "eye", "n": op.shape[0], "dtype": str(op.dtype)}
    if isinstance(op, L.Zero):
        return {"t": "zero", "shape": list(op.shape), "dtype": str(op.dtype)}
    if isinstance(op, L.Perm):
        return {"t": "perm", "p": put(op.perm)}
    if isinstance(op, L.Coo):
        return {
            "t": "coo", "shape": list(op.shape),
            "r": put(op.row_inds), "c": put(op.col_inds), "v": put(op.values),
        }
    if isinstance(op, L.Scaled):
        return {
            "t": "scaled",
            "alpha": [float(np.real(op.alpha)), float(np.imag(op.alpha))],
            "op": _flatten(op.op, arrays, counter),
        }
    if isinstance(op, L.Product):
        return {"t": "prod", "f": [_flatten(f, arrays, counter) for f in op.factors]}
    if isinstance(op, L.Sum):
        return {"t": "sum", "f": [_flatten(f, arrays, counter) for f in op.terms]}
    if isinstance(op, L.Diff):
        return {
            "t": "diff",
            "a": _flatten(op.a, arrays, counter),
            "b": _flatten(op.b, arrays, counter),
        }
    if isinstance(op, L.BlockDiag):
        return {"t": "bdiag", "f": [_flatten(b, arrays, counter) for b in op.blocks]}
    if isinstance(op, L.BlockCoo):
        return {
            "t": "bcoo",
            "ro": put(op.row_offsets), "co": put(op.col_offsets),
            "ri": put(op.row_inds), "ci": put(op.col_inds),
            "f": [_flatten(b, arrays, counter) for b in op.blocks],
        }
    if isinstance(op, L.BlockDense):
        return {
            "t": "bdense",
            "rows": len(op.grid), "cols": len(op.grid[0]),
            "f": [_flatten(b, arrays, counter) for row in op.grid for b in row],
        }
    raise InvalidArgumentsError(f"cannot serialize {type(op).__name__}")


def _unflatten(spec: Any, arrays) -> L.LinOp:
    t = spec["t"]
    if t == "dense":
        return L.Dense(arrays[spec["data"]])
    if t == "diag":
        return L.Diag(arrays[spec["d"]], tuple(spec["shape"]))
    if t == "eye":
        return L.Identity(spec["n"], np.dtype(spec["dtype"]))
    if t == "zero":
        return L.Zero(tuple(spec["shape"]), np.dtype(spec["dtype"]))
    if t == "perm":
        return L.Perm(arrays[spec["p"]])
    if t == "coo":
        return L.Coo(tuple(spec["shape"]), arrays[spec["r"]], arrays[spec["c"]],
                     arrays[spec["v"]])
    if t == "scaled":
        re_, im = spec["alpha"]
        alpha = re_ if im == 0 else re_ + 1j * im
        return L.Scaled(alpha, _unflatten(spec["op"], arrays))
    if t == "prod":
        return L.Product([_unflatten(s, arrays) for s in spec["f"]])
    if t == "sum":
        return L.Sum([_unflatten(s, arrays) for s in spec["f"]])
    if t == "diff":
        return L.Diff(_unflatten(spec["a"], arrays), _unflatten(spec["b"], arrays))
    if t == "bdiag":
        return L.BlockDiag([_unflatten(s, arrays) for s in spec["f"]])
    if t == "bcoo":
        return L.BlockCoo(
            arrays[spec["ro"]], arrays[spec["co"]], arrays[spec["ri"]],
            arrays[spec["ci"]], [_unflatten(s, arrays) for s in spec["f"]],
        )
    if t == "bdense":
        flat = [_unflatten(s, arrays) for s in spec["f"]]
        cols = spec["cols"]
        grid = [flat[i * cols : (i + 1) * cols] for i in range(spec["rows"])]
        return L.BlockDense(grid)
    raise InvalidArgumentsError(f"unknown serialized type {t}")


def save_linop(path: str, op: L.LinOp) -> None:
    arrays: dict[str, np.ndarray] = {}
    spec = _flatten(op, arrays, [0])
    np.savez_compressed(path, __spec__=json.dumps(spec), **arrays)


def load_linop(path: str) -> L.LinOp:
    with np.load(path, allow_pickle=False) as z:
        spec = json.loads(str(z["__spec__"]))
        arrays = {k: z[k] for k in z.files if k != "__spec__"}
    return _unflatten(spec, arrays)


# -- butterfly factor formats -----------------------------------------------


def save_butterfly(path: str, bf) -> None:
    """Save a UniformButterfly or CompressedTable: its leaves in the JAX
    pytree's order, readable by the JAX package's `load_butterfly`."""
    from butterfly_tpu_torch.models.retrieval import CompressedTable
    from butterfly_tpu_torch.ops.butterfly import UniformButterfly

    if isinstance(bf, CompressedTable):
        leaves = [bf.Psi, bf.V]
        desc = "CompressedTable(Psi, V)"
    else:
        check(isinstance(bf, UniformButterfly),
              f"cannot save {type(bf).__name__}", InvalidArgumentsError)
        leaves = ([] if bf.leaf is None else [bf.leaf]) + bf.levels
        desc = (f"UniformButterfly(leaf={bf.leaf is not None}, "
                f"levels={bf.num_levels}, radix={bf.radix})")
    np.savez_compressed(
        path,
        __treedef__=desc,
        __cls__=type(bf).__name__,
        **{f"l{i}": x.detach().cpu().numpy() for i, x in enumerate(leaves)},
    )


def load_butterfly(path: str, device=None):
    """Load a UniformButterfly / CompressedTable saved by either package's
    `save_butterfly`, onto `device` (default: the card). A leaf is told
    from a level by its rank (3 against 6), the radix read from the
    levels."""
    from butterfly_tpu_torch.models.retrieval import CompressedTable
    from butterfly_tpu_torch.ops.butterfly import UniformButterfly

    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        cls = str(z["__cls__"])
        keys = sorted((k for k in z.files if re.fullmatch(r"l\d+", k)),
                      key=lambda k: int(k[1:]))
        leaves = [torch.from_numpy(np.array(z[k])).to(dev) for k in keys]
    if cls == "CompressedTable":
        return CompressedTable(*leaves)
    check(cls == "UniformButterfly", f"unknown checkpoint class {cls}")
    leaf = leaves[0] if leaves and leaves[0].ndim == 3 else None
    levels = leaves[1:] if leaf is not None else leaves
    radix = levels[0].shape[1] if levels else 2
    return UniformButterfly(leaf, levels, radix=radix)


# -- streamer checkpoint/resume ---------------------------------------------


def save_streamer(path: str, streamer) -> None:
    """Checkpoint a FacStreamer mid-stream: position + partial facs.

    Row/column tree nodes are identified by (depth, i0, i1) paths and
    re-linked on load against the SAME FacSpec trees.
    """
    from butterfly_tpu_torch.fac.streamer import FacStreamer

    check(isinstance(streamer, FacStreamer), "expected a FacStreamer")
    arrays: dict[str, np.ndarray] = {}
    counter = [0]
    facs_spec = []
    for fac in streamer._stack:
        facs_spec.append(
            {
                "col": [fac.col_node.depth, fac.col_node.i0, fac.col_node.i1],
                "rows": [[n.depth, n.i0, n.i1] for n in fac.row_nodes],
                "Psi": _flatten(fac.Psi, arrays, counter),
                "W": [_flatten(w, arrays, counter) for w in fac.W],
            }
        )
    manifest = {"pos": streamer._pos, "facs": facs_spec}
    np.savez_compressed(path, __spec__=json.dumps(manifest), **arrays)


def load_streamer(path: str, spec, auto_skip_empty_leaves: bool = True):
    """Resume a FacStreamer from a checkpoint against the same FacSpec."""
    from butterfly_tpu_torch.fac.streamer import FacStreamer, PartialFac

    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(str(z["__spec__"]))
        arrays = {k: z[k] for k in z.files if k != "__spec__"}

    def node_index(tree):
        return {(n.depth, n.i0, n.i1): n for n in tree.root.subtree_nodes()}

    col_nodes = node_index(spec.col_tree)
    row_nodes = node_index(spec.row_tree)

    streamer = FacStreamer(spec, auto_skip_empty_leaves)
    streamer._pos = manifest["pos"]
    streamer._stack = [
        PartialFac(
            col_node=col_nodes[tuple(f["col"])],
            row_nodes=[row_nodes[tuple(r)] for r in f["rows"]],
            Psi=_unflatten(f["Psi"], arrays),
            W=[_unflatten(w, arrays) for w in f["W"]],
        )
        for f in manifest["facs"]
    ]
    return streamer
