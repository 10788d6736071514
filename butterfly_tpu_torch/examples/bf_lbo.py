"""Streaming butterfly compression of Laplace-Beltrami eigenfunctions.

Twin of the JAX package's `examples/bf_lbo.py` (reference:
examples/lbo/bf_lbo.c): build the FEM LBO on a mesh, stream its eigenbands
through the factorizer band by band, and print the compression metrics the
reference prints (compressed vs uncompressed MB, compression rate) and the
eigen-residual of the compressed apply, ||L y - M z|| / ||L y|| for
y = Phi c and z = Phi (lam c) with a random c.

`--eigensolver device` computes the bands on the card
(`ops/device_eigs.DeviceEigSession`, float64; `--device cpu` runs it on the
CPU), `scipy` (the default, as the JAX script) on the host. The streaming
factorization and the apply are host float64 either way.

Usage:
  python -m butterfly_tpu_torch.examples.bf_lbo [--subdiv 3] [--tol 1e-6]
      [--fiedler] [--eigensolver {scipy,device}] [--device cpu]
  python -m butterfly_tpu_torch.examples.bf_lbo --obj mesh.obj

Prints one JSON row.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from butterfly_tpu_torch.geom.trimesh import Trimesh, icosphere
from butterfly_tpu_torch.models.lbo import compress_lbo_eigenfunctions
from butterfly_tpu_torch.utils.device import resolve_device


def eigen_residual(mesh: Trimesh, comp, seed: int = 0) -> float:
    """||L y - M z|| / ||L y|| with y = Phi c, z = Phi (lam c), c from
    `default_rng(seed)`, both in original vertex order."""
    L, M = mesh.lbo_fem()
    c = np.random.default_rng(seed).standard_normal(comp.freqs.size)
    op = comp.fac.as_linop()
    y = np.empty(mesh.num_verts)
    y[comp.row_tree.perm] = op.matvec(c)
    z = np.empty(mesh.num_verts)
    z[comp.row_tree.perm] = op.matvec(comp.freqs**2 * c)
    return float(np.linalg.norm(L @ y - M @ z) / np.linalg.norm(L @ y))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--obj", type=str, default=None)
    ap.add_argument("--subdiv", type=int, default=3)
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--col-depth", type=int, default=3)
    ap.add_argument("--fiedler", action="store_true",
                    help="use the spectral-bisection row tree")
    ap.add_argument("--eigensolver", choices=("scipy", "device"),
                    default="scipy")
    ap.add_argument("--device", default=None,
                    help="torch device of the device eigensolver (default: "
                         "the card)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = (resolve_device(args.device) if args.eigensolver == "device"
           else None)
    mesh = Trimesh.from_obj(args.obj) if args.obj else icosphere(args.subdiv)
    print(f"mesh: {mesh.num_verts} vertices, {mesh.num_faces} faces",
          flush=True)

    t0 = time.perf_counter()
    comp = compress_lbo_eigenfunctions(
        mesh, tol=args.tol, col_tree_depth=args.col_depth,
        use_fiedler_tree=args.fiedler, eigensolver=args.eigensolver,
        device=dev)
    setup_s = time.perf_counter() - t0
    rec = {
        "verts": mesh.num_verts, "eigenpairs": int(comp.freqs.size),
        "tol": args.tol, "eigensolver": args.eigensolver,
        "device": None if dev is None else str(dev),
        "setup_s": setup_s,
        "uncompressed_mb": comp.dense_bytes / 1e6,
        "compressed_mb": comp.compressed_bytes / 1e6,
        "compression_rate": comp.compression_rate,
        "eigen_residual": eigen_residual(mesh, comp),
    }
    print(f"streamed {rec['eigenpairs']} eigenpairs [{setup_s:.1f}s]")
    print(f"uncompressed size: {rec['uncompressed_mb']:.2f} MB")
    print(f"compressed size:   {rec['compressed_mb']:.2f} MB")
    print(f"compression rate:  {rec['compression_rate']:.2f}")
    print(f"eigen-residual of compressed apply: {rec['eigen_residual']:.3e}")
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
