"""Fiedler-tree (recursive spectral bisection) construction on a mesh.

Twin of the JAX package's `examples/fiedler_tree.py` (reference:
examples/fiedler_tree): build the geometry-adapted row tree by recursive
Fiedler-vector bisection of the Laplace-Beltrami operator, print its
per-level structure, and compare the balance and locality of its
permutation against the plain octree the streaming LBO pipeline uses.

Both trees are host numpy and scipy, as in the JAX package: nothing of
this twin runs on the card, so it takes no `--device`.

Usage:
  python -m butterfly_tpu_torch.examples.fiedler_tree [--subdiv 3]
      [--leaf-size 64]
  python -m butterfly_tpu_torch.examples.fiedler_tree --obj mesh.obj

Prints one JSON row.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from butterfly_tpu_torch.geom.trimesh import Trimesh, icosphere
from butterfly_tpu_torch.trees import Octree
from butterfly_tpu_torch.trees.fiedler_tree import FiedlerTree


def tree_summary(mesh: Trimesh, tree) -> dict:
    """Node sizes per depth and the mean Euclidean diameter of the
    leaves."""
    sizes_by_depth = {}
    for level in tree.levels():
        if level:
            sizes_by_depth[level[0].depth] = [n.i1 - n.i0 for n in level]
    leaves = [n for n in tree.post_order() if not n.children]
    diam = [float(np.linalg.norm(np.ptp(mesh.verts[tree.perm[n.i0:n.i1]],
                                        axis=0))) for n in leaves]
    return {"depths": {d: {"nodes": len(s), "min": min(s),
                           "median": int(np.median(s)), "max": max(s)}
                       for d, s in sorted(sizes_by_depth.items())},
            "leaves": len(leaves), "mean_leaf_diameter": float(np.mean(diam))}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--obj", type=str, default=None)
    ap.add_argument("--subdiv", type=int, default=3)
    ap.add_argument("--leaf-size", type=int, default=64)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    mesh = Trimesh.from_obj(args.obj) if args.obj else icosphere(args.subdiv)
    print(f"mesh: {mesh.num_verts} vertices, {mesh.num_faces} faces")
    t0 = time.perf_counter()
    ftree = FiedlerTree(mesh, leaf_size=args.leaf_size)
    t_f = time.perf_counter() - t0
    t0 = time.perf_counter()
    otree = Octree(mesh.verts, leaf_size=args.leaf_size)
    t_o = time.perf_counter() - t0
    rec = {"verts": mesh.num_verts, "fiedler_s": t_f, "octree_s": t_o}
    for name, tree in (("fiedler", ftree), ("octree", otree)):
        rec[name] = tree_summary(mesh, tree)
        print(f"{name}:")
        for d, s in rec[name]["depths"].items():
            print(f"  depth {d}: {s['nodes']} nodes, sizes min/median/max = "
                  f"{s['min']}/{s['median']}/{s['max']}")
        print(f"  {rec[name]['leaves']} leaves, mean leaf diameter "
              f"{rec[name]['mean_leaf_diameter']:.3f}")
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
