"""Gaussian-process covariance operators on a mesh: exact vs fast paths.

Twin of the JAX package's `examples/covariance.py` (reference: the
examples/covariance family). It applies a spectrally defined covariance
C = Phi gamma(Lam) Phi^T two ways:

  cheb: matrix-free Chebyshev polynomial of M^{-1} L (reference:
        cheb_cov.c), no eigensolve at all;
  fast: through the butterfly-COMPRESSED eigenbasis from the streaming LBO
        pipeline (reference: lbo_cov.c),

then cross-checks them against each other and draws a GP sample. Both
applies are host float64, as in the JAX package; `--eigensolver device`
computes the compressed basis's eigenbands on the card (`--device cpu`
runs them on the CPU), `scipy` (the default, as the JAX script) on the
host.

Usage:
  python -m butterfly_tpu_torch.examples.covariance [--subdiv 2]
      [--kappa 0.1] [--nu NU] [--tol 1e-8] [--cheb-order 96]
      [--eigensolver {scipy,device}] [--device cpu]

Prints one JSON row.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from butterfly_tpu_torch.geom.trimesh import Trimesh, icosphere
from butterfly_tpu_torch.models.covariance import (
    CompressedCovariance,
    chebyshev_covariance_apply,
    matern_density,
    squared_exponential_density,
)
from butterfly_tpu_torch.models.lbo import compress_lbo_eigenfunctions
from butterfly_tpu_torch.utils.device import resolve_device


def fast_vs_cheb(mesh: Trimesh, comp, gamma, cheb_order: int,
                 seed: int = 0) -> dict:
    """C (M w) through the compressed basis against the Chebyshev apply of
    C w (the polynomial of S = M^{-1} L gives Phi g(Lam) Phi^T M w, so the
    compressed path gets M w), w from `default_rng(seed)`; then a GP
    sample from the same generator."""
    n = mesh.num_verts
    cov = CompressedCovariance(comp)
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(n)
    L, M = mesh.lbo_fem()
    t0 = time.perf_counter()
    cw_fast = cov.apply(gamma, np.asarray(M @ w))
    t_fast = time.perf_counter() - t0
    lam_max = float(comp.freqs.max() ** 2)
    t0 = time.perf_counter()
    cw_cheb = chebyshev_covariance_apply(L, M, gamma, w, lam_max,
                                         order=cheb_order)
    t_cheb = time.perf_counter() - t0
    z = cov.sample(gamma, rng.standard_normal(comp.freqs.size))
    return {"fast_ms": 1e3 * t_fast, "cheb_ms": 1e3 * t_cheb,
            "rel_diff_fast_vs_cheb": float(
                np.linalg.norm(cw_fast - cw_cheb) / np.linalg.norm(cw_cheb)),
            "sample_mean": float(z.mean()), "sample_std": float(z.std())}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--obj", type=str, default=None)
    ap.add_argument("--subdiv", type=int, default=2)
    ap.add_argument("--kappa", type=float, default=0.1)
    ap.add_argument("--nu", type=float, default=None,
                    help="Matern smoothness (default: squared exponential)")
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--cheb-order", type=int, default=96)
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
    gamma = (matern_density(args.kappa, args.nu) if args.nu
             else squared_exponential_density(args.kappa))

    t0 = time.perf_counter()
    comp = compress_lbo_eigenfunctions(mesh, tol=args.tol,
                                       eigensolver=args.eigensolver,
                                       device=dev)
    setup_s = time.perf_counter() - t0
    print(f"compressed eigenbasis: {comp.freqs.size} eigenpairs, "
          f"compression rate {comp.compression_rate:.2f} [{setup_s:.1f}s]")
    rec = {"verts": mesh.num_verts, "eigenpairs": int(comp.freqs.size),
           "eigensolver": args.eigensolver,
           "device": None if dev is None else str(dev),
           "setup_s": setup_s, "compression_rate": comp.compression_rate,
           **fast_vs_cheb(mesh, comp, gamma, args.cheb_order)}
    print(f"C w (fast, compressed basis): {rec['fast_ms']:.1f} ms")
    print(f"C w (Chebyshev, matrix-free): {rec['cheb_ms']:.1f} ms")
    print(f"rel l2 difference fast vs cheb: "
          f"{rec['rel_diff_fast_vs_cheb']:.3e}")
    print(f"GP sample: mean {rec['sample_mean']:+.3e}, std "
          f"{rec['sample_std']:.3e}")
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
