"""Radiosity: view-factor matrix assembly + radiosity solve on a mesh.

Twin of the JAX package's `examples/radiosity.py` (reference:
examples/radiosity/radiosity.c): load a mesh, assemble the view-factor
matrix by the midpoint rule (src/mat_csr_real.c:387-440), optionally with
batched ray-traced visibility (geom/visibility.py, the Embree
replacement), then solve the radiosity equation (I - diag(rho) F) B = E by
GMRES with a point emitter. F stays dense in float64 on the device.

It prints the JAX script's lines (faces, nonzeros and their share, GMRES
iterations, fixed-point residual, total radiosity) and, beside them, the
assembly and visibility seconds, the ms per matvec of F against its bytes
bound 8 n^2 / 3.35 TB/s (on the card; "not measured" elsewhere) and the
range of F's row sums, then one JSON row.

Usage:
  python -m butterfly_tpu_torch.examples.radiosity [--subdiv 3]
      [--occlusion] [--rho 0.3] [--device cpu]
  python -m butterfly_tpu_torch.examples.radiosity --obj mesh.obj
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from butterfly_tpu_torch.geom.trimesh import Trimesh, icosphere
from butterfly_tpu_torch.models.radiosity import (
    RadiosityModel,
    view_factor_matrix,
)
from butterfly_tpu_torch.utils.device import resolve_device
from butterfly_tpu_torch.utils.timer import device_time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(mesh: Trimesh, rho: float = 0.3, occlusion: bool = False,
        device=None, log=print) -> dict:
    """Assemble F on `device`, solve with E = e_0 and return the numbers
    (with F and B, tensors on the device, under "F" and "B")."""
    dev = resolve_device(device)
    n = mesh.num_faces
    log(f"loaded mesh with {mesh.num_verts} verts and {n} faces")

    tm: dict = {}
    F = view_factor_matrix(mesh, occlusion=occlusion, sparse=False,
                           device=dev, timings=tm)
    # row by row: one bool temporary of F's size would not fit beside F at
    # 10^5 faces
    nnz = sum(int(torch.count_nonzero(F[i:i + 4096]))
              for i in range(0, n, 4096))
    log(f"computed view factor matrix [{tm['assembly_s']:.2f}s, visibility "
        f"{tm['visibility_s']:.2f}s]: shape {tuple(F.shape)}, {nnz} "
        f"nonzeros ({100 * nnz / n**2:.1f}%)")
    rows = F.sum(dim=1)
    row_min, row_max = float(rows.min()), float(rows.max())
    log(f"row sums of F: [{row_min:.6f}, {row_max:.6f}]")

    bound_ms = 1e3 * 8 * n * n / HBM_BYTES_PER_S
    x = torch.ones(n, dtype=torch.float64, device=dev)
    matvec_ms = (1e3 * device_time(lambda: F @ x) if dev.type == "cuda"
                 else None)
    log("matvec: " + ("not measured" if matvec_ms is None
                      else f"{matvec_ms:.3f} ms")
        + f" against the bytes bound {bound_ms:.3f} ms")

    model = RadiosityModel(mesh, rho=rho, apply_F=F, device=dev)
    E = torch.zeros(n, dtype=torch.float64, device=dev)
    E[0] = 1.0
    _sync(dev)
    t0 = time.perf_counter()
    B, iters = model.solve(E)
    _sync(dev)
    solve_s = time.perf_counter() - t0
    log(f"radiosity GMRES solve: {iters} iterations [{solve_s:.2f}s]")
    resid = float(torch.linalg.vector_norm(B - (E + rho * (F @ B))))
    log(f"fixed-point residual: {resid:.3e}")
    total = float(B.sum())
    log(f"total radiosity: {total:.6f} (emitted {float(E.sum()):.1f})")
    return {
        "faces": n, "nnz": nnz, "nnz_frac": nnz / n**2,
        "occlusion": occlusion, "assembly_s": tm["assembly_s"],
        "visibility_s": tm["visibility_s"], "row_sum_min": row_min,
        "row_sum_max": row_max, "matvec_ms": matvec_ms,
        "matvec_bound_ms": bound_ms, "gmres_iters": iters,
        "solve_s": solve_s,
        "ms_per_iter": 1e3 * solve_s / max(iters, 1),
        "fixed_point_residual": resid, "total_radiosity": total,
        "F_bytes": F.numel() * F.element_size(), "device": str(dev),
        "F": F, "B": B,
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--obj", type=str, default=None)
    ap.add_argument("--subdiv", type=int, default=3)
    ap.add_argument("--rho", type=float, default=0.3)
    ap.add_argument("--occlusion", action="store_true",
                    help="ray-traced visibility culling (Embree analogue)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    mesh = Trimesh.from_obj(args.obj) if args.obj else icosphere(args.subdiv)
    rec = run(mesh, rho=args.rho, occlusion=args.occlusion, device=dev)
    row = {k: v for k, v in rec.items() if k not in ("F", "B")}
    if dev.type == "cuda":
        row["card"] = torch.cuda.get_device_name(dev)
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
