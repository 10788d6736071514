"""Radiosity: view-factor operator assembly + radiosity solve.

Reference counterpart: the radiosity example assembles a CSR view-factor
matrix from a triangle mesh using the midpoint rule with Embree-ray
visibility (examples/radiosity/radiosity.c:22,
bfMatCsrRealNewViewFactorMatrixFromTrimesh src/mat_csr_real.c:407-440,
integrateViewFactorMidpointRule src/mat_csr_real.c:387-405).

Port counterpart of `butterfly_tpu/models/radiosity.py` (jitted `jnp` there,
no Pallas kernel): the view-factor kernel F_ij is evaluated for a whole
(rows x cols) tile at once as broadcast float64 torch ops on the device,
visibility is the batched Möller–Trumbore tile of geom/visibility.py, and
the result is returned either dense on the device (the only form that holds
F of 10^5 faces: 53.7 GB in float64 at 81,920) or as scipy CSR (the
reference's container). The radiosity equation (I - diag(rho) F) B = E is
solved by `solve_gmres_plan` in float64 with the Krylov basis on the device,
through any apply of F, so a compressed F drops straight in.
"""

from __future__ import annotations

import math
import time

import numpy as np
import scipy.sparse as sp
import torch

from butterfly_tpu_torch.geom.visibility import segment_occluded
from butterfly_tpu_torch.ops.linalg import solve_gmres_plan
from butterfly_tpu_torch.utils.device import resolve_device

__all__ = ["view_factor_tile", "view_factor_matrix", "RadiosityModel"]


def view_factor_tile(src_cent, src_norm, tgt_cent, tgt_norm, tgt_area):
    """Dense (S, T) tile of midpoint-rule view factors (float64 tensors).

    Exactly the reference quadrature (src/mat_csr_real.c:387-405):
      dp = p_src - p_tgt
      F  = area_tgt * max(0, n_src . dp) * max(0, -n_tgt . dp) / (pi |dp|^4)
    evaluated for all (src, tgt) pairs in one broadcasted pass.
    """
    dp = src_cent[:, None, :] - tgt_cent[None, :, :]  # (S, T, 3)
    dot_src = torch.sum(src_norm[:, None, :] * dp, dim=-1)
    dot_tgt = -torch.sum(tgt_norm[None, :, :] * dp, dim=-1)
    r2 = torch.sum(dp * dp, dim=-1)
    num = (tgt_area[None, :] * torch.clamp(dot_src, min=0.0)
           * torch.clamp(dot_tgt, min=0.0))
    val = num / (math.pi * torch.clamp(r2, min=1e-300) ** 2)
    return torch.where(r2 > 0.0, val, torch.zeros_like(val))  # self-pair


def view_factor_matrix(mesh, row_inds=None, col_inds=None, *,
                       occlusion: bool = False, tile: int = 2048,
                       sparse: bool = True, device=None,
                       timings: dict | None = None):
    """View-factor matrix F[rowInds, colInds] of a trimesh, assembled on
    `device` (default: the card) in float64.

    occlusion=True additionally zeroes pairs whose sightline the mesh blocks
    (the reference's Embree path): each tile's nonzeros, found on the
    device, go through `segment_occluded`. With False only the back-face
    cosine clamps apply (matches a reference build without BF_EMBREE).

    Returns scipy CSR when sparse=True (the reference's container,
    include/bf/mat_csr_real.h:22-36), else the dense float64 tensor on the
    device. `timings`, where given, receives `assembly_s` (all of it, on a
    synchronised clock) and `visibility_s` (the part in `segment_occluded`).
    """
    dev = resolve_device(device)
    t_start = time.perf_counter()
    nf = mesh.num_faces
    row_inds = np.arange(nf) if row_inds is None else np.asarray(row_inds)
    col_inds = np.arange(nf) if col_inds is None else np.asarray(col_inds)

    def f64(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)

    cent = f64(mesh.face_centroids())
    norm = f64(mesh.face_normals())
    area = f64(mesh.face_areas())
    rows = torch.as_tensor(row_inds, dtype=torch.int64, device=dev)
    cols = torch.as_tensor(col_inds, dtype=torch.int64, device=dev)

    S, T = len(row_inds), len(col_inds)
    out = torch.zeros((S, T), dtype=torch.float64, device=dev)
    vis_s = 0.0
    for i0 in range(0, S, tile):
        i1 = min(S, i0 + tile)
        ri = rows[i0:i1]
        for j0 in range(0, T, tile):
            j1 = min(T, j0 + tile)
            cj = cols[j0:j1]
            blk = view_factor_tile(cent[ri], norm[ri], cent[cj], norm[cj],
                                   area[cj])
            if occlusion:
                ii, jj = torch.nonzero(blk, as_tuple=True)
                if ii.numel():
                    t0 = time.perf_counter()
                    occ = segment_occluded(
                        mesh, row_inds[i0:i1][ii.cpu().numpy()],
                        col_inds[j0:j1][jj.cpu().numpy()], device=dev)
                    vis_s += time.perf_counter() - t0
                    occ = torch.as_tensor(occ, device=dev)
                    blk[ii[occ], jj[occ]] = 0.0
            out[i0:i1, j0:j1] = blk
    if timings is not None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        timings["assembly_s"] = time.perf_counter() - t_start
        timings["visibility_s"] = vis_s
    if sparse:
        return sp.csr_matrix(out.cpu().numpy())
    return out


class RadiosityModel:
    """Radiosity solve B = E + diag(rho) F B on a trimesh, on `device`
    (default: the card).

    `apply_F` may be the dense tensor or CSR matrix of view_factor_matrix,
    a host LinOp, or any callable taking and returning a device tensor
    (e.g. a butterfly-compressed F), mirroring how every reference solver
    works on abstract BfMat operators (src/linalg.c:47). With none given, F
    is assembled dense on the device."""

    def __init__(self, mesh, rho, apply_F=None, device=None, **vf_kw):
        self.mesh = mesh
        self.device = dev = resolve_device(device)
        n = mesh.num_faces
        self.rho = torch.as_tensor(
            np.broadcast_to(np.asarray(rho, dtype=np.float64), (n,)).copy(),
            device=dev)
        if apply_F is None:
            apply_F = view_factor_matrix(mesh, sparse=False, device=dev,
                                         **vf_kw)
        if sp.issparse(apply_F):
            C = apply_F.tocsr()
            apply_F = torch.sparse_csr_tensor(
                torch.as_tensor(C.indptr, dtype=torch.int64),
                torch.as_tensor(C.indices, dtype=torch.int64),
                torch.as_tensor(C.data, dtype=torch.float64), size=C.shape,
                check_invariants=True).to(dev)
        if isinstance(apply_F, torch.Tensor):
            F = apply_F.to(dev)
            self.apply_F = lambda x: F @ x
        elif hasattr(apply_F, "matvec"):
            op = apply_F
            self.apply_F = lambda x: torch.as_tensor(
                op.matvec(x.cpu().numpy()), device=x.device)
        else:
            self.apply_F = apply_F

    def solve(self, emission, tol: float = 1e-10, max_iter: int = 200):
        """GMRES solve of (I - diag(rho) F) B = E in float64, one cycle of
        up to max_iter steps (the JAX host solve's restart=None); returns
        (B, num_iters) with B on the device."""
        n = self.mesh.num_faces
        e = torch.as_tensor(emission, dtype=torch.float64,
                            device=self.device).reshape(n)

        def mv(x):
            return x - self.rho * self.apply_F(x).reshape(n)

        res = solve_gmres_plan(mv, e, tol=tol, restart=max_iter,
                               max_iter=max_iter)
        return torch.as_tensor(res.x, device=self.device), res.num_iter
