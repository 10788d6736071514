"""Batched ray-traced visibility on triangle meshes (the Embree
replacement).

The reference gates its radiosity view-factor assembly on Embree 4 ray
queries (reference: bfTrimeshGetVisibility src/trimesh.c:1632-1690, used by
bfMatCsrRealNewViewFactorMatrixFromTrimesh src/mat_csr_real.c:407-440, both
compiled only under BF_EMBREE). Here visibility is a batched Möller–Trumbore
ray/triangle intersection evaluated as broadcast tensor ops: a (rays x
triangles) tile of intersection tests in float32, chunked to bound memory.

Port counterpart of `butterfly_tpu/geom/visibility.py`, where the tile is
jitted `jnp` (no Pallas kernel); here it is eager torch ops on the card.
Two regimes, as there:

- `ray_hits_any`: brute-force tiles, resident on the device for the whole
  query; one copy back to the host at the end.
- `CulledVisibility`: the Embree-BVH analogue. Triangles are grouped into
  octree-leaf AABBs on the host, padded to one power of two (one tile
  shape) and kept on the device from build time; a vectorized NumPy slab
  test prunes which (ray-bucket x tri-group) tiles run, groups are visited
  densest first, and rays already occluded are dropped from later groups.
  Each group's answers come back to the host (`out[sel] |= hits`) before
  the next group's selection: the JAX design, kept as it is.
"""

from __future__ import annotations

import numpy as np
import torch

from butterfly_tpu_torch.utils.device import resolve_device

__all__ = ["ray_hits_any", "segment_occluded", "CulledVisibility"]

_EPS = 1e-9


def _hits_tile(orig, dirs, tri0, edge1, edge2, tri_idx, skip_idx,
               t_lo: float = 1e-6, t_hi: float = 1.0 - 1e-6):
    """Möller–Trumbore: does ray i hit ANY triangle in the tile?

    orig, dirs: (B, 3); tri0/edge1/edge2: (F, 3) float32 tensors; tri_idx:
    (F,) face ids (-2 marks a dead slot); skip_idx: (B, 2) face ids
    excluded per ray (the ray's own endpoints; -1 for none). Returns bool
    (B,) on the tensors' device.
    """
    o = orig[:, None, :]  # (B, 1, 3)
    d = dirs[:, None, :]
    e1 = edge1[None, :, :]
    e2 = edge2[None, :, :]
    pvec = torch.linalg.cross(d, e2, dim=-1)  # (B, F, 3)
    det = torch.sum(pvec * e1, dim=-1)  # (B, F)
    live = det.abs() > _EPS
    inv_det = torch.where(live, 1.0 / det, torch.zeros_like(det))
    tvec = o - tri0[None, :, :]
    u = torch.sum(tvec * pvec, dim=-1) * inv_det
    qvec = torch.linalg.cross(tvec, e1, dim=-1)
    v = torch.sum(d * qvec, dim=-1) * inv_det
    t = torch.sum(e2 * qvec, dim=-1) * inv_det
    hit = (live & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > t_lo) & (t < t_hi))
    skip = ((tri_idx[None, :] == skip_idx[:, 0:1])
            | (tri_idx[None, :] == skip_idx[:, 1:2]))
    return torch.any(hit & ~skip, dim=1)


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)


def _skip_tensor(skip_idx, B: int, device) -> torch.Tensor:
    if skip_idx is None:
        return torch.full((B, 2), -1, dtype=torch.int32, device=device)
    return torch.as_tensor(np.asarray(skip_idx, dtype=np.int32),
                           device=device)


def ray_hits_any(orig, dirs, tris, skip_idx=None, t_lo=1e-6, t_hi=1.0 - 1e-6,
                 ray_chunk: int = 4096, tri_chunk: int = 4096, device=None):
    """For each ray (orig[i], dirs[i]) report whether any triangle of `tris`
    (F, 3, 3) blocks it within parametric range (t_lo, t_hi).

    skip_idx: optional (B, 2) int face indices ignored per ray. Runs on
    `device` (default: the card) in float32; returns a NumPy bool (B,).
    """
    dev = resolve_device(device)
    tris = np.asarray(tris, dtype=np.float32)
    o = _f32(orig, dev)
    d = _f32(dirs, dev)
    B, F = o.shape[0], tris.shape[0]
    skip = _skip_tensor(skip_idx, B, dev)
    tri0 = _f32(tris[:, 0], dev)
    edge1 = _f32(tris[:, 1] - tris[:, 0], dev)
    edge2 = _f32(tris[:, 2] - tris[:, 0], dev)
    tri_idx = torch.arange(F, dtype=torch.int32, device=dev)

    out = torch.zeros(B, dtype=torch.bool, device=dev)
    for b0 in range(0, B, ray_chunk):
        b1 = min(B, b0 + ray_chunk)
        for f0 in range(0, F, tri_chunk):
            f1 = min(F, f0 + tri_chunk)
            out[b0:b1] |= _hits_tile(
                o[b0:b1], d[b0:b1], tri0[f0:f1], edge1[f0:f1], edge2[f0:f1],
                tri_idx[f0:f1], skip[b0:b1],
                t_lo=float(t_lo), t_hi=float(t_hi),
            )
    return out.cpu().numpy()


def _round_up_pow2(x: int, lo: int = 128) -> int:
    p = lo
    while p < x:
        p *= 2
    return p


class CulledVisibility:
    """Octree-culled occlusion queries over a fixed triangle set.

    Build once per mesh; query with ray batches. The reference reaches the
    same asymptotics through Embree's BVH (src/trimesh.c:460-490); here the
    BVH role is played by an octree over triangle centroids whose leaves
    become padded, static-shape triangle groups, and traversal is replaced by
    a vectorized slab test + per-group dense Möller–Trumbore tiles. The
    group tables live on `device` (default: the card) from build time.
    """

    def __init__(self, tris, leaf_size: int = 512, tri_idx=None,
                 device=None):
        from butterfly_tpu_torch.trees.point_tree import Octree

        self.device = resolve_device(device)
        tris = np.asarray(tris, dtype=np.float32)
        F = tris.shape[0]
        if tri_idx is None:
            tri_idx = np.arange(F, dtype=np.int32)
        self.num_tris = F
        cent = tris.mean(axis=1).astype(np.float64)
        tree = Octree(cent, leaf_size=leaf_size)
        groups = []
        for node in tree.post_order():
            if node.is_leaf and node.num_points:
                groups.append(
                    np.asarray(tree.perm[node.i0:node.i1], dtype=np.int64)
                )
        # pad every group to one common size: ONE tile shape total
        pad = _round_up_pow2(max(g.size for g in groups), lo=64)
        G = len(groups)
        self.group_lo = np.empty((G, 3), dtype=np.float32)
        self.group_hi = np.empty((G, 3), dtype=np.float32)
        tri0 = np.zeros((G, pad, 3), dtype=np.float32)
        edge1 = np.zeros((G, pad, 3), dtype=np.float32)
        edge2 = np.zeros((G, pad, 3), dtype=np.float32)
        tidx = np.full((G, pad), -2, dtype=np.int32)  # -2 = dead slot
        for g, idx in enumerate(groups):
            t = tris[idx]
            verts = t.reshape(-1, 3)
            self.group_lo[g] = verts.min(axis=0)
            self.group_hi[g] = verts.max(axis=0)
            k = idx.size
            tri0[g, :k] = t[:, 0]
            edge1[g, :k] = t[:, 1] - t[:, 0]
            edge2[g, :k] = t[:, 2] - t[:, 0]
            tidx[g, :k] = tri_idx[idx]
        self._tri0 = torch.as_tensor(tri0, device=self.device)
        self._edge1 = torch.as_tensor(edge1, device=self.device)
        self._edge2 = torch.as_tensor(edge2, device=self.device)
        self._tidx = torch.as_tensor(tidx, device=self.device)
        self.num_groups = G
        self.group_pad = pad

    def _candidate_mask(self, orig, dirs, t_lo, t_hi):
        """(B, G) bool: may segment orig + t*dirs, t in (t_lo, t_hi),
        intersect group g's AABB? Vectorized slab test."""
        lo = self.group_lo[None, :, :]  # (1, G, 3)
        hi = self.group_hi[None, :, :]
        o = orig[:, None, :].astype(np.float32)  # (B, 1, 3)
        d = dirs[:, None, :].astype(np.float32)
        with np.errstate(divide="ignore", invalid="ignore"):
            t1 = (lo - o) / d
            t2 = (hi - o) / d
        near = np.minimum(t1, t2)
        far = np.maximum(t1, t2)
        # axis-parallel rays: slab is all-t if origin inside, empty if not
        par = np.abs(d) <= 1e-12
        inside = (o >= lo) & (o <= hi)
        near = np.where(par, np.where(inside, -np.inf, np.inf), near)
        far = np.where(par, np.where(inside, np.inf, -np.inf), far)
        tmin = np.maximum(near.max(axis=-1), t_lo)
        tmax = np.minimum(far.min(axis=-1), t_hi)
        return tmin <= tmax  # (B, G)

    def ray_hits_any(self, orig, dirs, skip_idx=None,
                     t_lo: float = 1e-6, t_hi: float = 1.0 - 1e-6,
                     ray_chunk: int = 16384):
        """Per-ray occlusion over the culled structure; same semantics as the
        module-level ray_hits_any. Returns a NumPy bool (B,)."""
        orig = np.asarray(orig, dtype=np.float32)
        dirs = np.asarray(dirs, dtype=np.float32)
        B = orig.shape[0]
        skip = _skip_tensor(skip_idx, B, self.device)
        o = torch.as_tensor(orig, device=self.device)
        d = torch.as_tensor(dirs, device=self.device)
        out = np.zeros(B, dtype=bool)
        for b0 in range(0, B, ray_chunk):
            b1 = min(B, b0 + ray_chunk)
            out[b0:b1] = self._hits_chunk(
                orig[b0:b1], dirs[b0:b1], o[b0:b1], d[b0:b1], skip[b0:b1],
                t_lo, t_hi,
            )
        return out

    def _hits_chunk(self, orig, dirs, o, d, skip, t_lo, t_hi):
        """orig/dirs: the chunk's rays on the host (for the slab test);
        o/d/skip: the same rays on the device."""
        B = orig.shape[0]
        cand = self._candidate_mask(orig, dirs, t_lo, t_hi)  # (B, G)
        out = np.zeros(B, dtype=bool)
        # visit dense groups first so the early-exit drops the most rays
        order = np.argsort(-cand.sum(axis=0))
        for g in order:
            sel = np.nonzero(cand[:, g] & ~out)[0]
            if sel.size == 0:
                continue
            m = _round_up_pow2(sel.size, lo=64)
            pad_sel = torch.as_tensor(
                np.pad(sel, (0, m - sel.size), mode="edge"),
                device=self.device)
            hits = _hits_tile(
                o[pad_sel], d[pad_sel], self._tri0[g], self._edge1[g],
                self._edge2[g], self._tidx[g], skip[pad_sel],
                t_lo=float(t_lo), t_hi=float(t_hi),
            ).cpu().numpy()
            out[sel] |= hits[: sel.size]
        return out


def _mesh_culled(mesh, leaf_size: int = 512, device=None) -> CulledVisibility:
    """Cached CulledVisibility for a mesh (built on first use, and again
    for another device)."""
    dev = resolve_device(device)
    cv = getattr(mesh, "_culled_vis", None)
    if cv is None or cv.num_tris != mesh.num_faces or cv.device != dev:
        cv = CulledVisibility(mesh.verts[mesh.faces], leaf_size=leaf_size,
                              device=dev)
        try:
            mesh._culled_vis = cv
        except AttributeError:
            pass
    return cv


def segment_occluded(mesh, src_faces, tgt_faces, culled: bool | None = None,
                     device=None, **kw):
    """Is the centroid->centroid segment between face pairs blocked by the
    mesh (excluding the two endpoint faces)? src_faces/tgt_faces: (B,) ids.

    Reference behavior: bfTrimeshGetVisibility casts one ray per (src, tgt)
    face pair and filters out hits on the endpoints
    (src/trimesh.c:1612-1690).

    culled=True routes through the octree-culled structure (cached on the
    mesh); None picks it automatically for meshes past the brute-force
    sweet spot (more than 2048 faces).
    """
    src_faces = np.asarray(src_faces, dtype=np.int32)
    tgt_faces = np.asarray(tgt_faces, dtype=np.int32)
    cent = mesh.face_centroids()
    orig = cent[src_faces]
    dirs = cent[tgt_faces] - orig
    skip = np.stack([src_faces, tgt_faces], axis=1)
    if culled is None:
        culled = mesh.num_faces > 2048
    if culled:
        cv = _mesh_culled(mesh, device=device)
        return cv.ray_hits_any(orig, dirs, skip_idx=skip, **kw)
    tris = mesh.verts[mesh.faces]
    return ray_hits_any(orig, dirs, tris, skip_idx=skip, device=device, **kw)
