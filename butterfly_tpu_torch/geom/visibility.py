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
  octree-leaf AABBs (the octree built by the native treekit), padded and
  kept on the device from build time. The JAX package pads every group to
  one tile shape (an XLA static-shape workaround) and returns to the host
  once a group. Here a ray chunk stays on the device: a slab test in torch
  gives the (ray, group) candidates, listed group-major with one cumsum
  and one scatter; the groups are bucketed by their candidate count and
  their triangle count, each rounded up to a power of two, and each bucket
  runs as batched Möller–Trumbore tiles of (groups, rays, triangles), split
  so that no launch exceeds `tile_elems` ray-triangle pairs; the hits are
  summed into the chunk's output with `index_add_`. The host reads only
  the candidate counts, once a chunk, and the answer at the end.
"""

from __future__ import annotations

import numpy as np
import torch

from butterfly_tpu_torch.utils.device import resolve_device

__all__ = ["ray_hits_any", "segment_occluded", "CulledVisibility"]

_EPS = 1e-9


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of 3, in a fixed order: every tile shape
    then rounds a ray-triangle test alike."""
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def _hits_tile(orig, dirs, tri0, edge1, edge2, tri_idx, skip_idx,
               t_lo: float = 1e-6, t_hi: float = 1.0 - 1e-6):
    """Möller–Trumbore: does ray i hit ANY triangle in the tile?

    orig, dirs: (..., B, 3); tri0/edge1/edge2: (..., F, 3) float32 tensors;
    tri_idx: (..., F) face ids (-2 marks a dead slot); skip_idx: (..., B,
    2) face ids excluded per ray (the ray's own endpoints; -1 for none).
    Leading dims batch tiles. Returns bool (..., B) on the tensors' device.
    """
    o = orig.unsqueeze(-2)  # (..., B, 1, 3)
    d = dirs.unsqueeze(-2)
    e1 = edge1.unsqueeze(-3)  # (..., 1, F, 3)
    e2 = edge2.unsqueeze(-3)
    pvec = torch.linalg.cross(d, e2, dim=-1)  # (..., B, F, 3)
    det = _dot3(pvec, e1)  # (..., B, F)
    live = det.abs() > _EPS
    inv_det = torch.where(live, 1.0 / det, torch.zeros_like(det))
    tvec = o - tri0.unsqueeze(-3)
    u = _dot3(tvec, pvec) * inv_det
    qvec = torch.linalg.cross(tvec, e1, dim=-1)
    v = _dot3(d, qvec) * inv_det
    t = _dot3(e2, qvec) * inv_det
    hit = (live & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > t_lo) & (t < t_hi))
    ti = tri_idx.unsqueeze(-2)
    skip = (ti == skip_idx[..., 0:1]) | (ti == skip_idx[..., 1:2])
    return torch.any(hit & ~skip, dim=-1)


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


def _pow2_at_least(x: np.ndarray, lo: int) -> np.ndarray:
    """Elementwise: the least power of two >= max(x, lo)."""
    x = np.maximum(np.asarray(x, dtype=np.int64), lo)
    return np.left_shift(1, np.ceil(np.log2(x)).astype(np.int64))


class CulledVisibility:
    """Octree-culled occlusion queries over a fixed triangle set.

    Build once per mesh; query with ray batches. The reference reaches the
    same asymptotics through Embree's BVH (src/trimesh.c:460-490); here the
    BVH role is played by an octree over triangle centroids whose leaves
    become padded triangle groups, and traversal is replaced by a slab test
    and batched dense Möller–Trumbore tiles over the (ray, group)
    candidates, all on `device` (default: the card), where the group
    tables live from build time.
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
        # every group padded to one size; a tile reads the first
        # power-of-two slots that cover its groups' triangles
        pad = int(_pow2_at_least(max(g.size for g in groups), 64))
        G = len(groups)
        self.group_lo = np.empty((G, 3), dtype=np.float32)
        self.group_hi = np.empty((G, 3), dtype=np.float32)
        self.group_size = np.array([g.size for g in groups], dtype=np.int64)
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
        self._lo = torch.as_tensor(self.group_lo, device=self.device)
        self._hi = torch.as_tensor(self.group_hi, device=self.device)
        self._tri0 = torch.as_tensor(tri0, device=self.device)
        self._edge1 = torch.as_tensor(edge1, device=self.device)
        self._edge2 = torch.as_tensor(edge2, device=self.device)
        self._tidx = torch.as_tensor(tidx, device=self.device)
        self.num_groups = G
        self.group_pad = pad
        self.syncs = 0  # host reads of candidate counts, one a ray chunk
        # ray-triangle pairs of one batched tile at most: ~40 temporaries
        # of this many float32 elements each, under 1.5 GB
        self.tile_elems = 1 << 23

    def _candidate_mask(self, o, d, t_lo, t_hi):
        """(B, G) bool on the device: may segment o + t*d, t in (t_lo,
        t_hi), intersect group g's AABB? Slab test in float32."""
        lo = self._lo[None, :, :]  # (1, G, 3)
        hi = self._hi[None, :, :]
        o = o[:, None, :]  # (B, 1, 3)
        d = d[:, None, :]
        t1 = (lo - o) / d
        t2 = (hi - o) / d
        near = torch.minimum(t1, t2)
        far = torch.maximum(t1, t2)
        # axis-parallel rays: slab is all-t if origin inside, empty if not
        par = d.abs() <= 1e-12
        inside = (o >= lo) & (o <= hi)
        inf = torch.full((), float("inf"), device=o.device)
        near = torch.where(par, torch.where(inside, -inf, inf), near)
        far = torch.where(par, torch.where(inside, inf, -inf), far)
        tmin = near.amax(dim=-1).clamp_min(t_lo)
        tmax = far.amin(dim=-1).clamp_max(t_hi)
        return tmin <= tmax  # (B, G)

    def ray_hits_any(self, orig, dirs, skip_idx=None,
                     t_lo: float = 1e-6, t_hi: float = 1.0 - 1e-6,
                     ray_chunk: int = 16384):
        """Per-ray occlusion over the culled structure; same semantics as the
        module-level ray_hits_any. Returns a NumPy bool (B,)."""
        o = _f32(orig, self.device)
        d = _f32(dirs, self.device)
        B = o.shape[0]
        skip = _skip_tensor(skip_idx, B, self.device)
        hits = torch.zeros(B, dtype=torch.int32, device=self.device)
        for b0 in range(0, B, ray_chunk):
            b1 = min(B, b0 + ray_chunk)
            self._hits_chunk(o[b0:b1], d[b0:b1], skip[b0:b1], hits[b0:b1],
                             float(t_lo), float(t_hi))
        return (hits > 0).cpu().numpy()

    def _hits_chunk(self, o, d, skip, out, t_lo, t_hi):
        """Add each ray's hits over its candidate groups into `out` (int32,
        the chunk's slice of the answer), on the device."""
        B, G, dev = o.shape[0], self.num_groups, self.device
        cand = self._candidate_mask(o, d, t_lo, t_hi).T  # (G, B)
        pos = torch.cumsum(cand, dim=1)  # 1-based rank of a candidate ray
        counts_t = pos[:, -1]
        counts = counts_t.cpu().numpy()  # the chunk's one host sync
        self.syncs += 1
        total = int(counts.sum())
        if total == 0:
            return
        # the candidate pairs, group-major: group g's rays in ascending
        # order at [starts[g], starts[g] + counts[g]); non-candidates land
        # in the spare slot `total`
        starts_t = torch.cumsum(counts_t, 0) - counts_t
        dest = torch.where(cand, starts_t[:, None] + pos - 1, total)
        rays = torch.empty(total + 1, dtype=torch.int64, device=dev)
        rays.scatter_(0, dest.reshape(-1),
                      torch.arange(B, device=dev).repeat(G))
        # buckets: (candidate rays, triangles) of each group, each rounded
        # up to a power of two; one table for all of them to the device
        live = np.nonzero(counts)[0]
        rp = _pow2_at_least(counts[live], 32)
        tp = _pow2_at_least(self.group_size[live], 32)
        order = np.lexsort((live, tp, rp))
        live, rp, tp = live[order], rp[order], tp[order]
        starts = np.cumsum(counts) - counts
        tab = torch.as_tensor(np.stack([live, starts[live], counts[live]]),
                              device=dev)
        edges = np.flatnonzero(np.diff(rp) | np.diff(tp)) + 1
        for lo_, hi_ in zip(np.r_[0, edges], np.r_[edges, live.size]):
            P, T = int(rp[lo_]), int(tp[lo_])
            pc = min(P, max(1, self.tile_elems // T))  # rays a launch
            gs = max(1, self.tile_elems // (pc * T))  # groups a launch
            for g0 in range(lo_, hi_, gs):
                g_id, st, ct = tab[:, g0:min(g0 + gs, hi_)]
                for c0 in range(0, P, pc):
                    col = torch.arange(c0, c0 + pc, device=dev)
                    valid = col[None, :] < ct[:, None]
                    # padding repeats the group's last candidate, unadded
                    ray = rays[st[:, None] + torch.minimum(
                        col[None, :], ct[:, None] - 1)]
                    hit = _hits_tile(
                        o[ray], d[ray], self._tri0[g_id, :T],
                        self._edge1[g_id, :T], self._edge2[g_id, :T],
                        self._tidx[g_id, :T], skip[ray], t_lo=t_lo,
                        t_hi=t_hi)
                    out.index_add_(0, ray.reshape(-1),
                                   (hit & valid).reshape(-1).to(out.dtype))


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
