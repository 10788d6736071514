"""Triangle meshes and P1 FEM Laplace-Beltrami assembly.

Replacement for the reference's trimesh module (src/trimesh.c, 1795 LoC):
OBJ load, adjacency, boundary detection, and the piecewise-linear FEM
discretization of the Laplace-Beltrami operator
(bfTrimeshGetLboFemDiscretization, src/trimesh.c:1470-1610) — the same hat-
function gradient stiffness and consistent mass (A/6 diagonal, A/12
off-diagonal), assembled vectorized into scipy CSR instead of per-vertex C
loops. Also the Fiedler vector (bfTrimeshGetFiedler, src/trimesh.c:1300-1367)
used by the spectral-bisection tree.

Port counterpart of `butterfly_tpu/geom/trimesh.py`. As there, OBJ
loading, boundary edges and the FEM assembly run in the native C++ mesh
kit (`geom/native.py`, `csrc/meshkit.cpp`) unless called with
`use_native=False`, which runs the vectorized NumPy code below, the oracle
the kit is tested against. Unlike the JAX package, which quietly takes
NumPy when its kit is missing, a kit that does not build or load raises.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from butterfly_tpu_torch.utils.errors import InvalidArgumentsError, check

__all__ = ["Trimesh", "icosphere"]


class Trimesh:
    """Triangle mesh: verts (nv, 3) float64, faces (nf, 3) int."""

    def __init__(self, verts: np.ndarray, faces: np.ndarray):
        self.verts = np.asarray(verts, dtype=np.float64)
        self.faces = np.asarray(faces, dtype=np.int64)
        check(self.verts.ndim == 2 and self.verts.shape[1] == 3,
              "verts must be (nv, 3)", InvalidArgumentsError)
        check(self.faces.ndim == 2 and self.faces.shape[1] == 3,
              "faces must be (nf, 3)", InvalidArgumentsError)
        check(self.faces.min(initial=0) >= 0
              and self.faces.max(initial=-1) < len(self.verts),
              "face indices out of range", InvalidArgumentsError)

    # -- I/O -------------------------------------------------------------

    @classmethod
    def from_obj(cls, path: str, use_native: bool = True) -> "Trimesh":
        """OBJ reader: v and f records, fan-triangulated
        (reference: bfTrimeshNewFromObjFile). The native C++ parser
        (`csrc/meshkit.cpp`) unless `use_native=False`, which runs the
        Python one."""
        if use_native:
            from butterfly_tpu_torch.geom.native import load_obj_native

            return cls(*load_obj_native(path))
        verts, faces = [], []
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                if parts[0] == "v":
                    verts.append([float(x) for x in parts[1:4]])
                elif parts[0] == "f":
                    idx = [int(p.split("/")[0]) - 1 for p in parts[1:]]
                    for k in range(1, len(idx) - 1):  # fan-triangulate
                        faces.append([idx[0], idx[k], idx[k + 1]])
        return cls(np.asarray(verts), np.asarray(faces))

    def save_obj(self, path: str) -> None:
        with open(path, "w") as f:
            for v in self.verts:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
            for t in self.faces:
                f.write(f"f {t[0]+1} {t[1]+1} {t[2]+1}\n")

    # -- topology --------------------------------------------------------

    @property
    def num_verts(self) -> int:
        return len(self.verts)

    @property
    def num_faces(self) -> int:
        return len(self.faces)

    def edges(self) -> np.ndarray:
        """Unique undirected edges (ne, 2), sorted."""
        e = np.concatenate(
            [self.faces[:, [0, 1]], self.faces[:, [1, 2]], self.faces[:, [2, 0]]]
        )
        e.sort(axis=1)
        return np.unique(e, axis=0)

    def boundary_edges(self, use_native: bool = True) -> np.ndarray:
        """Edges incident to exactly one face (reference: boundary detection
        in src/trimesh.c), sorted. Native C++ half-edge counting unless
        `use_native=False`."""
        if use_native:
            from butterfly_tpu_torch.geom.native import boundary_edges_native

            return boundary_edges_native(self.faces)
        e = np.concatenate(
            [self.faces[:, [0, 1]], self.faces[:, [1, 2]], self.faces[:, [2, 0]]]
        )
        e.sort(axis=1)
        uniq, counts = np.unique(e, axis=0, return_counts=True)
        return uniq[counts == 1]

    def boundary_verts(self) -> np.ndarray:
        be = self.boundary_edges()
        return np.unique(be) if len(be) else np.empty(0, dtype=np.int64)

    def interior_mask(self) -> np.ndarray:
        mask = np.ones(self.num_verts, dtype=bool)
        mask[self.boundary_verts()] = False
        return mask

    def vertex_adjacency(self) -> sp.csr_matrix:
        e = self.edges()
        data = np.ones(len(e))
        A = sp.coo_matrix(
            (np.concatenate([data, data]),
             (np.concatenate([e[:, 0], e[:, 1]]),
              np.concatenate([e[:, 1], e[:, 0]]))),
            shape=(self.num_verts, self.num_verts),
        )
        return A.tocsr()

    def face_areas(self) -> np.ndarray:
        p = self.verts[self.faces]
        n = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
        return 0.5 * np.linalg.norm(n, axis=1)

    def face_centroids(self) -> np.ndarray:
        """(F, 3) face centroids (reference:
        bfTrimeshGetFaceCentroidConstPtr, used by the view-factor midpoint
        rule src/mat_csr_real.c:388-389)."""
        return self.verts[self.faces].mean(axis=1)

    def face_normals(self) -> np.ndarray:
        """(F, 3) unit face normals with winding orientation (reference:
        bfTrimeshGetFaceUnitNormalConstPtr; orientation matching
        bfTrimeshComputeFaceNormalsMatchingVertexNormals,
        examples/radiosity/radiosity.c:15-16)."""
        p = self.verts[self.faces]
        n = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
        norm = np.linalg.norm(n, axis=1, keepdims=True)
        return n / np.maximum(norm, 1e-300)

    def level_set_submesh(
        self, phi: np.ndarray, tol: float = 1e-12
    ) -> tuple["Trimesh", np.ndarray]:
        """Exact submesh of the region {phi <= 0}, splitting cut faces at
        the zero level set.

        Reference: bfTrimeshGetLevelSetSubmesh
        (src/trimesh.get_level_set_submesh.c:821-...): contained faces are
        kept whole (addContainedFaces :198-229), faces the level set crosses
        are split at linearly-interpolated cut vertices on their edges
        (appendCutVertex :310-343; the 2-1 / 1-2 sign patterns
        addCutFacesAndVerts_case21/_case12 :345-534, on-vertex crossings
        handled by snapping |phi| <= tol to zero, the analogue of case111
        :552-700), and isolated vertices are dropped
        (eliminateIsolatedVerts :736-775).

        Returns (submesh, orig_ids) where orig_ids[k] is the original index
        of submesh vertex k, or -1 for a cut vertex created on an edge.
        """
        phi = np.asarray(phi, dtype=np.float64).copy()
        check(phi.shape == (self.num_verts,), "phi must be per-vertex")
        phi[np.abs(phi) <= tol] = 0.0

        new_verts: list[np.ndarray] = []
        orig_ids: list[int] = []
        vmap: dict[int, int] = {}  # original vert -> new index
        cut_cache: dict[tuple[int, int], int] = {}  # edge -> new cut index
        faces: list[tuple[int, int, int]] = []

        def keep_vert(i: int) -> int:
            j = vmap.get(i)
            if j is None:
                j = len(new_verts)
                vmap[i] = j
                new_verts.append(self.verts[i])
                orig_ids.append(i)
            return j

        def cut_vert(i0: int, i1: int) -> int:
            key = (i0, i1) if i0 < i1 else (i1, i0)
            j = cut_cache.get(key)
            if j is None:
                t = phi[i0] / (phi[i0] - phi[i1])
                v = (1 - t) * self.verts[i0] + t * self.verts[i1]
                j = len(new_verts)
                cut_cache[key] = j
                new_verts.append(v)
                orig_ids.append(-1)
            return j

        for f in self.faces:
            s = phi[f]
            inside = s <= 0.0
            n_in = int(inside.sum())
            if n_in == 0:
                continue
            if n_in == 3:
                faces.append(tuple(keep_vert(i) for i in f))
                continue
            # rotate (winding-preserving) to the canonical sign pattern:
            # n_in==1 -> inside vertex first; n_in==2 -> outside vertex last
            for rot in range(3):
                fr = np.roll(f, -rot)
                sr = phi[fr] <= 0.0
                if (n_in == 1 and sr[0] and not sr[1] and not sr[2]) or (
                    n_in == 2 and sr[0] and sr[1] and not sr[2]
                ):
                    break
            a, b, c = (int(v) for v in fr)
            if n_in == 1:
                # corner triangle (a, cut_ab, cut_ca); a exactly on the
                # level set gives a zero-area corner -> skip (case111
                # analogue after snapping)
                if phi[a] == 0.0:
                    continue
                faces.append((keep_vert(a), cut_vert(a, b), cut_vert(c, a)))
            else:
                # quad (a, b, cut_bc, cut_ca) -> two triangles, degenerating
                # cleanly when a or b sits exactly on the level set
                if phi[a] == 0.0 and phi[b] == 0.0:
                    continue  # intersection is just the edge ab
                if phi[a] == 0.0:
                    faces.append((keep_vert(a), keep_vert(b), cut_vert(b, c)))
                elif phi[b] == 0.0:
                    faces.append((keep_vert(a), keep_vert(b), cut_vert(c, a)))
                else:
                    ja, jb = keep_vert(a), keep_vert(b)
                    jbc, jca = cut_vert(b, c), cut_vert(c, a)
                    faces.append((ja, jb, jbc))
                    faces.append((ja, jbc, jca))

        # eliminate isolated verts (kept verts not referenced by any face)
        used = np.zeros(len(new_verts), dtype=bool)
        fa = np.asarray(faces, dtype=np.int64).reshape(-1, 3)
        if fa.size:
            used[fa.ravel()] = True
        remap = -np.ones(len(new_verts), dtype=np.int64)
        remap[used] = np.arange(int(used.sum()))
        verts = np.asarray(new_verts)[used]
        ids = np.asarray(orig_ids, dtype=np.int64)[used]
        fa = remap[fa]
        return Trimesh(verts, fa), ids

    def submesh(self, vert_mask: np.ndarray) -> tuple["Trimesh", np.ndarray]:
        """Induced submesh on masked vertices: keeps faces whose three
        vertices are all selected. Returns (mesh, old_vertex_indices).

        NOTE: the reference extracts exact level-set submeshes with edge
        splitting (trimesh.get_level_set_submesh.c); the induced subgraph is
        a simplification adequate for spectral-bisection trees.
        """
        vert_mask = np.asarray(vert_mask, dtype=bool)
        old_idx = np.flatnonzero(vert_mask)
        remap = -np.ones(self.num_verts, dtype=np.int64)
        remap[old_idx] = np.arange(old_idx.size)
        keep = vert_mask[self.faces].all(axis=1)
        return Trimesh(self.verts[old_idx], remap[self.faces[keep]]), old_idx

    # -- FEM -------------------------------------------------------------

    def lbo_fem(self, use_native: bool = True
                ) -> tuple[sp.csr_matrix, sp.csr_matrix]:
        """P1 FEM stiffness L and consistent mass M of the Laplace-Beltrami
        operator (reference: bfTrimeshGetLboFemDiscretization,
        src/trimesh.c:1470-1610). Vectorized over faces:

        local stiffness entries are A * grad(phi_a) . grad(phi_b) — the
        classical cotan weights — and the local mass is A/6 on the diagonal,
        A/12 off.

        The native C++ element assembly (`csrc/meshkit.cpp`) unless
        `use_native=False`, which runs the vectorized NumPy path below, the
        oracle the native path is tested against (they agree to 1e-14).
        """
        nv = self.num_verts
        if use_native:
            from butterfly_tpu_torch.geom.native import lbo_fem_native

            nrows, ncols, nLv, nMv = lbo_fem_native(self.verts, self.faces)
            L = sp.coo_matrix((nLv, (nrows, ncols)), shape=(nv, nv)).tocsr()
            M = sp.coo_matrix((nMv, (nrows, ncols)), shape=(nv, nv)).tocsr()
            return L, M
        f = self.faces
        p = self.verts[f]  # (nf, 3, 3)
        # edge vectors opposite each vertex: e_a = x_c - x_b
        e0 = p[:, 2] - p[:, 1]
        e1 = p[:, 0] - p[:, 2]
        e2 = p[:, 1] - p[:, 0]
        n = np.cross(e1, e2)
        A2 = np.linalg.norm(n, axis=1)  # 2 * area
        area = 0.5 * A2
        check(np.all(area > 0), "degenerate faces in mesh", InvalidArgumentsError)
        # grad(phi_a) = (n x e_a) / (2A) rotated in-plane; the stiffness
        # entries reduce to the cotan formula:
        #   L_ab += -cot(theta_c)/2 for the edge (a, b) opposite vertex c,
        #   L_aa += sum of adjacent off-diagonal magnitudes.
        # cot(theta_c) = (e_a . e_b) / (2A) with appropriate signs:
        def dot(u, v):
            return np.einsum("ij,ij->i", u, v)

        cot0 = dot(e1, e2) * -1.0 / A2  # angle at vertex 0 between -e1, e2...
        cot1 = dot(e2, e0) * -1.0 / A2
        cot2 = dot(e0, e1) * -1.0 / A2

        rows, cols, vals = [], [], []
        mrows, mcols, mvals = [], [], []
        for (a, b, cot) in ((1, 2, cot0), (2, 0, cot1), (0, 1, cot2)):
            w = 0.5 * cot
            rows += [f[:, a], f[:, b], f[:, a], f[:, b]]
            cols += [f[:, b], f[:, a], f[:, a], f[:, b]]
            vals += [-w, -w, w, w]
        for a in range(3):
            mrows.append(f[:, a])
            mcols.append(f[:, a])
            mvals.append(area / 6.0)
            b = (a + 1) % 3
            mrows += [f[:, a], f[:, b]]
            mcols += [f[:, b], f[:, a]]
            mvals += [area / 12.0, area / 12.0]

        L = sp.coo_matrix(
            (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
            shape=(nv, nv),
        ).tocsr()
        M = sp.coo_matrix(
            (np.concatenate(mvals), (np.concatenate(mrows), np.concatenate(mcols))),
            shape=(nv, nv),
        ).tocsr()
        return L, M

    def fiedler_vector(self) -> np.ndarray:
        """First nonconstant LBO eigenfunction on interior vertices, zero on
        the boundary (reference: bfTrimeshGetFiedler,
        src/trimesh.c:1300-1367)."""
        from butterfly_tpu_torch.ops.linalg import get_shifted_eigs

        L, M = self.lbo_fem()
        mask = self.interior_mask()
        if mask.sum() < 3:
            mask = np.ones(self.num_verts, dtype=bool)
        idx = np.flatnonzero(mask)
        Li = L[np.ix_(idx, idx)].tocsc()
        Mi = M[np.ix_(idx, idx)].tocsc()
        vals, vecs = get_shifted_eigs(Li, Mi, -1e-3, 2)
        phi = np.zeros(self.num_verts)
        phi[idx] = vecs[:, 1]
        return phi


def icosphere(subdivisions: int = 3, radius: float = 1.0) -> Trimesh:
    """Subdivided icosahedron — test geometry generator (replaces the
    reference's checked-in tests/sphere.obj)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    for _ in range(subdivisions):
        edge_mid: dict[tuple[int, int], int] = {}
        new_faces = []
        verts_list = list(verts)

        def midpoint(a: int, b: int) -> int:
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                verts_list.append(0.5 * (verts_list[a] + verts_list[b]))
                edge_mid[key] = len(verts_list) - 1
            return edge_mid[key]

        for (a, b, c) in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, dtype=np.int64)
    verts = verts / np.linalg.norm(verts, axis=1)[:, None] * radius
    return Trimesh(verts, faces)
