// meshkit: native mesh runtime for butterfly_tpu_torch.
//
// A copy of the JAX package's `native/meshkit.cpp`, unchanged below this
// header, so that the port builds its own library and reads nothing under
// `native/`. The reference keeps its whole mesh pipeline in C
// (src/trimesh.c: OBJ load bfTrimeshNewFromObjFile, boundary detection, and
// the P1 FEM Laplace-Beltrami assembly bfTrimeshGetLboFemDiscretization,
// src/trimesh.c:1470-1610). This is the host-side (setup-time) part of that
// pipeline, exposed through a plain C ABI and bound with ctypes
// (butterfly_tpu_torch/geom/native.py); the NumPy implementations in
// geom/trimesh.py (`use_native=False`) are the test oracle.
//
// Everything here is deliberately simple C++17: contiguous arrays in, flat
// triplet/index arrays out, no exceptions across the ABI, -1 on failure.
// Built with g++ at first use into build/kernels/
// (butterfly_tpu_torch/utils/nvcc.py, build_host_library).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <utility>
#include <vector>

extern "C" {

// --------------------------------------------------------------------------
// P1 FEM Laplace-Beltrami element assembly.
//
// For each face (a, b, c) with corner positions x_a, x_b, x_c, edge vectors
// opposite each vertex e_a = x_c - x_b (cyclic) and area A:
//   local stiffness  K[i][j] = (e_i . e_j) / (4 A)      (cotan weights)
//   local mass       M[i][j] = A/6 if i == j else A/12  (consistent mass)
// Writes 9 triplets per face into rows/cols/Lvals/Mvals (caller allocates
// 9*nf entries each); the caller coalesces duplicates into CSR.
// Returns 0, or -1 on a degenerate (zero-area) face.
// --------------------------------------------------------------------------
int64_t meshkit_lbo_fem(const double* verts, int64_t nv,
                        const int64_t* faces, int64_t nf,
                        int64_t* rows, int64_t* cols,
                        double* Lvals, double* Mvals) {
  (void)nv;
  for (int64_t t = 0; t < nf; ++t) {
    const int64_t f[3] = {faces[3 * t], faces[3 * t + 1], faces[3 * t + 2]};
    const double* p[3] = {verts + 3 * f[0], verts + 3 * f[1], verts + 3 * f[2]};
    // e[i] = p[(i+2)%3] - p[(i+1)%3]  (edge opposite vertex i)
    double e[3][3];
    for (int i = 0; i < 3; ++i) {
      const double* hi = p[(i + 2) % 3];
      const double* lo = p[(i + 1) % 3];
      for (int d = 0; d < 3; ++d) e[i][d] = hi[d] - lo[d];
    }
    const double nx = e[1][1] * e[2][2] - e[1][2] * e[2][1];
    const double ny = e[1][2] * e[2][0] - e[1][0] * e[2][2];
    const double nz = e[1][0] * e[2][1] - e[1][1] * e[2][0];
    const double A2 = std::sqrt(nx * nx + ny * ny + nz * nz);  // 2*area
    if (!(A2 > 0.0)) return -1;
    const double area = 0.5 * A2;
    const double inv4A = 1.0 / (2.0 * A2);
    int64_t base = 9 * t;
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) {
        const double dij = e[i][0] * e[j][0] + e[i][1] * e[j][1] +
                           e[i][2] * e[j][2];
        rows[base] = f[i];
        cols[base] = f[j];
        Lvals[base] = dij * inv4A;
        Mvals[base] = (i == j) ? area / 6.0 : area / 12.0;
        ++base;
      }
    }
  }
  return 0;
}

// --------------------------------------------------------------------------
// OBJ parsing (reference: bfTrimeshNewFromObjFile). Two-phase protocol:
//   phase 1: meshkit_obj_count(path, &nv, &nf)   -- nf after fan-triangulation
//   phase 2: meshkit_obj_read(path, verts, faces)
// Handles "v x y z" and "f i j k [l ...]" records with optional /vt/vn
// suffixes and negative (relative) indices. Returns 0 / -1.
// --------------------------------------------------------------------------

static bool parse_face_index(const char* tok, int64_t nv_so_far, int64_t* out) {
  // OBJ faces index from 1; negative indices count back from the current
  // vertex list. Slashes introduce vt/vn which we ignore.
  char* end = nullptr;
  long long v = strtoll(tok, &end, 10);
  if (end == tok) return false;
  if (v < 0) v = nv_so_far + v + 1;
  if (v < 1 || v > nv_so_far) return false;
  *out = (int64_t)(v - 1);
  return true;
}

int64_t meshkit_obj_count(const char* path, int64_t* nv, int64_t* nf) {
  FILE* fp = std::fopen(path, "r");
  if (!fp) return -1;
  char line[4096];
  int64_t v = 0, tris = 0;
  while (std::fgets(line, sizeof line, fp)) {
    if (line[0] == 'v' && (line[1] == ' ' || line[1] == '\t')) {
      ++v;
    } else if (line[0] == 'f' && (line[1] == ' ' || line[1] == '\t')) {
      int corners = 0;
      char* save = nullptr;
      for (char* tok = strtok_r(line + 1, " \t\r\n", &save); tok;
           tok = strtok_r(nullptr, " \t\r\n", &save))
        ++corners;
      if (corners >= 3) tris += corners - 2;
    }
  }
  std::fclose(fp);
  *nv = v;
  *nf = tris;
  return 0;
}

int64_t meshkit_obj_read(const char* path, double* verts, int64_t* faces) {
  FILE* fp = std::fopen(path, "r");
  if (!fp) return -1;
  char line[4096];
  int64_t v = 0, t = 0;
  std::vector<int64_t> poly;
  while (std::fgets(line, sizeof line, fp)) {
    if (line[0] == 'v' && (line[1] == ' ' || line[1] == '\t')) {
      double x = 0, y = 0, z = 0;
      if (std::sscanf(line + 1, "%lf %lf %lf", &x, &y, &z) != 3) {
        std::fclose(fp);
        return -1;
      }
      verts[3 * v] = x;
      verts[3 * v + 1] = y;
      verts[3 * v + 2] = z;
      ++v;
    } else if (line[0] == 'f' && (line[1] == ' ' || line[1] == '\t')) {
      poly.clear();
      char* save = nullptr;
      for (char* tok = strtok_r(line + 1, " \t\r\n", &save); tok;
           tok = strtok_r(nullptr, " \t\r\n", &save)) {
        int64_t idx;
        if (!parse_face_index(tok, v, &idx)) {
          std::fclose(fp);
          return -1;
        }
        poly.push_back(idx);
      }
      for (size_t k = 1; k + 1 < poly.size(); ++k) {  // fan-triangulate
        faces[3 * t] = poly[0];
        faces[3 * t + 1] = poly[k];
        faces[3 * t + 2] = poly[k + 1];
        ++t;
      }
    }
  }
  std::fclose(fp);
  return 0;
}

// --------------------------------------------------------------------------
// Boundary edges: directed half-edge counting (reference: boundary
// detection in src/trimesh.c). An undirected edge incident to exactly one
// face is a boundary edge. Caller passes out_edges with capacity 2*(3*nf);
// returns the number of boundary edges (pairs written), or -1.
// --------------------------------------------------------------------------
int64_t meshkit_boundary_edges(const int64_t* faces, int64_t nf,
                               int64_t* out_edges) {
  const int64_t ne = 3 * nf;
  std::vector<std::pair<int64_t, int64_t>> edges;
  edges.reserve(ne);
  for (int64_t t = 0; t < nf; ++t) {
    for (int k = 0; k < 3; ++k) {
      int64_t a = faces[3 * t + k], b = faces[3 * t + (k + 1) % 3];
      if (a > b) std::swap(a, b);
      edges.emplace_back(a, b);
    }
  }
  std::sort(edges.begin(), edges.end());
  int64_t count = 0;
  for (int64_t i = 0; i < ne;) {
    int64_t j = i;
    while (j < ne && edges[j] == edges[i]) ++j;
    if (j - i == 1) {
      out_edges[2 * count] = edges[i].first;
      out_edges[2 * count + 1] = edges[i].second;
      ++count;
    }
    i = j;
  }
  return count;
}

}  // extern "C"
