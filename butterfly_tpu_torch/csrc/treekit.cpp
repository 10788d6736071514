// treekit: native spatial-tree construction for butterfly_tpu_torch.
//
// A copy of the JAX package's `native/treekit.cpp`, unchanged below this
// header, so that the port builds its own library and reads nothing under
// `native/`. Native C++ replacement for the reference's C tree builders
// (quadtreeNodeInitRecursive, src/quadtree_node.c:123-199 and the octree
// analogue): recursively sifts the permutation of a point set into 2^d-ary
// octant order and emits a flat node table. `PointTree` uses it through
// ctypes (butterfly_tpu_torch/trees/native.py); `use_native=False` takes the
// NumPy builder, the oracle it is tested against.
//
// Built with g++ at first use into build/kernels/
// (butterfly_tpu_torch/utils/nvcc.py, build_host_library).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Frame {
  int64_t node_id;
  int64_t i0, i1;
  int depth;
  double lo[3], hi[3];
};

}  // namespace

extern "C" {

// Returns the number of nodes written, or -1 if max_nodes was too small.
//
// points:   (n, d) row-major doubles (d in {1,2,3})
// perm:     length-n int64, initialized by caller (usually iota); reordered
//           in place into tree order
// node_*:   output arrays of capacity max_nodes
// node_parent: parent node index (-1 for root)
// node_octant: child octant code (bit k set = upper half along axis k)
// node_lo/hi: (max_nodes, 3) row-major box corners (unused dims zero)
int64_t treekit_build(const double* points, int64_t n, int32_t d,
                      int64_t leaf_size, int32_t max_depth,
                      int64_t* perm,
                      int64_t* node_parent, int32_t* node_depth,
                      int64_t* node_i0, int64_t* node_i1,
                      int32_t* node_octant,
                      double* node_lo, double* node_hi,
                      int64_t max_nodes) {
  if (n <= 0 || d < 1 || d > 3 || leaf_size < 1) return -1;

  // Root box: bounding box rescaled to a cube, clamped so boundary points
  // stay inside (mirrors geom/bbox.py rescale_to_cube).
  double lo[3] = {0, 0, 0}, hi[3] = {0, 0, 0};
  for (int k = 0; k < d; ++k) {
    lo[k] = hi[k] = points[k];
  }
  for (int64_t i = 1; i < n; ++i) {
    for (int k = 0; k < d; ++k) {
      double v = points[i * d + k];
      if (v < lo[k]) lo[k] = v;
      if (v > hi[k]) hi[k] = v;
    }
  }
  double h = 0;
  for (int k = 0; k < d; ++k) {
    double e = hi[k] - lo[k];
    if (e > h) h = e;
  }
  h *= 0.5;
  for (int k = 0; k < d; ++k) {
    double c = 0.5 * (lo[k] + hi[k]);
    double a = c - h, b = c + h;
    if (a < lo[k]) lo[k] = a;
    if (b > hi[k]) hi[k] = b;
    // ensure [lo, hi] contains the original box even after rounding
    if (lo[k] > a) lo[k] = a;
    if (hi[k] < b) hi[k] = b;
  }

  int64_t num_nodes = 0;
  std::vector<Frame> stack;
  {
    Frame root;
    root.node_id = num_nodes++;
    root.i0 = 0;
    root.i1 = n;
    root.depth = 0;
    std::memcpy(root.lo, lo, sizeof lo);
    std::memcpy(root.hi, hi, sizeof hi);
    node_parent[0] = -1;
    node_depth[0] = 0;
    node_i0[0] = 0;
    node_i1[0] = n;
    node_octant[0] = -1;
    for (int k = 0; k < 3; ++k) {
      node_lo[k] = root.lo[k];
      node_hi[k] = root.hi[k];
    }
    stack.push_back(root);
  }

  const int num_oct = 1 << d;
  std::vector<int64_t> scratch;
  std::vector<uint8_t> codes;

  while (!stack.empty()) {
    Frame f = stack.back();
    stack.pop_back();
    int64_t m = f.i1 - f.i0;
    if (m <= leaf_size || f.depth >= max_depth) continue;

    double c[3];
    for (int k = 0; k < d; ++k) c[k] = 0.5 * (f.lo[k] + f.hi[k]);

    // octant code per point; skip splitting if all points identical
    codes.resize((size_t)m);
    bool all_same = true;
    const double* p0 = &points[perm[f.i0] * d];
    for (int64_t i = 0; i < m; ++i) {
      const double* p = &points[perm[f.i0 + i] * d];
      uint8_t code = 0;
      for (int k = 0; k < d; ++k) {
        if (p[k] > c[k]) code |= (uint8_t)(1 << k);
        if (all_same && p[k] != p0[k]) all_same = false;
      }
      codes[(size_t)i] = code;
    }
    if (all_same) continue;

    // stable counting sort of perm[i0:i1] by octant code
    int64_t counts[8] = {0};
    for (int64_t i = 0; i < m; ++i) counts[codes[(size_t)i]]++;
    int64_t offsets[9] = {0};
    for (int q = 0; q < num_oct; ++q) offsets[q + 1] = offsets[q] + counts[q];
    scratch.resize((size_t)m);
    {
      int64_t cursor[8];
      std::memcpy(cursor, offsets, sizeof(int64_t) * 8);
      for (int64_t i = 0; i < m; ++i)
        scratch[(size_t)cursor[codes[(size_t)i]]++] = perm[f.i0 + i];
    }
    std::memcpy(&perm[f.i0], scratch.data(), sizeof(int64_t) * (size_t)m);

    // Emit children in ASCENDING octant order (siblings are consecutive in
    // the node table, matching the NumPy builder's LR child order), then
    // push them in reverse so the DFS continues with the lowest octant.
    Frame children[8];
    int num_children = 0;
    for (int q = 0; q < num_oct; ++q) {
      if (counts[q] == 0) continue;
      if (num_nodes >= max_nodes) return -1;
      Frame child;
      child.node_id = num_nodes;
      child.i0 = f.i0 + offsets[q];
      child.i1 = f.i0 + offsets[q + 1];
      child.depth = f.depth + 1;
      for (int k = 0; k < 3; ++k) {
        child.lo[k] = f.lo[k];
        child.hi[k] = f.hi[k];
      }
      for (int k = 0; k < d; ++k) {
        if ((q >> k) & 1)
          child.lo[k] = c[k];
        else
          child.hi[k] = c[k];
      }
      node_parent[num_nodes] = f.node_id;
      node_depth[num_nodes] = child.depth;
      node_i0[num_nodes] = child.i0;
      node_i1[num_nodes] = child.i1;
      node_octant[num_nodes] = q;
      for (int k = 0; k < 3; ++k) {
        node_lo[num_nodes * 3 + k] = child.lo[k];
        node_hi[num_nodes * 3 + k] = child.hi[k];
      }
      ++num_nodes;
      children[num_children++] = child;
    }
    for (int q = num_children - 1; q >= 0; --q) stack.push_back(children[q]);
  }
  return num_nodes;
}

}  // extern "C"
