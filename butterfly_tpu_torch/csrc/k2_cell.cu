// K2: the block-sparse cell program, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel `_cell_kernel`, butterfly_tpu/ops/cellsp.py:95
// (built by `_cell_call`, :142; driven by `_apply_cells`, :187).
//
// What it computes. A cell adds one contribution to the output:
//   kind 0:  y[dst : dst+128, :] += W[widx] @ buf[src][blk*128 : +128, :]
//   kind 1:  y[dst : dst+128, :] += buf[src][blk*128 : +128, :]
// with `dst` only 8-aligned. Every output is the sum of its cells'
// contributions in IEEE float32 (FFMA only, no TF32). Source rows past the
// end of a buffer read as zero, and ragged columns are masked, so neither
// the buffers nor r need padding. Each output tile is stored once; there
// are no atomics.
//
// The host's tables (ops/cellsp.py `_cell_tables`). A cell whose `dst` is
// not a multiple of 128 straddles two 128-row output tiles and is cut into
// one piece per tile. Each matmul piece is trimmed to the nonzero extent of
// its weight tile: its rows to the 8-row groups that hold a nonzero, its
// depth to the K-chunks of 16 that hold a nonzero in those rows (exact:
// only zero products are left out; a piece of zeros is dropped). The
// pieces of a tile that read one source block with disjoint rows are
// merged into one *group* when that costs no more work than staging them
// apart. A group is (source buffer, first source row, [k0, k1) in chunks,
// mask of the 8-row groups it covers, and for each 8-row group of the
// output tile the weight tile and its row group). The output tiles are
// launched heaviest first (longest-processing-time order) through a
// host-sorted tile list.
//
// Two engines compute that program from the same weight stack and tables:
// the tile engine for wide r, and the matrix-vector engine for r <= R
// (ops/cellsp.py `k2_engine`; R in the note below). The wrapper picks one
// from r at each launch.
//
// The tile engine. The weight tiles are stored k-major (each tile
// transposed; CellPlan keeps the stack so). The grid is (output tiles x
// column tiles of 128). A CTA
// of 256 threads walks its tile's groups chunk by chunk through a 3-deep
// cp.async ring: each chunk stages the weight rows of the covered row
// groups (k-major, one row group of one k per thread: two 16-byte copies)
// and the source chunk (row-major, 16-byte copies with zero fill), both
// XOR-swizzled. The copies of the chunk two ahead are issued after this
// chunk's products, their index loaded before them, so that its latency
// hides behind the products. A thread owns an 8 x 8 block of the tile:
// rows {4ty..4ty+3} and {64+4ty..+3}, columns {4tx..4tx+3} and
// {64+4tx..+3}. A warp owns two aligned 8-row groups, so it computes or
// skips each as a whole. Each group's product is summed in registers and
// then added into the tile's running totals in shared memory (each thread
// reads and writes only its own totals, once per group: no entry list
// becomes one long FMA chain); plain adds and the one store of the tile
// read the totals back row by row.
//
// What bounds it on the H100. At bench E's shapes (n=4096, r=1024) the two
// passes execute 68.5 M flops a column after trimming (127.6 M padded,
// 66.5 M useful): 70.2 GFLOP, 1.05 ms at the 67 TFLOP/s float32 peak,
// against 0.12 ms to move weights, x, t and y once, so it is bound by
// operations. It runs them in about 2.9 ms, 36% of that peak: the loop
// over a staged chunk is bound by shared-memory reads (four 16-byte reads
// per 64 FFMA for the 8 x 8 thread tile, which is also why the copies were
// made 16-byte and nearly free of bank conflicts), and a barrier closes
// every chunk. A 3xTF32 engine on mma.sync (hi/lo TF32 splits, each k-step
// of 8 in a zeroed tensor-core accumulator, FADD into IEEE sums) held
// IEEE-level accuracy but computed no faster, so it is not built here;
// wgmma would be the next step for tensor cores (PERF.md).
//
// The matrix-vector engine. At r=1 the tile engine still stages and
// multiplies 128 columns a chunk, and a tile's chunks run in turn on one
// SM: the n=2048 S' plan's r=1 apply took 1.18 ms, about its r=1024 time,
// with 32 CTAs in its second pass. At narrow r the work is bound by bytes:
// each weight of a covered 8-row group is used r times, so the trimmed
// weights must be read once, by the whole card. The host cuts each tile's
// chunks (the groups' K-chunks in order) into slices of at most 16
// (`_slice_tables`) and launches one CTA of 8 warps per (slice, column tile
// of CT = 1, 2, 4 or 8), the heaviest slices first. Warp w takes the
// slice's chunks w, w + 8, ...; lane l streams the k-major weights of
// output rows 4l..4l+3 straight from HBM (16-byte loads past L1, the 16 k
// of a chunk in flight, 8 or 4 at CT = 4 or 8; a warp reads 512 contiguous
// bytes a k where the group's rows come from one tile) and reads the
// operand's CT floats a k as a warp broadcast; nothing is staged. Sums stay
// in registers over the slice, meet once in shared memory in warp order,
// and go to a workspace as the slice's 128 x CT partial. The last CTA of a
// tile to arrive (an integer arrival counter, which it resets for the next
// launch) reads the tile's partials through shared memory, all loads of a
// batch in flight, adds them in slice order, then its plain adds, and
// stores the tile once; a tile of one slice skips the workspace. IEEE
// float32 FFMA, no float atomics, one launch a pass, the same sum order in
// every run.
//
// Its time at r=1 against the trimmed weights at 3.35 TB/s (kernel time
// under the profiler, H100 80GB HBM3 at 700 W): the n=2048 S' plan 23-24 us
// for its two passes against 45.4 MB, 13.5 us (the tile engine 1.18 ms);
// the scattering 3 x 512 plan 14.4 us against 22.0 MB, 6.6 us; the n=16384
// BIE plan 0.42-0.50 ms against 1.39 GB, 0.42 ms. Wider r reads the weights
// once per column tile (r=16 on the n=2048 plan: 86 us), so the tile
// engine, whose time hardly moves up to r=128, wins from r ~ 50 on the
// n=16384 plan (r=48: 3.99 against 4.19 ms; r=64: 5.31 against 3.99 ms)
// and above r = 128 on the n=2048 plan (0.50 against 1.14 ms). R = 32
// (ops/cellsp.py `_MV_MAX_R`). A column tile of 16 spilled 1-2 KB a thread
// and ran slower than two tiles of 8.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kG = 128;              // GM = GK: rows and depth of a cell
constexpr int kRT = 128;             // columns per CTA
constexpr int kThreads = 256;
constexpr int kKC = 16;              // K-chunk (the tables' depth step)
constexpr int kStages = 3;           // cp.async ring depth
constexpr int kNRG = kG / 8;         // 8-row groups of a tile
constexpr int kGroupInt4 = (4 + kNRG) / 4;  // a group record in int4
constexpr int kChunkElems = kKC * kG;       // one staged operand chunk
constexpr int kStageElems = 2 * kChunkElems;
constexpr int kMaxBufs = 4;
constexpr int kAccElems = kG * kRT;  // running totals of the tile
constexpr size_t kSmemBytes = sizeof(float) * (kStages * kStageElems + kAccElems);
static_assert(kThreads == kKC * kNRG, "staging: one row group of one k per thread");

struct CellArgs {
  const float* W;                 // (T_w, 128, 128) weight tiles, k-major
  const float* bufs[kMaxBufs];    // (rows_i, r) row-major
  int64_t buf_rows[kMaxBufs];
  const int* order;               // (n_tiles) output tiles, heaviest first
  const int* gptr;                // (n_tiles + 1) CSR of groups
  const int4* grp;                // groups, kGroupInt4 int4 each
  const int* ptr1;                // (n_tiles + 1) CSR of kind-1 entries
  const int4* ent1;
  float* y;                       // (n_out, r)
  int n_out, r, n_rtiles;
  int vec;                        // r % 4 == 0 and every pointer 16-byte aligned
};

// A kind-1 entry: y = source buffer, z = first source row,
// w = out_row0 | w_row0 << 8 | nrows << 16 (x and the depth bits unused).
struct Entry {
  int src, src_row0, out_row0, w_row0, nrows;
};

__device__ __forceinline__ Entry unpack(const int4 e) {
  Entry d;
  d.src = e.y;
  d.src_row0 = e.z;
  d.out_row0 = e.w & 0xff;
  d.w_row0 = (e.w >> 8) & 0xff;
  d.nrows = (e.w >> 16) & 0xff;
  return d;
}

// Element (k, c) of a staged 16 x 128 chunk, and element (row, col) of the
// totals: the column XOR-swizzled by the row in steps of 8 columns, so
// that 16-byte vectors stay whole and the staging writes and flushes
// spread over the banks.
__device__ __forceinline__ int chunk_at(int k, int c) {
  return k * kG + (c ^ ((k & 3) << 3));
}
__device__ __forceinline__ int tot_at(int row, int col) {
  return row * kRT + (col ^ ((row & 7) << 3));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async4_zfill(void* smem, const void* gmem, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Buffer i's pointer and row count without indexing the parameter arrays
// at run time (which would copy them to the stack); for either engine's
// arguments.
template <class Args>
__device__ __forceinline__ const float* buf_of(const Args& p, int i) {
  return i == 0 ? p.bufs[0] : i == 1 ? p.bufs[1] : i == 2 ? p.bufs[2] : p.bufs[3];
}
template <class Args>
__device__ __forceinline__ int64_t rows_of(const Args& p, int i) {
  return i == 0 ? p.buf_rows[0] : i == 1 ? p.buf_rows[1] : i == 2 ? p.buf_rows[2]
                                                                    : p.buf_rows[3];
}

// Position in a tile's chunk program: group g (its source and first source
// row), chunk c of [c0, c1), the group's row-group mask.
struct Cursor {
  int g, g_end, c, c0, c1, mask, src, row0;
  __device__ __forceinline__ void load(const CellArgs& p) {
    if (g < g_end) {
      const int4 h = __ldg(p.grp + (int64_t)g * kGroupInt4);
      src = h.x;
      row0 = h.y;
      c0 = h.z & 0xff;
      c1 = h.z >> 8;
      mask = h.w;
      c = c0;
    }
  }
  __device__ __forceinline__ void next(const CellArgs& p) {
    if (++c == c1) {
      ++g;
      load(p);
    }
  }
};

// This thread's weight row group of group g: (weight tile << 4 | its row
// group), or -1 where the group covers none.
__device__ __forceinline__ int stage_slot(const CellArgs& p, int g, int tid) {
  return __ldg(reinterpret_cast<const int*>(p.grp + (int64_t)g * kGroupInt4 + 1) + tid / kKC);
}

// Stage the cursor's chunk: the weight rows k-major (thread tid copies
// the 8 rows of row group tid / 16 at k = tid % 16, 32 contiguous bytes of
// the k-major tile; nothing where the group covers none: no warp reads
// those rows) and the source rows row-major.
__device__ __forceinline__ void stage(const CellArgs& p, const Cursor& cur, int slot, float* st,
                                      int col0, int tid) {
  const int q0 = cur.c * kKC;
  float* ws = st;
  float* xs = st + kChunkElems;
  const int rg = tid / kKC, pk = tid % kKC;
  if (slot >= 0) {
    const float* w = p.W + (int64_t)(slot >> 4) * (kG * kG) + (int64_t)(q0 + pk) * kG +
                     ((slot & 15) << 3);
    cp_async16(ws + chunk_at(pk, 8 * rg), w);
    cp_async16(ws + chunk_at(pk, 8 * rg + 4), w + 4);
  }
  const float* buf = buf_of(p, cur.src);
  const int64_t nrow = rows_of(p, cur.src);
  const int r = p.r;
#pragma unroll
  for (int i = 0; i < kChunkElems / 4 / kThreads; ++i) {
    const int s = i * kThreads + tid;
    const int kr = s / (kRT / 4);
    const int cc = (s % (kRT / 4)) * 4;
    const int64_t row = (int64_t)cur.row0 + q0 + kr;
    const int col = col0 + cc;
    const bool rok = row < nrow;
    float* dst = xs + chunk_at(kr, cc);
    if (p.vec) {
      const bool ok = rok && col < r;
      cp_async16_zfill(dst, ok ? buf + row * r + col : buf, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const bool ok = rok && col + u < r;
        cp_async4_zfill(dst + u, ok ? buf + row * r + col + u : buf, ok ? 4 : 0);
      }
    }
  }
}

// The thread's 8 x 8 block of a group's product, in registers.
struct Engine {
  float acc[8][8];
  int tx, ty, warp;
  __device__ __forceinline__ explicit Engine(int tid) {
    tx = tid % 16;
    ty = tid / 16;
    warp = tid / 32;
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  // one staged chunk of the product (the warp's row groups w and w + 8)
  __device__ __forceinline__ void chunk(const float* ws, const float* xs, int mask) {
    const bool a0 = (mask >> warp) & 1, a1 = (mask >> (warp + 8)) & 1;
    if (!a0 && !a1) return;
#pragma unroll
    for (int kk = 0; kk < kKC; ++kk) {
      const float4 w0 = *reinterpret_cast<const float4*>(ws + chunk_at(kk, 4 * ty));
      const float4 w1 = *reinterpret_cast<const float4*>(ws + chunk_at(kk, 64 + 4 * ty));
      const float4 x0 = *reinterpret_cast<const float4*>(xs + chunk_at(kk, 4 * tx));
      const float4 x1 = *reinterpret_cast<const float4*>(xs + chunk_at(kk, 64 + 4 * tx));
      const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      if (a0) {
        const float wv[4] = {w0.x, w0.y, w0.z, w0.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(wv[i], xv[j], acc[i][j]);
      }
      if (a1) {
        const float wv[4] = {w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[4 + i][j] = fmaf(wv[i], xv[j], acc[4 + i][j]);
      }
    }
  }
  // the group's sums into the tile's totals
  __device__ __forceinline__ void flush(float* tot, int mask) {
    const bool a0 = (mask >> warp) & 1, a1 = (mask >> (warp + 8)) & 1;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (!(i < 4 ? a0 : a1)) continue;
      const int row = i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float4* q = reinterpret_cast<float4*>(tot + tot_at(row, 64 * h + 4 * tx));
        float4 v = *q;
        v.x += acc[i][4 * h];
        v.y += acc[i][4 * h + 1];
        v.z += acc[i][4 * h + 2];
        v.w += acc[i][4 * h + 3];
        *q = v;
      }
    }
  }
};

__global__ void __launch_bounds__(kThreads, 2) k2_cell_kernel(const CellArgs p) {
  extern __shared__ __align__(16) float smem[];
  float* tot = smem + kStages * kStageElems;
  const int tid = threadIdx.x;
  const int tile = __ldg(p.order + blockIdx.x / p.n_rtiles);
  const int col0 = (blockIdx.x % p.n_rtiles) * kRT;
  const int r = p.r;
  for (int i = tid; i < kAccElems / 4; i += kThreads)
    reinterpret_cast<float4*>(tot)[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  // ---- kind 0: the groups, chunk by chunk through the cp.async ring ----
  Cursor in;
  in.g = __ldg(p.gptr + tile);
  in.g_end = __ldg(p.gptr + tile + 1);
  in.load(p);
  Cursor out = in;
  int in_stage = 0;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (in.g < in.g_end) {
      stage(p, in, stage_slot(p, in.g, tid), smem + in_stage * kStageElems, col0, tid);
      in.next(p);
    }
    cp_async_commit();
    ++in_stage;
  }
  Engine eng(tid);
  int stg = 0;
  while (out.g < out.g_end) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this chunk landed; the previous chunk's stage is free
    // the copies of the chunk kStages - 1 ahead go after the products;
    // their index is loaded now
    const Cursor ahead = in;
    const int slot = in.g < in.g_end ? stage_slot(p, in.g, tid) : -1;
    const float* st = smem + stg * kStageElems;
    if (out.c == out.c0) eng.zero();
    eng.chunk(st, st + kChunkElems, out.mask);
    if (out.c + 1 == out.c1) eng.flush(tot, out.mask);
    if (ahead.g < ahead.g_end) {
      stage(p, ahead, slot, smem + in_stage * kStageElems, col0, tid);
      in.next(p);
    }
    cp_async_commit();  // a group even when empty: the waits count groups
    in_stage = in_stage + 1 == kStages ? 0 : in_stage + 1;
    out.next(p);
    stg = stg + 1 == kStages ? 0 : stg + 1;
  }
  cp_async_wait<0>();
  __syncthreads();

  // ---- kind 1 and the one store of the tile, row by row ----------------
  const int e1 = __ldg(p.ptr1 + tile), e1_end = __ldg(p.ptr1 + tile + 1);
  for (int i = 0; i < kAccElems / 4 / kThreads; ++i) {
    const int s = i * kThreads + tid;
    const int row = s / (kRT / 4);
    const int cc = (s % (kRT / 4)) * 4;
    const int col = col0 + cc;
    const float4 t4 = *reinterpret_cast<const float4*>(tot + tot_at(row, cc));
    float v[4] = {t4.x, t4.y, t4.z, t4.w};
    for (int k = e1; k < e1_end; ++k) {
      const Entry e = unpack(__ldg(p.ent1 + k));
      if (row < e.out_row0 || row >= e.out_row0 + e.nrows) continue;
      const int64_t srow = (int64_t)e.src_row0 + (row - e.out_row0 + e.w_row0);
      if (srow >= rows_of(p, e.src)) continue;
      const float* src = buf_of(p, e.src) + srow * r;
      if (p.vec) {
        if (col < r) {
          const float4 a = __ldg(reinterpret_cast<const float4*>(src + col));
          v[0] += a.x;
          v[1] += a.y;
          v[2] += a.z;
          v[3] += a.w;
        }
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (col + u < r) v[u] += __ldg(src + col + u);
      }
    }
    const int64_t orow = (int64_t)tile * kG + row;
    if (orow >= p.n_out) continue;
    float* dst = p.y + orow * r;
    if (p.vec) {
      if (col < r) *reinterpret_cast<float4*>(dst + col) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (col + u < r) dst[col + u] = v[u];
    }
  }
}


// ---- the matrix-vector engine (narrow r) --------------------------------

constexpr int kMVThreads = 256;
constexpr int kMVWarps = kMVThreads / 32;
constexpr int kMVMaxCols = 8;  // widest column tile of a CTA

struct MvArgs {
  const float* W;                 // (T_w, 128, 128) weight tiles, k-major
  const float* bufs[kMaxBufs];    // (rows_i, r) row-major
  int64_t buf_rows[kMaxBufs];
  const int* sorder;              // (n_slices) slices, heaviest first
  const int4* slices;             // (n_slices) tile, first chunk, end chunk, -
  const int* sptr;                // (n_tiles + 1) CSR of slices per tile
  const int2* chunks;             // (n_chunks) group, chunk: tile order
  const int4* grp;                // the groups, as the tile engine reads them
  const int* ptr1;
  const int4* ent1;
  float* ws;                      // (n_slices, n_ctiles, 128 * CT) partials
  int* arrivals;                  // (n_tiles, n_ctiles), zero between launches
  float* y;
  int n_out, r, n_ctiles;
  int vec;
};

// Columns [col0, col0 + CT) of source row `row`, zero past the buffer's
// rows and past r. The lanes of a warp read the same row: one broadcast.
template <int CT>
__device__ __forceinline__ void load_x(float (&xv)[CT], const float* buf, int64_t row,
                                       int64_t nrow, int col0, int r, int vec) {
  if (row >= nrow) {
#pragma unroll
    for (int j = 0; j < CT; ++j) xv[j] = 0.f;
    return;
  }
  const float* xp = buf + row * r + col0;
  if (CT % 4 == 0 && vec) {
#pragma unroll
    for (int q = 0; q < CT / 4; ++q) {
      const float4 v = col0 + 4 * q < r ? __ldg(reinterpret_cast<const float4*>(xp) + q)
                                        : make_float4(0.f, 0.f, 0.f, 0.f);
      xv[4 * q] = v.x;
      xv[4 * q + 1] = v.y;
      xv[4 * q + 2] = v.z;
      xv[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < CT; ++j) xv[j] = col0 + j < r ? __ldg(xp + j) : 0.f;
  }
}

// One CTA per (slice, column tile of CT). Warp w takes chunks w, w + 8,
// ... of the slice; lane l owns output rows 4l..4l+3 of the tile (its row
// group l / 2) and streams their k-major weights from HBM, a 16-byte load
// per k past L1, the 16 k of a chunk in flight (8 at CT = 4, 4 at 8). The
// slice's sums meet once in shared memory; the last CTA of the tile to
// arrive adds the tile's partials in slice order and its plain adds, and
// stores it.
template <int CT>
__global__ void __launch_bounds__(kMVThreads, 2) k2_mv_kernel(const MvArgs p) {
  constexpr int kEl = kG * CT;  // a partial
  // weight loads in flight: as many as the registers beside the sums allow
  constexpr int kWB = CT <= 2 ? kKC : 32 / CT;
  constexpr int kPer = (kEl + kMVThreads - 1) / kMVThreads;  // outputs a thread
  // shared memory kept small (4.6 KB at CT = 1): the rest of the SM's
  // unified L1 caches the operand's broadcast reads
  extern __shared__ __align__(16) float smem[];
  float* red = smem;                    // (warps, kEl): warps' sums, then partials
  float* mine = smem + kMVWarps * kEl;  // this slice's sums
  __shared__ int is_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int si = __ldg(p.sorder + blockIdx.x);
  const int4 sl = __ldg(p.slices + si);
  const int tile = sl.x, ct = blockIdx.y, col0 = ct * CT, r = p.r;

  float acc[4][CT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[i][j] = 0.f;
  for (int c = sl.y + warp; c < sl.z; c += kMVWarps) {
    const int2 gc = __ldg(p.chunks + c);
    const int4* g = p.grp + (int64_t)gc.x * kGroupInt4;
    const int slot = __ldg(reinterpret_cast<const int*>(g + 1) + (lane >> 1));
    if (slot < 0) continue;  // the group covers none of the lane's rows
    const int4 h = __ldg(g);
    const int k0 = gc.y * kKC;
    const float* buf = buf_of(p, h.x);
    const int64_t nrow = rows_of(p, h.x);
    const int64_t row0 = (int64_t)h.y + k0;
    const float* wp = p.W + (int64_t)(slot >> 4) * (kG * kG) + (int64_t)k0 * kG +
                      ((slot & 15) << 3) + ((lane & 1) << 2);
#pragma unroll
    for (int kb = 0; kb < kKC; kb += kWB) {
      float4 w[kWB];
#pragma unroll
      for (int u = 0; u < kWB; ++u)
        w[u] = __ldcg(reinterpret_cast<const float4*>(wp + (kb + u) * kG));
#pragma unroll
      for (int u = 0; u < kWB; ++u) {
        float xv[CT];
        load_x<CT>(xv, buf, row0 + kb + u, nrow, col0, r, p.vec);
        const float wv[4] = {w[u].x, w[u].y, w[u].z, w[u].w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < CT; ++j) acc[i][j] = fmaf(wv[i], xv[j], acc[i][j]);
      }
    }
  }

  // the warps' sums, added in warp order
  {
    float4* dst = reinterpret_cast<float4*>(red + warp * kEl + 4 * lane * CT);
#pragma unroll
    for (int q = 0; q < CT; ++q) {
      const int e = 4 * q;  // element e..e+3 of the lane's (4, CT) block
      dst[q] = make_float4(acc[e / CT][e % CT], acc[(e + 1) / CT][(e + 1) % CT],
                           acc[(e + 2) / CT][(e + 2) % CT], acc[(e + 3) / CT][(e + 3) % CT]);
    }
  }
  __syncthreads();
  const int s0 = __ldg(p.sptr + tile), ns = __ldg(p.sptr + tile + 1) - s0;
  float* part = p.ws + ((int64_t)si * p.n_ctiles + ct) * kEl;
  for (int o = tid; o < kEl; o += kMVThreads) {
    float s = red[o];
#pragma unroll
    for (int w = 1; w < kMVWarps; ++w) s += red[w * kEl + o];
    mine[o] = s;  // each thread reads back only what it wrote
    if (ns > 1) part[o] = s;
  }
  if (ns > 1) {
    // publish the partial, then count this CTA in; the last one combines
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      int* cnt = p.arrivals + (int64_t)tile * p.n_ctiles + ct;
      is_last = atomicAdd(cnt, 1) == ns - 1;
      if (is_last) *cnt = 0;  // every CTA of this tile has arrived
    }
    __syncthreads();
    if (!is_last) return;
    __threadfence();
  }

  // ---- the tile's partials in slice order, its plain adds, one store -----
  // The partials come through shared memory 8 at a time, every load of a
  // batch in flight at once; each output adds them in slice order.
  float v[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int o = q * kMVThreads + tid;
    v[q] = ns == 1 && o < kEl ? mine[o] : 0.f;  // a thread's own sums
  }
  for (int b = 0; ns > 1 && b < ns; b += kMVWarps) {
    const int nb = min(kMVWarps, ns - b);
    __syncthreads();  // `red` is free
    for (int i = tid; i < nb * kEl; i += kMVThreads) {
      const int s = s0 + b + i / kEl;
      red[i] = s == si ? mine[i % kEl]
                       : __ldcg(p.ws + ((int64_t)s * p.n_ctiles + ct) * kEl + i % kEl);
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int o = q * kMVThreads + tid;
      if (o < kEl)
        for (int k = 0; k < nb; ++k) v[q] += red[k * kEl + o];
    }
  }
  const int e1 = __ldg(p.ptr1 + tile), e1_end = __ldg(p.ptr1 + tile + 1);
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int o = q * kMVThreads + tid;
    const int row = o / CT, col = col0 + o % CT;
    if (o >= kEl || col >= r) continue;
    for (int k = e1; k < e1_end; ++k) {
      const Entry e = unpack(__ldg(p.ent1 + k));
      if (row < e.out_row0 || row >= e.out_row0 + e.nrows) continue;
      const int64_t srow = (int64_t)e.src_row0 + (row - e.out_row0 + e.w_row0);
      if (srow < rows_of(p, e.src)) v[q] += __ldg(buf_of(p, e.src) + srow * r + col);
    }
    const int64_t orow = (int64_t)tile * kG + row;
    if (orow < p.n_out) p.y[orow * r + col] = v[q];
  }
}

// Column tile of the matrix-vector engine at r: the least power of two
// >= r, at most kMVMaxCols.
int mv_cols(int r) {
  int ct = 1;
  while (ct < r && ct < kMVMaxCols) ct *= 2;
  return ct;
}

template <int CT>
cudaError_t launch_mv(const MvArgs& p, int n_slices, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kMVWarps + 1) * kG * CT;  // < 48 KB
  k2_mv_kernel<CT><<<dim3((unsigned)n_slices, (unsigned)p.n_ctiles), kMVThreads, smem,
                     stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the cell program on `stream`; returns the cudaError_t of the launch.
int k2_cells(const float* W, const void* const* bufs, const int64_t* buf_rows,
             int n_bufs, const int* order, const int* gptr, const int* grp,
             const int* ptr1, const int* ent1, float* y, int n_out, int r,
             void* stream) {
  if (n_bufs < 1 || n_bufs > kMaxBufs || r < 1 || n_out < 1)
    return (int)cudaErrorInvalidValue;
  CellArgs p = {};
  p.W = W;
  bool aligned = ((uintptr_t)y & 15) == 0;
  for (int i = 0; i < n_bufs; ++i) {
    p.bufs[i] = static_cast<const float*>(bufs[i]);
    p.buf_rows[i] = buf_rows[i];
    if (((uintptr_t)bufs[i] & 15) != 0) aligned = false;
  }
  p.order = order;
  p.gptr = gptr;
  p.grp = reinterpret_cast<const int4*>(grp);
  p.ptr1 = ptr1;
  p.ent1 = reinterpret_cast<const int4*>(ent1);
  p.y = y;
  p.n_out = n_out;
  p.r = r;
  p.n_rtiles = (r + kRT - 1) / kRT;
  p.vec = aligned && (r % 4) == 0;
  const int64_t n_tiles = (n_out + kG - 1) / kG;
  const int64_t blocks = n_tiles * p.n_rtiles;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      k2_cell_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  // all of the SM's unified L1/shared memory as shared memory: two CTAs
  err = cudaFuncSetAttribute(k2_cell_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err != cudaSuccess) return (int)err;
  k2_cell_kernel<<<(unsigned)blocks, kThreads, kSmemBytes,
                   static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// The column tile the matrix-vector engine takes at r: its workspace
// holds n_slices x ceil(r / tile) partials of 128 x tile floats, and its
// arrival counters n_tiles x ceil(r / tile) ints, zero before the first
// launch.
int k2_mv_tile_cols(int r) { return mv_cols(r); }

// Launch the matrix-vector engine on `stream`; returns the cudaError_t of
// the launch.
int k2_cells_mv(const float* W, const void* const* bufs, const int64_t* buf_rows,
                int n_bufs, const int* sorder, const int* slices, const int* sptr,
                const int* chunks, const int* grp, const int* ptr1, const int* ent1,
                float* ws, int* arrivals, float* y, int n_out, int r, int n_slices,
                void* stream) {
  if (n_bufs < 1 || n_bufs > kMaxBufs || r < 1 || n_out < 1 || n_slices < 1)
    return (int)cudaErrorInvalidValue;
  MvArgs p = {};
  p.W = W;
  bool aligned = ((uintptr_t)y & 15) == 0;
  for (int i = 0; i < n_bufs; ++i) {
    p.bufs[i] = static_cast<const float*>(bufs[i]);
    p.buf_rows[i] = buf_rows[i];
    if (((uintptr_t)bufs[i] & 15) != 0) aligned = false;
  }
  p.sorder = sorder;
  p.slices = reinterpret_cast<const int4*>(slices);
  p.sptr = sptr;
  p.chunks = reinterpret_cast<const int2*>(chunks);
  p.grp = reinterpret_cast<const int4*>(grp);
  p.ptr1 = ptr1;
  p.ent1 = reinterpret_cast<const int4*>(ent1);
  p.ws = ws;
  p.arrivals = arrivals;
  p.y = y;
  p.n_out = n_out;
  p.r = r;
  const int ct = mv_cols(r);
  p.n_ctiles = (r + ct - 1) / ct;
  p.vec = aligned && (r % 4) == 0;
  if (p.n_ctiles > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (ct) {
    case 1: err = launch_mv<1>(p, n_slices, s); break;
    case 2: err = launch_mv<2>(p, n_slices, s); break;
    case 4: err = launch_mv<4>(p, n_slices, s); break;
    default: err = launch_mv<8>(p, n_slices, s); break;
  }
  return (int)err;
}

const char* k2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
