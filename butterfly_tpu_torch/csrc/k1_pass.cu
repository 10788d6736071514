// K1: one fused butterfly pass, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel `_pass_kernel`, butterfly_tpu/ops/pallas_butterfly.py:132
// (built by `_make_pass_call`, :175; driven by `_apply_fused`, :254).
//
// What it computes. A pass applies levels l0..l0+k-1 of an FFT-form
// butterfly. The NB activation blocks fall into groups of R^k blocks that mix
// only among themselves across those levels. For one group and one tile of
// columns the kernel
//   1. on pass 0, applies the block-diagonal leaf (m0 x k0 per block);
//   2. applies k levels back to back: at level t the group splits into
//      U*V sub-problems (U = R^(k-1-t), V = R^t), each one (R*m_t) x (R*k_t)
//      mixing matrix times the R stacked sibling tiles;
//   3. writes the group's tile back.
// Numerics follow the TPU kernel: each factor's input is rounded to the
// weight type (float or bf16), products are summed in float32, and every
// level's output is rounded to the activation type before the next level
// reads it (pallas_butterfly.py:153, :163, :167). Float32 weights use FFMA
// only (IEEE float32, no TF32 anywhere).
//
// What bounds it on the H100, and the three engines. The host picks one
// engine, a depth and a column tile per pass at plan time
// (ops/fused_butterfly.py `_engine_for`, `_pass_smem_bytes`).
//   * FFMA (float weights). Bound by operations: FFMA peaks at 67 TFLOP/s,
//     and a 128-row flagship level is 17.2 GFLOP against 0.4 GB of traffic.
//     The first design held two activation buffers and a 32-deep ring
//     (197 KB: one CTA of 8 warps per SM) and loaded the group's tiles
//     before any product, so load, products and stores ran back to back.
//     Now the first factor of a pass reads its input straight from global
//     memory through the cp.async ring that carries its weights (16-deep
//     chunks, 3 stages: chunk c+2 loads while chunk c multiplies); shared
//     memory holds only the intermediates the pass has (none at depth 1
//     without a leaf); and a leaf that would cost level 0 its second CTA
//     per SM runs in a pass of its own (k = 0). Every FFMA pass thus keeps
//     two CTAs (16 warps) per SM, and every shared read of the FMA loop is a
//     conflict-free 16-byte read (a thread's 8 columns are two quads 32
//     apart). What binds it now: an 8 x 8 thread tile issues four 16-byte
//     shared reads per 64 FFMA, as many shared-memory wavefronts as FFMA
//     issue slots on an H100 SM; a 16 x 8 tile needs more than the 168
//     registers three CTAs allow, and spills (PERF.md).
//   * WGMMA (bf16 weights and activations, R = 2, one level per pass, ranks
//     64 or 128, inputs a multiple of 64). Bound by bytes: at depth 1 each
//     level reads and writes the whole activation. A persistent CTA (one per
//     SM) walks (group, 128-column tile) items. One producer thread keeps a
//     3-stage ring of 48 KB stages full with TMA (128-byte swizzle,
//     `mbarrier` completion): a 64-deep chunk of the mixing matrix and the
//     matching 64 input rows. Two consumer warpgroups, one per output
//     block, run `wgmma.m64n128k16` (bf16 in, f32 sums) from shared memory,
//     write their rows to a swizzled staging region and store them by TMA,
//     while the producer already loads the next item. On pass 0 the leaf
//     runs first in the same ring; its output stays in shared memory, in
//     the layout the level's `wgmma` reads.
//   * MMA (bf16 weights, the passes the WGMMA engine does not take: float
//     activations, other radices, ranks or input sizes). The first design: the
//     group's tiles in two shared-memory buffers (rows padded by 8 for
//     conflict-free ldmatrix), `mma.sync.m16n8k16` over a cp.async weight
//     ring, loads, products and stores back to back; deeper fusion for
//     small blocks.
// Done since the first design: overlap of loads, products and stores (FFMA,
// WGMMA), wgmma, TMA loads with an mbarrier ring, warp specialisation.
// Tried and left out (PERF.md): WGMMA passes of 2 or 3 levels in
// one CTA at 64 columns (no faster at depth 2, slower at 3: the weights
// are read by twice as many column tiles and n64 `wgmma` from shared
// memory binds it); 3xTF32 tensor cores for float weights (3.2e-6 on the
// real fac, over its 1e-6 line); a 16 x 8 FFMA thread tile (spills).
// Left for later PRs: deeper fusion through a cluster of CTAs exchanging
// sibling tiles by distributed shared memory, TMA multicast of a mixing
// matrix across the column tiles of its group, and overlap in the MMA
// engine.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kRowsPerSweep = 256;  // output rows per sweep (FFMA, MMA)
constexpr int kMaxLevels = 16;
constexpr int kLoadBatch = 4;       // 16-byte input loads in flight per thread

enum Engine { kEngineFfma = 0, kEngineMma = 1, kEngineWgmma = 2 };

// FFMA engine
constexpr int kFThreads = 256;                // a CTA: 256 rows x 64 columns
constexpr int kFTX = 8;                       // threads across a column tile
constexpr int kFTM = 8;                       // rows per thread: two quads
constexpr int kFQuad = 128;                   // offset of the second quad
constexpr int kFKC = 16;                      // K-chunk
constexpr int kFWStride = kRowsPerSweep + 4;  // staged (k-major) row stride
constexpr int kFStages = 3;                   // cp.async ring depth
constexpr int kFRT = 64;                      // column tile
constexpr int kFWElems = kFKC * kFWStride;    // a stage's weights (floats)
// a stage: weights, then the chunk's input rows when they come from global
constexpr int kFStageElems = kFWElems + kFKC * kFRT;
constexpr int kFCopies = kRowsPerSweep * kFKC / kFThreads;  // 4 B each

// MMA engine
constexpr int kMThreads = 512;                // 4 warps down the rows
constexpr int kMWN = kMThreads / 128;         // warps across the columns
constexpr int kMKC = 32;                      // K-chunk
constexpr int kMWStride = kMKC + 8;           // staged row stride (bf16)
constexpr int kMStages = 3;                   // cp.async ring depth
constexpr int kMStageElems = kRowsPerSweep * kMWStride;
constexpr int kMWarpRows = 64;                // 4 m16 tiles per warp
constexpr int kMCopies = kRowsPerSweep * kMKC / 8 / kMThreads;  // 16 B each
constexpr int kMPad = 8;                      // tile row padding (bf16)

// WGMMA engine
constexpr int kGConsumers = 256;              // two consumer warpgroups
constexpr int kGThreads = kGConsumers + 32;   // and one producer warp
constexpr int kGN = 128;                      // columns per item
constexpr int kGKC = 64;                      // K-chunk: one 128-byte row
constexpr int kGRowBytes = kGKC * 2;
constexpr int kGABytes = 256 * kGRowBytes;    // a stage's weights, <=256 rows
constexpr int kGBBytes = 2 * kGKC * kGRowBytes;  // 64 rows x 128 columns
constexpr int kGStageBytes = kGABytes + kGBBytes;
constexpr int kGStages = 3;                   // ring depth

// The output staging region `obuf` (ahead of the ring's barriers): two
// warpgroups x two 64-column blocks of m rows; with a leaf it first holds
// the leaf's output (two 64-column blocks of 2*m0 rows).
__host__ __device__ constexpr int wgmma_obuf_bytes(int has_leaf, int m0, int m) {
  return 4 * (has_leaf && m0 > m ? m0 : m) * kGRowBytes;
}

struct PassArgs {
  const void* x;
  void* y;
  const void* leaf;
  const void* w[kMaxLevels];
  int dims_m[kMaxLevels];
  int dims_k[kMaxLevels];
  int R, k, Rk, hiG, loG, blk_in, blk_out, m0, k0, r, n_rtiles;
  int ld;       // tile row stride (elements)
  int ts;       // tile size (elements)
  int aligned;  // every weight pointer is 16-byte aligned
  int vec_in;   // input rows can be read 16 bytes at a time
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round a float to type T and back (identity for float).
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// Store two adjacent elements (p is aligned to two of them).
__device__ __forceinline__ void put2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void put2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Where a sub-problem's outputs go: shared-memory tiles (row-major, row
// stride ld), or, on the last level of the pass, the global output: rows
// y_row0 + c*y_cstride + rr for row rr of output tile c.
template <typename AT, typename ST>
struct Out {
  ST* tiles;
  int tile_stride;
  AT* y;
  int64_t y_row0, y_cstride;
  int r, col0, ld;
  bool last;
};

// Store the pairs (n[i], n[i]+1) of output row `row` (tiles of mt rows).
template <typename AT, typename WT, typename ST, int NP>
__device__ __forceinline__ void store_row(const Out<AT, ST>& o, int row, int mt,
                                          const int (&n)[NP],
                                          const float (&v)[NP][2]) {
  const int c = row / mt;
  const int rr = row - c * mt;
  if (o.last) {
    AT* yrow = o.y + (o.y_row0 + c * o.y_cstride + rr) * o.r + o.col0;
    const int ncol = o.r - o.col0;  // columns of this tile inside the output
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      if (n[i] + 1 < ncol && (o.r & 1) == 0) {
        put2(yrow + n[i], v[i][0], v[i][1]);
      } else {
        if (n[i] < ncol) yrow[n[i]] = from_f<AT>(v[i][0]);
        if (n[i] + 1 < ncol) yrow[n[i] + 1] = from_f<AT>(v[i][1]);
      }
    }
  } else {
    // the next level reads it: round to the activation, then weight type
    ST* trow = o.tiles + c * o.tile_stride + rr * o.ld;
#pragma unroll
    for (int i = 0; i < NP; ++i)
      put2(trow + n[i], round_to<WT>(round_to<AT>(v[i][0])),
           round_to<WT>(round_to<AT>(v[i][1])));
  }
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------- FFMA ----

// Where the first factor of a pass reads its input: global rows
// row0 + d*dstride (+ q) of the activation, columns col0.. of r.
template <typename AT>
struct Src {
  const AT* x;
  int64_t row0, dstride;
  int r, col0;
  bool vec;  // float rows that can be read 16 bytes at a time
};

// Column of a thread's j-th value in the 64-column tile: two quads 32 apart
// (a warp's 16-byte reads of one row then cover 128 contiguous bytes).
__device__ __forceinline__ int fcol(int tx, int j) {
  return (j / 4) * (4 * kFTX) + tx * 4 + (j % 4);
}

// Stage rows q0..q0+kc of input tile d (kFRT columns) into sb; rows past
// kc and columns past r are zero. Float rows go by cp.async, bf16 rows are
// converted on the way.
template <typename AT>
__device__ __forceinline__ void stage_input(float* sb, const Src<AT>& s, int d,
                                            int q0, int kc) {
  constexpr int E = kFKC * kFRT / kFThreads;  // 4 elements per thread
  const int flat = threadIdx.x * E;
  const int row = flat / kFRT;
  float* dst = sb + flat;
  const int gcol = s.col0 + flat % kFRT;
  if (row >= kc) {
#pragma unroll
    for (int e = 0; e < E; ++e) dst[e] = 0.f;
    return;
  }
  const AT* p = s.x + (s.row0 + d * s.dstride + q0 + row) * (int64_t)s.r + gcol;
  if constexpr (std::is_same<AT, float>::value) {
    if (s.vec && gcol + 4 <= s.r) {
      cp_async16(dst, p);
      return;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (gcol + e < s.r)
        cp_async4(dst + e, p + e);
      else
        dst[e] = 0.f;
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) dst[e] = gcol + e < s.r ? to_f(p[e]) : 0.f;
  }
}

// FFMA engine: out = W @ X for one sub-problem.
//   W:   M x (nd*kt) float, row-major in global memory, leading dim ldw.
//   X:   nd input tiles of kt rows; from global (kGlobal, through the ring)
//        or shared tiles of row stride kFRT (tile d at in_base + d*in_stride).
//   out: M/mt output tiles of mt rows.
// Weight chunks of 256 rows x 16 columns are staged k-major (transposed)
// through a ring of kFStages stages with 4-byte cp.async. Each thread owns
// 8 rows (two quads 128 apart) x 8 columns (two quads 32 apart) and runs
// FFMA on 16-byte shared reads.
template <typename AT, bool kGlobal>
__device__ __forceinline__ void gemm_ffma(const float* __restrict__ W, int M,
                                         int ldw, int nd, int kt,
                                         const float* in_base, int in_stride,
                                         const Src<AT>& src, int mt,
                                         const Out<AT, float>& out,
                                         float* ring) {
  const int tid = threadIdx.x;
  const int tx = tid % kFTX;
  const int ty = tid / kFTX;
  const int nq = (kt + kFKC - 1) / kFKC;
  const int nch = nd * nq;
  const int pk = tid % kFKC;          // staged column of this thread's copies
  const int prow = tid / kFKC;        // staged row (plus kPRows*i)
  constexpr int kPRows = kFThreads / kFKC;
  for (int mc0 = 0; mc0 < M; mc0 += kRowsPerSweep) {
    float acc[kFTM * 8];  // acc[i * 8 + j]: row quad i / 4, column fcol(tx, j)
#pragma unroll
    for (int i = 0; i < kFTM * 8; ++i) acc[i] = 0.f;
    // stage chunk ch (if any) and close a cp.async group either way
    auto issue = [&](int ch) {
      if (ch < nch) {
        const int d = ch / nq;
        const int q0 = (ch - d * nq) * kFKC;
        const int kc = min(kFKC, kt - q0);
        float* st = ring + (ch % kFStages) * kFStageElems;
        float* sw = st + pk * kFWStride;
#pragma unroll 8
        for (int i = 0; i < kFCopies; ++i) {
          const int gr = mc0 + prow + kPRows * i;
          if (pk < kc && gr < M)
            cp_async4(sw + prow + kPRows * i,
                      W + (int64_t)gr * ldw + d * kt + q0 + pk);
          else
            sw[prow + kPRows * i] = 0.f;
        }
        if constexpr (kGlobal) stage_input<AT>(st + kFWElems, src, d, q0, kc);
      }
      cp_async_commit();
    };
    // one k of the chunk
    auto step = [&](const float* wrow, const float* xrow) {
      float wv[kFTM];
#pragma unroll
      for (int i = 0; i < kFTM; i += 4) {
        const float4 q =
            *reinterpret_cast<const float4*>(wrow + (i / 4) * kFQuad);
        wv[i] = q.x; wv[i + 1] = q.y; wv[i + 2] = q.z; wv[i + 3] = q.w;
      }
      float xv[8];
#pragma unroll
      for (int j = 0; j < 8; j += 4) {
        const float4 q = *reinterpret_cast<const float4*>(xrow + fcol(tx, j));
        xv[j] = q.x; xv[j + 1] = q.y; xv[j + 2] = q.z; xv[j + 3] = q.w;
      }
#pragma unroll
      for (int i = 0; i < kFTM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i * 8 + j] = fmaf(wv[i], xv[j], acc[i * 8 + j]);
    };
    __syncthreads();  // the ring's previous readers are done
#pragma unroll
    for (int sidx = 0; sidx < kFStages - 1; ++sidx) issue(sidx);
    for (int ch = 0; ch < nch; ++ch) {
      cp_async_wait<kFStages - 2>();
      __syncthreads();  // chunk ch landed; chunk ch-1's stage is free
      issue(ch + kFStages - 1);
      const int d = ch / nq;
      const int q0 = (ch - d * nq) * kFKC;
      const int kc = min(kFKC, kt - q0);
      const float* st = ring + (ch % kFStages) * kFStageElems;
      const float* xin =
          kGlobal ? st + kFWElems : in_base + d * in_stride + q0 * kFRT;
      const float* wst = st + ty * 4;
      if (kc == kFKC) {
#pragma unroll
        for (int kk = 0; kk < kFKC; ++kk)
          step(wst + kk * kFWStride, xin + kk * kFRT);
      } else {
        for (int kk = 0; kk < kc; ++kk)
          step(wst + kk * kFWStride, xin + kk * kFRT);
      }
    }
    cp_async_wait<0>();
#pragma unroll
    for (int i = 0; i < kFTM; ++i) {
      const int row = mc0 + (i / 4) * kFQuad + ty * 4 + (i % 4);
      if (row < M) {
        int n[4];
        float v[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          n[j] = fcol(tx, 2 * j);
          v[j][0] = acc[i * 8 + 2 * j];
          v[j][1] = acc[i * 8 + 2 * j + 1];
        }
        store_row<AT, float, float, 4>(out, row, mt, n, v);
      }
    }
  }
}

// FFMA pass: one CTA per (group, column tile). The first factor (the leaf
// on pass 0, else level 0) reads global memory through the ring; each
// later factor reads the previous one's tiles from shared memory, in at
// most two buffers used in turn; the last factor writes global memory.
template <typename AT>
__global__ void __launch_bounds__(kFThreads, 2)
    k1_ffma_kernel(const PassArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  float* bufs[2] = {ring + kFStages * kFStageElems,
                    ring + kFStages * kFStageElems + p.Rk * p.ts};

  const int64_t bid = blockIdx.x;
  const int rt = (int)(bid % p.n_rtiles);
  const int64_t grp = bid / p.n_rtiles;
  const int c = (int)(grp % p.loG);
  const int64_t a = grp / p.loG;
  const int col0 = rt * kFRT;
  const AT* x = static_cast<const AT*>(p.x);
  AT* y = static_cast<AT*>(p.y);
  const bool vec = p.vec_in != 0;

  const float* cur = nullptr;  // tiles the next factor reads
  int nint = 0;                // intermediates written so far
  if (p.leaf != nullptr) {
    // leaf weights: (hiG, 1, Rk, m0, k0); the last factor only in a pass
    // of its own (k = 0)
    const float* leaf = static_cast<const float*>(p.leaf);
    const bool last = p.k == 0;
    for (int g = 0; g < p.Rk; ++g) {
      const Out<AT, float> out = {
          last ? nullptr : bufs[0] + g * p.ts, 0, y,
          ((a * p.Rk + g) * p.loG + c) * p.blk_out, 0, p.r, col0, kFRT, last};
      const Src<AT> src = {x, ((a * p.Rk + g) * p.loG + c) * p.blk_in, 0,
                           p.r, col0, vec};
      gemm_ffma<AT, true>(leaf + (a * p.Rk + g) * (int64_t)p.m0 * p.k0,
                                p.m0, p.k0, 1, p.k0, nullptr, 0, src, p.m0,
                                out, ring);
    }
    __syncthreads();
    cur = bufs[0];
    nint = 1;
  }

  int V = 1;
  for (int t = 0; t < p.k; ++t) {
    int U = 1;
    for (int s = t + 1; s < p.k; ++s) U *= p.R;
    const int m = p.dims_m[t];
    const int kt = p.dims_k[t];
    const int64_t wsize = (int64_t)(p.R * m) * (p.R * kt);
    // level weights: (hiG, loG, U, V, R*m, R*k)
    const float* Wt = static_cast<const float*>(p.w[t]);
    const bool last = t == p.k - 1;
    float* dst = last ? nullptr : bufs[nint % 2];
    for (int u = 0; u < U; ++u) {
      for (int v = 0; v < V; ++v) {
        // the sub-problem's tiles are blocks (u*R + d)*V + v, d < R
        const int g0 = u * p.R * V + v;
        const Out<AT, float> out = {
            dst + g0 * p.ts, V * p.ts, y,
            ((a * p.Rk + g0) * p.loG + c) * p.blk_out,
            (int64_t)V * p.loG * p.blk_out, p.r, col0, kFRT, last};
        const float* W = Wt + (((a * p.loG + c) * U + u) * V + v) * wsize;
        if (cur == nullptr) {
          const Src<AT> src = {x, ((a * p.Rk + g0) * p.loG + c) * p.blk_in,
                               (int64_t)V * p.loG * p.blk_in, p.r, col0, vec};
          gemm_ffma<AT, true>(W, p.R * m, p.R * kt, p.R, kt, nullptr, 0,
                                    src, m, out, ring);
        } else {
          gemm_ffma<AT, false>(W, p.R * m, p.R * kt, p.R, kt,
                                     cur + g0 * p.ts, V * p.ts, Src<AT>{}, m,
                                     out, ring);
        }
      }
    }
    __syncthreads();
    cur = dst;
    ++nint;
    V *= p.R;
  }
}

// ----------------------------------------------------------------- MMA ----

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8x8 bf16 matrices; lane l gives the address of row l%8 of matrix l/8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(s));
}

// MMA engine: out = W @ X for one sub-problem, with bf16 weights and bf16
// tiles of row stride ld (X: nd tiles of kt rows at in_base + d*in_stride).
// Weight chunks of 256 rows x 32 columns stream through a ring of kMStages
// stages with 16-byte cp.async.
template <typename AT, int RT>
__device__ __forceinline__ void gemm_mma(const bf16* __restrict__ W, int M,
                                         int ldw, int nd, int kt,
                                         const bf16* in_base, int in_stride,
                                         int mt, const Out<AT, bf16>& out,
                                         bf16* ws, int ld, bool aligned) {
  constexpr int WC = RT / kMWN;  // columns per warp
  constexpr int NT = WC / 8;     // n8 tiles per warp
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 3;
  const int wn = warp >> 2;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  // ldmatrix: this lane addresses row (lane & 7) of matrix (lane >> 3)
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;  // row in a 16-row pair
  const int lcol = (lane >> 4) * 8;                     // second column block
  const int nq = (kt + kMKC - 1) / kMKC;
  const int nch = nd * nq;
  const bool vec = aligned && (kt % 8) == 0;  // then ldw % 8 == 0 as well
  for (int mc0 = 0; mc0 < M; mc0 += kRowsPerSweep) {
    const bool active = mc0 + wm * kMWarpRows < M;  // warp-uniform
    float acc[4][NT][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    // stage chunk ch (if any) and close a cp.async group either way, so
    // that the group count stays uniform for the waits
    auto issue = [&](int ch) {
      if (ch < nch) {
        const int d = ch / nq;
        const int q0 = (ch - d * nq) * kMKC;
        const int kc = min(kMKC, kt - q0);
        bf16* st = ws + (ch % kMStages) * kMStageElems;
#pragma unroll
        for (int i = 0; i < kMCopies; ++i) {
          const int s = i * kMThreads + tid;
          const int row = s / (kMKC / 8);
          const int cg = (s % (kMKC / 8)) * 8;
          const int gr = mc0 + row;
          bf16* dst = st + row * kMWStride + cg;
          const bf16* src = W + (int64_t)gr * ldw + d * kt + q0 + cg;
          if (vec && gr < M && cg < kc) {
            cp_async16(dst, src);
          } else {
            uint32_t h[8];
#pragma unroll
            for (int e = 0; e < 8; ++e)
              h[e] = (gr < M && cg + e < kc) ? __bfloat16_as_ushort(src[e]) : 0u;
            *reinterpret_cast<uint4*>(dst) =
                make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16),
                           h[4] | (h[5] << 16), h[6] | (h[7] << 16));
          }
        }
      }
      cp_async_commit();
    };
    __syncthreads();  // the ring's previous readers are done
#pragma unroll
    for (int sidx = 0; sidx < kMStages - 1; ++sidx) issue(sidx);
    for (int ch = 0; ch < nch; ++ch) {
      cp_async_wait<kMStages - 2>();
      __syncthreads();  // chunk ch landed; chunk ch-1's stage is free
      issue(ch + kMStages - 1);
      const int d = ch / nq;
      const int q0 = (ch - d * nq) * kMKC;
      const int kc = min(kMKC, kt - q0);
      if (active) {
        // A: rows of the staged weights; B: rows q0.. of input tile d
        const bf16* wa = ws + (ch % kMStages) * kMStageElems +
                         (wm * kMWarpRows + lrow) * kMWStride + lcol;
        const bf16* xb = in_base + d * in_stride + (q0 + lrow) * ld +
                         wn * WC + lcol;
        // columns kc..round16(kc) of the stage are zero, and the tile rows
        // they meet hold finite values, so the ragged tail adds nothing
#pragma unroll
        for (int ks = 0; ks < kMKC; ks += 16) {
          if (ks < kc) {
            uint32_t b[NT][2];
            if constexpr (NT == 1) {
              ldsm_x2_t(b[0], xb + ks * ld);
            } else {
#pragma unroll
              for (int ni = 0; ni < NT; ni += 2) {
                uint32_t t4[4];
                ldsm_x4_t(t4, xb + ks * ld + ni * 8);
                b[ni][0] = t4[0]; b[ni][1] = t4[1];
                b[ni + 1][0] = t4[2]; b[ni + 1][1] = t4[3];
              }
            }
#pragma unroll
            for (int mi = 0; mi < 4; ++mi) {
              uint32_t a[4];
              ldsm_x4(a, wa + mi * 16 * kMWStride + ks);
#pragma unroll
              for (int ni = 0; ni < NT; ++ni) mma_bf16(acc[mi][ni], a, b[ni]);
            }
          }
        }
      }
    }
    cp_async_wait<0>();
    if (active) {
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = mc0 + wm * kMWarpRows + mi * 16 + grp + h * 8;
          if (row < M) {
            int n[NT];
            float v[NT][2];
#pragma unroll
            for (int ni = 0; ni < NT; ++ni) {
              n[ni] = wn * WC + ni * 8 + tig * 2;
              v[ni][0] = acc[mi][ni][2 * h];
              v[ni][1] = acc[mi][ni][2 * h + 1];
            }
            store_row<AT, bf16, bf16, NT>(out, row, mt, n, v);
          }
        }
    }
  }
}

// Load 8 consecutive input elements (columns col.., of which `valid` exist)
// as floats rounded to bf16.
template <typename AT>
__device__ __forceinline__ void load8(const AT* src, int valid, bool vec,
                                      float (&v)[8]) {
  if (vec && valid >= 8) {
    if constexpr (std::is_same<AT, bf16>::value) {
      const uint4 q = *reinterpret_cast<const uint4*>(src);
      const bf16* h = reinterpret_cast<const bf16*>(&q);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = to_f(h[e]);
    } else {
      const float4 q0 = *reinterpret_cast<const float4*>(src);
      const float4 q1 = *reinterpret_cast<const float4*>(src + 4);
      v[0] = q0.x; v[1] = q0.y; v[2] = q0.z; v[3] = q0.w;
      v[4] = q1.x; v[5] = q1.y; v[6] = q1.z; v[7] = q1.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = e < valid ? to_f(src[e]) : 0.f;
  }
}

__device__ __forceinline__ void store8(bf16* dst, const float (&v)[8]) {
  uint4 q;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
  for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
  *reinterpret_cast<uint4*>(dst) = q;
}

// MMA pass: one CTA per (group, column tile); the group's tiles are loaded
// into shared memory first, the factors run between two buffers, the last
// level writes global memory.
template <typename AT, int RT>
__global__ void __launch_bounds__(kMThreads) k1_mma_kernel(const PassArgs p) {
  constexpr int C8 = RT / 8;  // 8-column chunks per tile row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* buf_in = reinterpret_cast<bf16*>(smem_raw);
  bf16* buf_out = buf_in + p.Rk * p.ts;
  bf16* ws = buf_in + 2 * p.Rk * p.ts;

  const int64_t bid = blockIdx.x;
  const int rt = (int)(bid % p.n_rtiles);
  const int64_t grp = bid / p.n_rtiles;
  const int c = (int)(grp % p.loG);
  const int64_t a = grp / p.loG;
  const int col0 = rt * RT;
  const int tid = threadIdx.x;

  // k-steps of 16 read tile rows up to the next multiple of 16: keep them
  // finite (they meet zero weights)
  uint4* z = reinterpret_cast<uint4*>(buf_in);
  for (int i = tid; i < 2 * p.Rk * p.ts / 8; i += kMThreads)
    z[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  // activations: (hiG, Rk, loG, rows, r) row-major; kLoadBatch chunks of 8
  // columns are loaded before any is stored, so the loads overlap
  const AT* x = static_cast<const AT*>(p.x);
  const bool vec = p.vec_in != 0;
  for (int g = 0; g < p.Rk; ++g) {
    const AT* xg = x + (((a * p.Rk + g) * p.loG + c) * p.blk_in) * p.r + col0;
    bf16* tg = buf_in + g * p.ts;
    const int nchunk = p.blk_in * C8;
    for (int q0 = tid; q0 < nchunk; q0 += kMThreads * kLoadBatch) {
      float v[kLoadBatch][8];
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int q = q0 + u * kMThreads;
        const int i = q / C8;
        const int j = (q - i * C8) * 8;
        const int valid = q < nchunk ? p.r - col0 - j : 0;
        load8<AT>(xg + (int64_t)i * p.r + j, valid, vec, v[u]);
      }
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int q = q0 + u * kMThreads;
        if (q < nchunk) {
          const int i = q / C8;
          store8(tg + i * p.ld + (q - i * C8) * 8, v[u]);
        }
      }
    }
  }
  __syncthreads();

  AT* y = static_cast<AT*>(p.y);
  const bool aligned = p.aligned != 0;
  if (p.leaf != nullptr) {
    // leaf weights: (hiG, 1, Rk, m0, k0); never the last factor of a pass
    const bf16* leaf = static_cast<const bf16*>(p.leaf);
    for (int g = 0; g < p.Rk; ++g) {
      const Out<AT, bf16> out = {buf_out + g * p.ts, 0, y, 0, 0, p.r, col0,
                                 p.ld, false};
      gemm_mma<AT, RT>(leaf + (a * p.Rk + g) * (int64_t)p.m0 * p.k0, p.m0,
                       p.k0, 1, p.k0, buf_in + g * p.ts, 0, p.m0, out, ws,
                       p.ld, aligned);
    }
    __syncthreads();
    bf16* t = buf_in; buf_in = buf_out; buf_out = t;
  }

  int V = 1;
  for (int t = 0; t < p.k; ++t) {
    int U = 1;
    for (int s = t + 1; s < p.k; ++s) U *= p.R;
    const int m = p.dims_m[t];
    const int kt = p.dims_k[t];
    const int64_t wsize = (int64_t)(p.R * m) * (p.R * kt);
    // level weights: (hiG, loG, U, V, R*m, R*k)
    const bf16* Wt = static_cast<const bf16*>(p.w[t]);
    const bool last = t == p.k - 1;
    for (int u = 0; u < U; ++u) {
      for (int v = 0; v < V; ++v) {
        // the sub-problem's tiles are blocks (u*R + d)*V + v, d < R
        const int g0 = u * p.R * V + v;
        const Out<AT, bf16> out = {
            buf_out + g0 * p.ts, V * p.ts, y,
            ((a * p.Rk + g0) * p.loG + c) * p.blk_out,
            (int64_t)V * p.loG * p.blk_out, p.r, col0, p.ld, last};
        gemm_mma<AT, RT>(Wt + (((a * p.loG + c) * U + u) * V + v) * wsize,
                         p.R * m, p.R * kt, p.R, kt, buf_in + g0 * p.ts,
                         V * p.ts, m, out, ws, p.ld, aligned);
      }
    }
    __syncthreads();
    bf16* tmp = buf_in; buf_in = buf_out; buf_out = tmp;
    V *= p.R;
  }
}

// --------------------------------------------------------------- WGMMA ----

struct WgArgs {
  CUtensorMap map_x;     // activation (rows, r), boxes of 64 rows x 64 cols
  CUtensorMap map_w;     // level weights (hiG*loG*2m, 2kt), boxes 2m x 64
  CUtensorMap map_leaf;  // leaf weights (NB*m0, k0), boxes m0 x 64
  CUtensorMap map_y;     // output (rows, r), boxes of m rows x 64 cols
  int64_t items;         // (group, column tile) pairs
  int has_leaf, m, kt, m0, k0, loG, blk_in, blk_out, r, n_rtiles;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
// Wait for the phase of the given parity; trap after about 2^24 polls
// (seconds), so that a lost arrival fails the launch instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n == (1u << 24)) __trap();
  }
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}
// 2-D TMA load of the box at (column c0, row c1) into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
// 2-D TMA store of the box at (column c0, row c1) from shared memory.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Wait until this thread's TMA stores have read their shared memory
// (kRead) or are complete.
template <bool kRead>
__device__ __forceinline__ void tma_store_wait() {
  if constexpr (kRead)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void bar_consumers() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kGConsumers) : "memory");
}
// Barrier of one consumer warpgroup (ids 2 and 3).
__device__ __forceinline__ void bar_warpgroup(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1).
// K-major operands (the weights): rows of 128 bytes, SBO = 8 rows; a k16
// step moves the start by 32 bytes. MN-major operands (the activations,
// columns contiguous): LBO = the distance between 64-column blocks, SBO = 8
// rows of 128 bytes; a k16 step moves the start by 16 rows.
__device__ __forceinline__ uint64_t gdesc(uint32_t addr, uint32_t lbo,
                                          uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accumulator reads or writes across a wgmma
// issue or wait.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define K1_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
// d (64 x 128, f32) += A (64 x 16, bf16, K-major) * B (16 x 128, bf16,
// MN-major), both from shared memory.
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : K1_F4(0), K1_F4(4), K1_F4(8), K1_F4(12), K1_F4(16), K1_F4(20),
        K1_F4(24), K1_F4(28), K1_F4(32), K1_F4(36), K1_F4(40), K1_F4(44),
        K1_F4(48), K1_F4(52), K1_F4(56), K1_F4(60)
      : "l"(da), "l"(db), "r"(1));
}
#undef K1_F4

// WGMMA pass (R = 2, one level, bf16 weights and activations). A persistent
// CTA walks (group, 128-column tile) items. Warp 8 lane 0 fills a ring of
// kGStages stages by TMA, each a 64-deep chunk of weights (up to 256 rows)
// and, when the chunk's input comes from global memory, its 64 x 128 input
// rows. Warpgroup w (0 or 1) computes output block w: rows w*m.. of the
// mixing matrix, m/64 tiles of 64 x 128 in registers; on pass 0 first leaf
// block w (rows w*m0.. of a leaf chunk), whose output goes to the shared
// region `obuf` in the layout the level reads. Each warpgroup writes its
// output rows to `obuf` ([w][64-column block][m rows], 128-byte swizzle)
// and one of its threads stores them by TMA, which runs on while the next
// item's products do.
template <int MT>
__global__ void __launch_bounds__(kGThreads, 1)
    k1_wgmma_kernel(__grid_constant__ const WgArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzle atoms: 1024 B
  unsigned char* gbase = smem_raw + (base - raw);
  constexpr int S = kGStages;
  const uint32_t obuf = base + S * kGStageBytes;
  const uint32_t leaf_lbo = 2 * p.m0 * kGRowBytes;  // leaf output: 64 columns
  const uint32_t bars = obuf + wgmma_obuf_bytes(p.has_leaf, p.m0, p.m);
  // full[s] at bars + 8s, empty[s] at bars + 8(S + s)
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (S + s), kGConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int nq0 = p.k0 / kGKC;  // leaf chunks per block
  const int nq = p.kt / kGKC;   // level chunks per input block
  const int M = 2 * p.m;

  if (tid >= kGConsumers) {
    // ---- producer
    if (tid == kGConsumers) {
      const CUtensorMap* map_x = &p.map_x;
      const CUtensorMap* map_w = &p.map_w;
      const CUtensorMap* map_leaf = &p.map_leaf;
      int cnt = 0;
      for (int64_t it = blockIdx.x; it < p.items; it += gridDim.x) {
        const int rt = (int)(it % p.n_rtiles);
        const int64_t grp = it / p.n_rtiles;
        const int c = (int)(grp % p.loG);
        const int64_t a = grp / p.loG;
        const int col0 = rt * kGN;
        auto load_x = [&](uint32_t st, uint32_t full, int d, int q) {
          const int row = (int)(((a * 2 + d) * p.loG + c) * p.blk_in) + q * kGKC;
          tma_load(st + kGABytes, map_x, full, col0, row);
          tma_load(st + kGABytes + kGBBytes / 2, map_x, full, col0 + 64, row);
        };
        if (p.has_leaf) {
          for (int q = 0; q < nq0; ++q)
            for (int d = 0; d < 2; ++d, ++cnt) {
              const int s = cnt % S;
              const uint32_t st = base + s * kGStageBytes;
              const uint32_t full = bars + 8 * s;
              mbar_wait(bars + 8 * (S + s), ((cnt / S) & 1) ^ 1);
              mbar_expect_tx(full, p.m0 * kGRowBytes + kGBBytes);
              tma_load(st + d * p.m0 * kGRowBytes, map_leaf, full, q * kGKC,
                       (int)((a * 2 + d) * p.m0));
              load_x(st, full, d, q);
            }
        }
        for (int d = 0; d < 2; ++d)
          for (int q = 0; q < nq; ++q, ++cnt) {
            const int s = cnt % S;
            const uint32_t st = base + s * kGStageBytes;
            const uint32_t full = bars + 8 * s;
            mbar_wait(bars + 8 * (S + s), ((cnt / S) & 1) ^ 1);
            mbar_expect_tx(full,
                           M * kGRowBytes + (p.has_leaf ? 0 : kGBBytes));
            tma_load(st, map_w, full, d * p.kt + q * kGKC, (int)(grp * M));
            if (!p.has_leaf) load_x(st, full, d, q);
          }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns output block wg
  const int wg = tid / 128;
  const int l = tid % 128;
  const int wrow = (l / 32) * 16 + (l % 32) / 4;  // row in a 64-row tile (+8)
  const int wcol = (l % 4) * 2;                   // column in an 8-col block
  const int mt = p.m / 64;
  const int mt0 = p.m0 / 64;
  const CUtensorMap* map_y = &p.map_y;
  float acc[MT][64];
  int cnt = 0;
  auto zero = [&]() {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[i][j] = 0.f;
  };
  auto fence_all = [&]() {
#pragma unroll
    for (int i = 0; i < MT; ++i) fence_acc(acc[i]);
  };
  // acc tiles (n tiles of 64 rows) as bf16 into a swizzled region of
  // 64-column blocks `cb_bytes` apart, starting at row `row0`
  auto put_tiles = [&](int n, uint32_t region, uint32_t cb_bytes, int row0) {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i < n) {
#pragma unroll
        for (int j8 = 0; j8 < kGN / 8; ++j8)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = row0 + i * 64 + wrow + 8 * h;
            const uint32_t off = (j8 / 8) * cb_bytes + row * kGRowBytes +
                                 (((j8 % 8) ^ (row & 7)) << 4) + wcol * 2;
            *reinterpret_cast<__nv_bfloat162*>(gbase + (region - base) +
                                               off) =
                __floats2bfloat162_rn(acc[i][j8 * 4 + 2 * h],
                                      acc[i][j8 * 4 + 2 * h + 1]);
          }
      }
    }
  };
  for (int64_t it = blockIdx.x; it < p.items; it += gridDim.x) {
    const int rt = (int)(it % p.n_rtiles);
    const int64_t grp = it / p.n_rtiles;
    const int c = (int)(grp % p.loG);
    const int64_t a = grp / p.loG;
    const int col0 = rt * kGN;
    int prev = -1;  // stage whose release waits for the next wgmma wait
    if (p.has_leaf) {
      zero();
      for (int q = 0; q < nq0; ++q)
        for (int d = 0; d < 2; ++d, ++cnt) {
          const int s = cnt % S;
          mbar_wait(bars + 8 * s, (cnt / S) & 1);
          if (d == wg) {
            const uint32_t st = base + s * kGStageBytes;
            fence_all();
            wg_fence();
#pragma unroll
            for (int ks = 0; ks < kGKC / 16; ++ks) {
              const uint64_t db =
                  gdesc(st + kGABytes + ks * 16 * kGRowBytes, kGBBytes / 2,
                        8 * kGRowBytes);
#pragma unroll
              for (int i = 0; i < MT; ++i)
                if (i < mt0)
                  wgmma_m64n128(
                      acc[i],
                      gdesc(st + (wg * p.m0 + i * 64) * kGRowBytes + ks * 32,
                            16, 8 * kGRowBytes),
                      db);
            }
            wg_commit();
            wg_wait<1>();
            fence_all();
            if (prev >= 0) mbar_arrive(bars + 8 * (S + prev));
            prev = s;
          } else {
            wg_wait<0>();
            fence_all();
            if (prev >= 0) mbar_arrive(bars + 8 * (S + prev));
            prev = -1;
            mbar_arrive(bars + 8 * (S + s));
          }
        }
      wg_wait<0>();
      fence_all();
      if (prev >= 0) mbar_arrive(bars + 8 * (S + prev));
      prev = -1;
      // obuf is free: the previous item's stores have read it, and both
      // warpgroups' products are done with it
      if (l == 0) tma_store_wait<true>();
      bar_consumers();
      put_tiles(mt0, obuf, leaf_lbo, wg * p.m0);
      // make the stores visible to wgmma (the async proxy), then to all
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_consumers();
    }

    zero();
    for (int d = 0; d < 2; ++d)
      for (int q = 0; q < nq; ++q, ++cnt) {
        const int s = cnt % S;
        const uint32_t st = base + s * kGStageBytes;
        mbar_wait(bars + 8 * s, (cnt / S) & 1);
        fence_all();
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < kGKC / 16; ++ks) {
          const uint64_t db =
              p.has_leaf
                  ? gdesc(obuf + (d * p.m0 + q * kGKC + ks * 16) * kGRowBytes,
                          leaf_lbo, 8 * kGRowBytes)
                  : gdesc(st + kGABytes + ks * 16 * kGRowBytes, kGBBytes / 2,
                          8 * kGRowBytes);
#pragma unroll
          for (int i = 0; i < MT; ++i)
            if (i < mt)
              wgmma_m64n128(
                  acc[i],
                  gdesc(st + (wg * p.m + i * 64) * kGRowBytes + ks * 32, 16,
                        8 * kGRowBytes),
                  db);
        }
        wg_commit();
        wg_wait<1>();
        fence_all();
        if (prev >= 0) mbar_arrive(bars + 8 * (S + prev));
        prev = s;
      }
    wg_wait<0>();
    fence_all();
    if (prev >= 0) mbar_arrive(bars + 8 * (S + prev));

    // epilogue: this warpgroup's rows into its part of obuf, then TMA
    // stores of its two 64-column blocks
    const uint32_t mine = obuf + wg * 2 * p.m * kGRowBytes;
    if (p.has_leaf) {
      bar_consumers();  // both warpgroups have read the leaf output
    } else {
      if (l == 0) tma_store_wait<true>();  // the previous item's stores
      bar_warpgroup(wg);
    }
    put_tiles(mt, mine, p.m * kGRowBytes, 0);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_warpgroup(wg);
    if (l == 0) {
      const int row = (int)(((a * 2 + wg) * p.loG + c) * p.blk_out);
      tma_store(map_y, mine, col0, row);
      tma_store(map_y, mine + p.m * kGRowBytes, col0 + 64, row);
    }
  }
  if (l == 0) tma_store_wait<false>();
}

// ---------------------------------------------------------------- host ----

int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Shared memory of one CTA; ops/fused_butterfly.py `_pass_smem_bytes`
// mirrors each of these.
// FFMA: the ring, and nbuf buffers of Rk tiles of int_rows x kFRT floats
// for the pass's intermediates.
size_t ffma_smem_bytes(int Rk, int int_rows, int nbuf) {
  return sizeof(float) * ((size_t)kFStages * kFStageElems +
                          (size_t)nbuf * Rk * int_rows * kFRT);
}
// MMA: two buffers of Rk bf16 tiles of maxrows (rounded up to the 16-row
// k-step) x (r_tile + 8), and the weight ring.
size_t mma_smem_bytes(int Rk, int maxrows, int r_tile) {
  return sizeof(bf16) * (2 * (size_t)Rk * round_up(maxrows, 16) *
                             (r_tile + kMPad) +
                         (size_t)kMStages * kMStageElems);
}
// WGMMA: 1024 bytes of alignment slack, the ring, the output staging
// region and the ring's two barriers per stage.
size_t wgmma_smem_bytes(int has_leaf, int m0, int m) {
  return 1024 + (size_t)kGStages * kGStageBytes +
         wgmma_obuf_bytes(has_leaf, m0, m) + 16 * (size_t)kGStages;
}

template <typename K>
int launch_kernel(K kern, int64_t blocks, int threads, size_t smem,
                  cudaStream_t stream, const PassArgs& p) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (blocks <= 0 || blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Column tiles: FFMA 64, MMA 128, 64 or 32.
template <typename AT>
int launch_ffma(const PassArgs& p, int r_tile, size_t smem, cudaStream_t s) {
  const int64_t blocks = (int64_t)p.hiG * p.loG * p.n_rtiles;
  if (r_tile != kFRT) return (int)cudaErrorInvalidValue;
  return launch_kernel(k1_ffma_kernel<AT>, blocks, kFThreads, smem, s, p);
}
template <typename AT>
int launch_mma(const PassArgs& p, int r_tile, size_t smem, cudaStream_t s) {
  const int64_t blocks = (int64_t)p.hiG * p.loG * p.n_rtiles;
  if (r_tile == 128)
    return launch_kernel(k1_mma_kernel<AT, 128>, blocks, kMThreads, smem, s, p);
  if (r_tile == 64)
    return launch_kernel(k1_mma_kernel<AT, 64>, blocks, kMThreads, smem, s, p);
  if (r_tile == 32)
    return launch_kernel(k1_mma_kernel<AT, 32>, blocks, kMThreads, smem, s, p);
  return (int)cudaErrorInvalidValue;
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no link
// against libcuda).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(f);
  }
  return fn;
}

// A 2-D bf16 tensor map of (rows, cols) row-major, boxes of box_rows x 64
// columns (128 bytes), 128-byte swizzle.
bool bf16_map(CUtensorMap* m, const void* ptr, uint64_t rows, uint64_t cols,
              uint32_t box_rows) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)kGKC, box_rows};
  const cuuint32_t es[2] = {1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
             dims, strides, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// What the WGMMA engine takes; the planner routes every other pass to the
// FFMA or MMA engine (ops/fused_butterfly.py `_wgmma_takes` mirrors it).
bool wgmma_takes(const PassArgs& p, int act_bf16, int w_bf16) {
  auto rank_ok = [](int m) { return m == 64 || m == 128; };
  return act_bf16 && w_bf16 && p.R == 2 && p.k == 1 && rank_ok(p.dims_m[0]) &&
         p.dims_k[0] % kGKC == 0 &&
         (p.leaf == nullptr || (rank_ok(p.m0) && p.k0 % kGKC == 0)) &&
         p.r % 8 == 0 && ((uintptr_t)p.x & 15) == 0 &&
         ((uintptr_t)p.y & 15) == 0 &&
         (int64_t)p.hiG * 2 * p.loG * p.blk_in < INT32_MAX &&
         (int64_t)p.hiG * p.loG * 2 * p.dims_m[0] < INT32_MAX;
}

int launch_wgmma(const PassArgs& p, cudaStream_t s) {
  WgArgs g = {};
  const int m = p.dims_m[0], kt = p.dims_k[0];
  const bool leaf = p.leaf != nullptr;
  if (!bf16_map(&g.map_x, p.x, (uint64_t)p.hiG * 2 * p.loG * p.blk_in, p.r,
                kGKC) ||
      !bf16_map(&g.map_w, p.w[0], (uint64_t)p.hiG * p.loG * 2 * m, 2 * kt,
                2 * m) ||
      (leaf && !bf16_map(&g.map_leaf, p.leaf, (uint64_t)p.hiG * 2 * p.m0,
                         p.k0, p.m0)) ||
      !bf16_map(&g.map_y, p.y, (uint64_t)p.hiG * 2 * p.loG * p.blk_out, p.r,
                m))
    return (int)cudaErrorInvalidValue;
  g.items = (int64_t)p.hiG * p.loG * p.n_rtiles;
  g.has_leaf = leaf;
  g.m = m;
  g.kt = kt;
  g.m0 = leaf ? p.m0 : 0;
  g.k0 = leaf ? p.k0 : 0;
  g.loG = p.loG;
  g.blk_in = p.blk_in;
  g.blk_out = p.blk_out;
  g.r = p.r;
  g.n_rtiles = p.n_rtiles;
  const size_t smem = wgmma_smem_bytes(leaf, g.m0, m);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int64_t grid = g.items < sms ? g.items : sms;
  void (*kern)(WgArgs) = k1_wgmma_kernel<1>;
  if (m == 128 || g.m0 == 128) kern = k1_wgmma_kernel<2>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (grid <= 0) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)grid, kGThreads, smem, s>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch one pass on `stream` through `engine` (0 FFMA, 1 MMA, 2 WGMMA);
// returns the cudaError_t of the launch.
int k1_pass(const void* x, void* y, const void* leaf, const void* const* w,
            const int* dims_m, const int* dims_k, int k, int R, int hiG,
            int loG, int blk_in, int blk_out, int m0, int k0, int r,
            int act_bf16, int w_bf16, int engine, int r_tile, void* stream) {
  // k = 0: the leaf alone, on the FFMA engine
  if (k < 0 || k > kMaxLevels || R < 2 || r < 1 ||
      (k == 0 && (leaf == nullptr || engine != kEngineFfma)))
    return (int)cudaErrorInvalidValue;
  PassArgs p = {};
  p.x = x;
  p.y = y;
  p.leaf = leaf;
  p.R = R;
  p.k = k;
  p.Rk = 1;
  for (int t = 0; t < k; ++t) p.Rk *= R;
  p.hiG = hiG;
  p.loG = loG;
  p.blk_in = blk_in;
  p.blk_out = blk_out;
  p.m0 = m0;
  p.k0 = k0;
  p.r = r;
  int maxrows = blk_in > blk_out ? blk_in : blk_out;
  if (leaf != nullptr && m0 > maxrows) maxrows = m0;
  // rows of the intermediates (the leaf's and every level's but the last)
  int int_rows = leaf != nullptr ? m0 : 0;
  p.aligned = leaf == nullptr || ((uintptr_t)leaf & 15) == 0;
  for (int t = 0; t < k; ++t) {
    p.w[t] = w[t];
    p.dims_m[t] = dims_m[t];
    p.dims_k[t] = dims_k[t];
    if (dims_m[t] > maxrows) maxrows = dims_m[t];
    if (dims_k[t] > maxrows) maxrows = dims_k[t];
    if (t < k - 1 && dims_m[t] > int_rows) int_rows = dims_m[t];
    if (((uintptr_t)w[t] & 15) != 0) p.aligned = 0;
  }
  p.n_rtiles = (r + r_tile - 1) / r_tile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (engine == kEngineWgmma) {
    if (r_tile != kGN || !wgmma_takes(p, act_bf16, w_bf16))
      return (int)cudaErrorInvalidValue;
    return launch_wgmma(p, s);
  }
  if (engine == kEngineFfma) {
    if (w_bf16) return (int)cudaErrorInvalidValue;
    const int n_int = k == 0 ? 0 : (leaf != nullptr) + k - 1;
    p.vec_in = !act_bf16 && (r % 4) == 0 && ((uintptr_t)x & 15) == 0;
    p.ld = kFRT;
    p.ts = int_rows * kFRT;
    const size_t smem = ffma_smem_bytes(p.Rk, int_rows, n_int < 2 ? n_int : 2);
    if (act_bf16) return launch_ffma<bf16>(p, r_tile, smem, s);
    return launch_ffma<float>(p, r_tile, smem, s);
  }
  if (engine == kEngineMma) {
    if (!w_bf16) return (int)cudaErrorInvalidValue;
    p.vec_in = (r % 8) == 0 && ((uintptr_t)x & 15) == 0;
    p.ld = r_tile + kMPad;
    p.ts = round_up(maxrows, 16) * p.ld;
    const size_t smem = mma_smem_bytes(p.Rk, maxrows, r_tile);
    if (act_bf16) return launch_mma<bf16>(p, r_tile, smem, s);
    return launch_mma<float>(p, r_tile, smem, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* k1_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
