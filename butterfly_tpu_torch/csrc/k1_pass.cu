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
// What bounds it on the H100. At the flagship shape (NB=1024 blocks of 128
// rows, 10 levels, r=2048 columns, bf16) one apply does 1.44e12 flops and
// moves 1.8 GB: 1.46 ms at the 989 TFLOP/s bf16 tensor-core peak against
// 0.53 ms at 3.35 TB/s, so it is bound by operations. The f32 line can only
// use FFMA (67 TFLOP/s) and is bound by operations too.
//
// The simple design here. One CTA per (group, column tile). The group's R^k
// activation tiles live in shared memory, row-major, in two buffers that
// swap roles level by level; the TPU kernel's ~100 MB VMEM group does not
// exist here (227 KB per CTA), so the host picks the fusion depth k and the
// column tile from the shared-memory size `smem_bytes` below. Tiles are
// loaded with 16-byte loads, several in flight per thread. Weights stream
// through shared memory in K-chunks, in a ring filled by cp.async while the
// previous chunk is multiplied. Each CTA reads its group's weights once per
// pass, and the CTAs of one group are launched next to each other so that
// the weights come from L2. Output rows are swept 256 at a time, so any rank
// works; ragged columns are masked (r=1 works). The last level of a pass
// writes straight from registers to global memory.
//   * float weights (FFMA engine, 256 threads): float tiles; each thread owns
//     8 rows x (tile/8) columns of the output and runs FFMA.
//   * bf16 weights (MMA engine, 512 threads): bf16 tiles with rows padded by
//     8 elements, so ldmatrix reads them without bank conflicts; 16 warps in
//     4 x 4 over (rows, columns), each owning 64 rows, run
//     mma.sync.m16n8k16 (bf16 in, f32 sums) on the tensor cores.
// Left for later PRs: overlapping a CTA's tile load, products and stores
// (they run back to back, and in bf16 the products are the smaller part),
// wgmma, TMA loads with an mbarrier ring, warp specialisation, and deeper
// fusion for 128-row blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kRowsPerSweep = 256;  // output rows per sweep
constexpr int kMaxLevels = 16;
constexpr int kLoadBatch = 4;       // 16-byte input loads in flight per thread

// FFMA engine
constexpr int kFThreads = 256;
constexpr int kFTX = 8;                       // threads across a column tile
constexpr int kFTY = kFThreads / kFTX;        // 32 threads down the rows
constexpr int kFTM = 8;                       // rows per thread: two quads
constexpr int kFQuad = kFTY * 4;              // 128: offset of the second quad
constexpr int kFKC = 32;                      // K-chunk
constexpr int kFWStride = kRowsPerSweep + 4;  // staged (k-major) row stride
constexpr int kFStages = 2;                   // cp.async ring depth
constexpr int kFStageElems = kFKC * kFWStride;
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

template <typename WT>
__host__ __device__ constexpr int threads_for() {
  return std::is_same<WT, bf16>::value ? kMThreads : kFThreads;
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
  int vec_in;   // input rows can be read 8 elements (16 B or more) at a time
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

template <int TN>
__device__ __forceinline__ void load_row(const float* p, float (&v)[TN]) {
  if constexpr (TN % 4 == 0) {
#pragma unroll
    for (int j = 0; j < TN; j += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + j);
      v[j] = q.x; v[j + 1] = q.y; v[j + 2] = q.z; v[j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < TN; j += 2) {
      const float2 q = *reinterpret_cast<const float2*>(p + j);
      v[j] = q.x; v[j + 1] = q.y;
    }
  }
}

// FFMA engine: out = W @ X for one sub-problem.
//   W:   M x (nd*kt) float, row-major in global memory, leading dim ldw.
//   X:   nd input tiles of kt rows; tile d starts at in_base + d*in_stride.
//   out: M/mt output tiles of mt rows.
// Weight chunks of 256 rows x 32 columns are staged k-major (transposed)
// through a ring of kFStages stages with 4-byte cp.async.
template <typename AT, int RT>
__device__ __forceinline__ void gemm_ffma(const float* __restrict__ W, int M,
                                          int ldw, int nd, int kt,
                                          const float* in_base, int in_stride,
                                          int mt, const Out<AT, float>& out,
                                          float* ws) {
  constexpr int TN = RT / kFTX;
  const int tid = threadIdx.x;
  const int tx = tid % kFTX;
  const int ty = tid / kFTX;
  const int nq = (kt + kFKC - 1) / kFKC;
  const int nch = nd * nq;
  const int pk = tid % kFKC;          // staged column of this thread's copies
  const int prow = tid / kFKC;        // staged row (plus 8*i)
  for (int mc0 = 0; mc0 < M; mc0 += kRowsPerSweep) {
    float acc[kFTM][TN];
#pragma unroll
    for (int i = 0; i < kFTM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    // stage chunk ch (if any) and close a cp.async group either way
    auto issue = [&](int ch) {
      if (ch < nch) {
        const int d = ch / nq;
        const int q0 = (ch - d * nq) * kFKC;
        const int kc = min(kFKC, kt - q0);
        float* st = ws + (ch % kFStages) * kFStageElems + pk * kFWStride;
#pragma unroll 8
        for (int i = 0; i < kFCopies; ++i) {
          const int gr = mc0 + prow + 8 * i;
          if (pk < kc && gr < M)
            cp_async4(st + prow + 8 * i, W + (int64_t)gr * ldw + d * kt + q0 + pk);
          else
            st[prow + 8 * i] = 0.f;
        }
      }
      cp_async_commit();
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
      const float* xin = in_base + d * in_stride + q0 * RT + tx * TN;
      const float* wst = ws + (ch % kFStages) * kFStageElems + ty * 4;
#pragma unroll 4
      for (int kk = 0; kk < kc; ++kk) {
        const float* wrow = wst + kk * kFWStride;
        const float4 wa = *reinterpret_cast<const float4*>(wrow);
        const float4 wb = *reinterpret_cast<const float4*>(wrow + kFQuad);
        const float wv[kFTM] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
        float xv[TN];
        load_row<TN>(xin + kk * RT, xv);
#pragma unroll
        for (int i = 0; i < kFTM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(wv[i], xv[j], acc[i][j]);
      }
    }
    cp_async_wait<0>();
#pragma unroll
    for (int i = 0; i < kFTM; ++i) {
      const int row = mc0 + (i / 4) * kFQuad + ty * 4 + (i % 4);
      if (row < M) {
        int n[TN / 2];
        float v[TN / 2][2];
#pragma unroll
        for (int j = 0; j < TN / 2; ++j) {
          n[j] = tx * TN + 2 * j;
          v[j][0] = acc[i][2 * j];
          v[j][1] = acc[i][2 * j + 1];
        }
        store_row<AT, float, float, TN / 2>(out, row, mt, n, v);
      }
    }
  }
}

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

// MMA engine: the same contract as gemm_ffma, with bf16 weights and bf16
// tiles of row stride ld. Weight chunks of 256 rows x 32 columns stream
// through a ring of kMStages stages with 16-byte cp.async.
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
// as floats rounded to the weight type.
template <typename AT, typename WT>
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
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = round_to<WT>(v[e]);
}

__device__ __forceinline__ void store8(float* dst, const float (&v)[8]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(bf16* dst, const float (&v)[8]) {
  __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(dst);
  uint4 q;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
  for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
  *reinterpret_cast<uint4*>(d) = q;
}

template <typename AT, typename WT, int RT>
__global__ void __launch_bounds__(threads_for<WT>())
    k1_pass_kernel(const PassArgs p) {
  constexpr bool kMma = std::is_same<WT, bf16>::value;
  constexpr int NTH = threads_for<WT>();
  constexpr int C8 = RT / 8;  // 8-column chunks per tile row
  typedef typename std::conditional<kMma, bf16, float>::type ST;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ST* buf_in = reinterpret_cast<ST*>(smem_raw);
  ST* buf_out = buf_in + p.Rk * p.ts;
  ST* ws = buf_in + 2 * p.Rk * p.ts;

  const int64_t bid = blockIdx.x;
  const int rt = (int)(bid % p.n_rtiles);
  const int64_t grp = bid / p.n_rtiles;
  const int c = (int)(grp % p.loG);
  const int64_t a = grp / p.loG;
  const int col0 = rt * RT;
  const int tid = threadIdx.x;

  if constexpr (kMma) {
    // k-steps of 16 read tile rows up to the next multiple of 16: keep them
    // finite (they meet zero weights)
    uint4* z = reinterpret_cast<uint4*>(buf_in);
    for (int i = tid; i < 2 * p.Rk * p.ts / 8; i += NTH)
      z[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
  }

  // activations: (hiG, Rk, loG, rows, r) row-major; kLoadBatch chunks of 8
  // columns are loaded before any is stored, so the loads overlap
  const AT* x = static_cast<const AT*>(p.x);
  const bool vec = p.vec_in != 0;
  for (int g = 0; g < p.Rk; ++g) {
    const AT* xg = x + (((a * p.Rk + g) * p.loG + c) * p.blk_in) * p.r + col0;
    ST* tg = buf_in + g * p.ts;
    const int nchunk = p.blk_in * C8;
    for (int q0 = tid; q0 < nchunk; q0 += NTH * kLoadBatch) {
      float v[kLoadBatch][8];
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int q = q0 + u * NTH;
        const int i = q / C8;
        const int j = (q - i * C8) * 8;
        const int valid = q < nchunk ? p.r - col0 - j : 0;
        load8<AT, WT>(xg + (int64_t)i * p.r + j, valid, vec, v[u]);
      }
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int q = q0 + u * NTH;
        if (q < nchunk) {
          const int i = q / C8;
          store8(tg + i * p.ld + (q - i * C8) * 8, v[u]);
        }
      }
    }
  }
  __syncthreads();

  auto gemm = [&](const WT* W, int M, int ldw, int nd, int kt, const ST* in,
                  int in_stride, int mt, const Out<AT, ST>& out) {
    if constexpr (kMma)
      gemm_mma<AT, RT>(W, M, ldw, nd, kt, in, in_stride, mt, out, ws, p.ld,
                       p.aligned != 0);
    else
      gemm_ffma<AT, RT>(W, M, ldw, nd, kt, in, in_stride, mt, out, ws);
  };

  AT* y = static_cast<AT*>(p.y);
  if (p.leaf != nullptr) {
    // leaf weights: (hiG, 1, Rk, m0, k0); never the last factor of a pass
    const WT* leaf = static_cast<const WT*>(p.leaf);
    for (int g = 0; g < p.Rk; ++g) {
      const Out<AT, ST> out = {buf_out + g * p.ts, 0, y, 0, 0, p.r, col0, p.ld,
                               false};
      gemm(leaf + (a * p.Rk + g) * (int64_t)p.m0 * p.k0, p.m0, p.k0, 1, p.k0,
           buf_in + g * p.ts, 0, p.m0, out);
    }
    __syncthreads();
    ST* t = buf_in; buf_in = buf_out; buf_out = t;
  }

  int V = 1;
  for (int t = 0; t < p.k; ++t) {
    int U = 1;
    for (int s = t + 1; s < p.k; ++s) U *= p.R;
    const int m = p.dims_m[t];
    const int kt = p.dims_k[t];
    const int64_t wsize = (int64_t)(p.R * m) * (p.R * kt);
    // level weights: (hiG, loG, U, V, R*m, R*k)
    const WT* Wt = static_cast<const WT*>(p.w[t]);
    const bool last = t == p.k - 1;
    for (int u = 0; u < U; ++u) {
      for (int v = 0; v < V; ++v) {
        // the sub-problem's tiles are blocks (u*R + d)*V + v, d < R
        const int g0 = u * p.R * V + v;
        const Out<AT, ST> out = {
            buf_out + g0 * p.ts, V * p.ts, y,
            ((a * p.Rk + g0) * p.loG + c) * p.blk_out,
            (int64_t)V * p.loG * p.blk_out, p.r, col0, p.ld, last};
        gemm(Wt + (((a * p.loG + c) * U + u) * V + v) * wsize, p.R * m,
             p.R * kt, p.R, kt, buf_in + g0 * p.ts, V * p.ts, m, out);
      }
    }
    __syncthreads();
    ST* tmp = buf_in; buf_in = buf_out; buf_out = tmp;
    V *= p.R;
  }
}

template <typename AT, typename WT, int RT>
int launch(const PassArgs& p, size_t smem, cudaStream_t stream) {
  auto kern = k1_pass_kernel<AT, WT, RT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (int64_t)p.hiG * p.loG * p.n_rtiles;
  if (blocks <= 0 || blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, threads_for<WT>(), smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Column tiles: float weights 64 or 16, bf16 weights 128, 64 or 32.
template <typename AT, typename WT>
int launch_rt(const PassArgs& p, int r_tile, size_t smem, cudaStream_t s) {
  if constexpr (std::is_same<WT, bf16>::value) {
    if (r_tile == 128) return launch<AT, WT, 128>(p, smem, s);
    if (r_tile == 64) return launch<AT, WT, 64>(p, smem, s);
    if (r_tile == 32) return launch<AT, WT, 32>(p, smem, s);
  } else {
    if (r_tile == 64) return launch<AT, WT, 64>(p, smem, s);
    if (r_tile == 16) return launch<AT, WT, 16>(p, smem, s);
  }
  return (int)cudaErrorInvalidValue;
}

int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Rows held per tile: bf16 tiles round up to the 16-row k-step.
int tile_rows(int w_bf16, int maxrows) {
  return w_bf16 ? round_up(maxrows, 16) : maxrows;
}

// Tile row stride: bf16 rows are padded by 8 elements, which spreads the
// eight rows one ldmatrix reads over all 32 banks.
int tile_ld(int w_bf16, int r_tile) { return w_bf16 ? r_tile + kMPad : r_tile; }

// Shared memory one CTA needs: two activation buffers of Rk tiles and the
// weight ring (ops/fused_butterfly.py `_pass_smem_bytes` mirrors it).
size_t smem_bytes(int w_bf16, int Rk, int maxrows, int r_tile) {
  const size_t tiles =
      2 * (size_t)Rk * tile_rows(w_bf16, maxrows) * tile_ld(w_bf16, r_tile);
  if (w_bf16) return sizeof(bf16) * (tiles + (size_t)kMStages * kMStageElems);
  return sizeof(float) * (tiles + (size_t)kFStages * kFStageElems);
}

}  // namespace

extern "C" {

// Launch one pass on `stream`; returns the cudaError_t of the launch.
int k1_pass(const void* x, void* y, const void* leaf, const void* const* w,
            const int* dims_m, const int* dims_k, int k, int R, int hiG,
            int loG, int blk_in, int blk_out, int m0, int k0, int r,
            int act_bf16, int w_bf16, int r_tile, void* stream) {
  if (k < 1 || k > kMaxLevels || R < 2 || r < 1) return (int)cudaErrorInvalidValue;
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
  p.aligned = leaf == nullptr || ((uintptr_t)leaf & 15) == 0;
  for (int t = 0; t < k; ++t) {
    p.w[t] = w[t];
    p.dims_m[t] = dims_m[t];
    p.dims_k[t] = dims_k[t];
    if (dims_m[t] > maxrows) maxrows = dims_m[t];
    if (dims_k[t] > maxrows) maxrows = dims_k[t];
    if (((uintptr_t)w[t] & 15) != 0) p.aligned = 0;
  }
  p.vec_in = (r % 8) == 0 && ((uintptr_t)x & 15) == 0;
  p.ld = tile_ld(w_bf16, r_tile);
  p.ts = tile_rows(w_bf16, maxrows) * p.ld;
  p.n_rtiles = (r + r_tile - 1) / r_tile;
  const size_t smem = smem_bytes(w_bf16, p.Rk, maxrows, r_tile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (act_bf16) {
    if (w_bf16) return launch_rt<bf16, bf16>(p, r_tile, smem, s);
    return launch_rt<bf16, float>(p, r_tile, smem, s);
  }
  if (w_bf16) return launch_rt<float, bf16>(p, r_tile, smem, s);
  return launch_rt<float, float>(p, r_tile, smem, s);
}

const char* k1_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
