// K2: the block-sparse cell program, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel `_cell_kernel`, butterfly_tpu/ops/cellsp.py:95
// (built by `_cell_call`, :142; driven by `_apply_cells`, :187).
//
// What it computes. A cell adds one contribution to the output:
//   kind 0:  y[dst : dst+128, :] += W[widx] @ buf[src][blk*128 : +128, :]
//   kind 1:  y[dst : dst+128, :] += buf[src][blk*128 : +128, :]
// with `dst` only 8-aligned. The kernel computes, for every output row and
// column, the sum of all cells' contributions in IEEE float32 (FFMA only, no
// TF32). Source rows past the end of a buffer read as zero, and ragged
// columns are masked, so neither the buffers nor r need padding.
//
// What differs from the TPU design. The TPU kernel keeps an Hb-row output
// band resident in VMEM over a sequential grid, folds 128-row band overlaps
// afterwards, and splits the program into SMEM-sized segments. None of that
// exists here. The host (ops/cellsp.py) builds, for every 128-row output
// tile, a CSR list of *entries*: a cell whose `dst` is not a multiple of 128
// straddles two tiles and enters both lists, each time with the row
// sub-range of its weight tile (w_row0, nrows) and its row offset inside the
// output tile (out_row0). No weight is duplicated and no atomics are needed.
//
// The grid is (output tiles x column tiles of 128). A CTA of 256 threads
// walks its tile's kind-0 list in K-chunks of 16: each chunk stages the
// entry's weight rows (k-major, 4-byte cp.async) and the source chunk
// (row-major, 16-byte cp.async with zero fill) in a 3-deep ring. A thread
// owns an 8 x 8 block of the tile: rows {4ty..4ty+3} and {64+4ty..+3},
// columns {4tx..4tx+3} and {64+4tx..+3}. A warp therefore owns two aligned
// 8-row groups, and since entry boundaries are multiples of 8, a warp either
// takes part in an entry's rows or skips them as a whole (no divergence, no
// zero-filled weight rows). Kind-1 entries are added at the end straight
// from global memory. Every tile is stored once; a tile without entries
// stores zeros.
//
// Accuracy. Each entry's 128-deep product is summed in registers and then
// added into the tile's running totals, which live in shared memory (each
// thread reads and writes only its own 64 totals, once per entry, so no
// barrier is needed). A first version kept one register accumulator per
// output across the whole entry list — FMA chains of ~7,700 terms in
// bench E's second pass — and read 8.8e-7 against the operator where the
// plain passes read 4.0e-7; summing per entry reads 4.0e-7 too. The totals
// take 64 KB of shared memory, so the K-chunk is 16 deep to keep two CTAs
// per SM (115,456 bytes each).
//
// What bounds it on the H100. At bench E's shapes (n=4096, r=1024) the two
// passes hold 255 MB of weights and do 130.7 GFLOP: 1.95 ms at the 67 TFLOP/s
// float32 (non-tensor) peak against 0.12 ms to move weights, x, t and y once
// at 3.35 TB/s, so it is bound by operations. With a 128-column tile each
// weight tile is read r/128 times (8 at r=1024, 2.0 GB from HBM or L2: the
// column tiles of one output tile are launched next to each other).
// Left for later PRs: tensor cores (3xTF32 or a split-bf16 scheme to keep
// IEEE-level accuracy), load balance between dense and sparse output tiles,
// and a persistent schedule.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kG = 128;              // GM = GK: rows and depth of a cell
constexpr int kRT = 128;             // columns per CTA
constexpr int kThreads = 256;
constexpr int kKC = 16;              // K-chunk (keeps two CTAs per SM)
constexpr int kChunks = kG / kKC;    // chunks per entry
constexpr int kStages = 3;           // cp.async ring depth
constexpr int kWStride = kG + 4;     // staged weight chunk: k-major rows
constexpr int kWElems = kKC * kWStride;
constexpr int kXElems = kKC * kRT;   // staged source chunk: row-major
constexpr int kStageElems = kWElems + kXElems;
constexpr int kMaxBufs = 4;
constexpr int kAccElems = kG * kRT;  // running totals of the tile
constexpr size_t kSmemBytes = sizeof(float) * (kStages * kStageElems + kAccElems);

struct CellArgs {
  const float* W;                 // (T_w, 128, 128) weight tiles
  const float* bufs[kMaxBufs];    // (rows_i, r) row-major
  int64_t buf_rows[kMaxBufs];
  const int* ptr0;                // (n_tiles + 1) CSR of kind-0 entries
  const int4* ent0;
  const int* ptr1;                // (n_tiles + 1) CSR of kind-1 entries
  const int4* ent1;
  float* y;                       // (n_out, r)
  int n_out, r, n_rtiles;
  int vec;                        // r % 4 == 0 and every pointer 16-byte aligned
};

// An entry: x = weight tile index (kind 0), y = source buffer,
// z = first source row, w = out_row0 | w_row0 << 8 | nrows << 16.
struct Entry {
  int widx, src, src_row0, out_row0, w_row0, nrows;
};

__device__ __forceinline__ Entry unpack(const int4 e) {
  Entry d;
  d.widx = e.x;
  d.src = e.y;
  d.src_row0 = e.z;
  d.out_row0 = e.w & 0xff;
  d.w_row0 = (e.w >> 8) & 0xff;
  d.nrows = (e.w >> 16) & 0xff;
  return d;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
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

// Does this thread's row quad [q0, q0+4) lie inside the entry's rows? Entry
// boundaries are multiples of 8, so the answer is the same for the whole
// warp (its two 8-row groups are aligned).
__device__ __forceinline__ bool quad_in(const Entry& e, int q0) {
  return q0 >= e.out_row0 && q0 < e.out_row0 + e.nrows;
}

// Buffer i's pointer and row count without indexing the parameter arrays
// at run time (which would copy them to the stack).
__device__ __forceinline__ const float* buf_of(const CellArgs& p, int i) {
  return i == 0 ? p.bufs[0] : i == 1 ? p.bufs[1] : i == 2 ? p.bufs[2] : p.bufs[3];
}
__device__ __forceinline__ int64_t rows_of(const CellArgs& p, int i) {
  return i == 0 ? p.buf_rows[0] : i == 1 ? p.buf_rows[1] : i == 2 ? p.buf_rows[2]
                                                                    : p.buf_rows[3];
}

__global__ void __launch_bounds__(kThreads, 2) k2_cell_kernel(const CellArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int tx = tid % 16;           // column group
  const int ty = tid / 16;           // row group
  const int rt = blockIdx.x % p.n_rtiles;
  const int tile = blockIdx.x / p.n_rtiles;
  const int col0 = rt * kRT;
  const int r = p.r;

  // running totals in shared memory (each thread touches only its own
  // elements), one entry's product in registers
  float* tot = smem + kStages * kStageElems;
  float acc[8][8];
  auto tot_at = [&](int i, int h) {
    const int row = i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4;
    return reinterpret_cast<float4*>(tot + row * kRT + (h ? 64 : 0) + 4 * tx);
  };
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) *tot_at(i, h) = make_float4(0.f, 0.f, 0.f, 0.f);

  // ---- kind 0: pipelined weight x source products, summed per entry ----
  const int e0 = p.ptr0[tile];
  const int nch = (p.ptr0[tile + 1] - e0) * kChunks;
  const int pk = tid % kKC;          // staged weight column (k) of this thread
  const int prow = tid / kKC;        // staged weight row, plus 16*i

  // stage chunk ch (if any) and close a cp.async group either way, so that
  // the group count stays uniform for the waits
  auto issue = [&](int ch) {
    if (ch < nch) {
      const Entry e = unpack(__ldg(p.ent0 + e0 + ch / kChunks));
      const int q0 = (ch % kChunks) * kKC;
      float* ws = smem + (ch % kStages) * kStageElems;
      float* xs = ws + kWElems;
      const float* Wt = p.W + (int64_t)e.widx * (kG * kG) +
                        (int64_t)(e.w_row0 - e.out_row0) * kG + q0 + pk;
#pragma unroll
      for (int i = 0; i < kG / (kThreads / kKC); ++i) {
        const int o = prow + (kThreads / kKC) * i;  // output row of the tile
        if (o >= e.out_row0 && o < e.out_row0 + e.nrows)
          cp_async4(ws + pk * kWStride + o, Wt + (int64_t)o * kG, 4);
      }
      const float* buf = buf_of(p, e.src);
      const int64_t nrow = rows_of(p, e.src);
#pragma unroll
      for (int i = 0; i < kXElems / 4 / kThreads; ++i) {
        const int s = i * kThreads + tid;
        const int kr = s / (kRT / 4);
        const int c = (s % (kRT / 4)) * 4;
        const int64_t row = (int64_t)e.src_row0 + q0 + kr;
        const int col = col0 + c;
        const bool rok = row < nrow;
        float* dst = xs + kr * kRT + c;
        if (p.vec) {
          const bool ok = rok && col < r;
          cp_async16(dst, ok ? buf + row * r + col : buf, ok ? 16 : 0);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const bool ok = rok && col + u < r;
            cp_async4(dst + u, ok ? buf + row * r + col + u : buf, ok ? 4 : 0);
          }
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int ch = 0; ch < nch; ++ch) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk ch landed; chunk ch-1's stage is free
    issue(ch + kStages - 1);
    const Entry e = unpack(__ldg(p.ent0 + e0 + ch / kChunks));
    const bool a0 = quad_in(e, 4 * ty);
    const bool a1 = quad_in(e, 64 + 4 * ty);
    if (ch % kChunks == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
    if (a0 || a1) {
      const float* ws = smem + (ch % kStages) * kStageElems;
      const float* xs = ws + kWElems;
#pragma unroll 8
      for (int kk = 0; kk < kKC; ++kk) {
        const float4 w0 = *reinterpret_cast<const float4*>(ws + kk * kWStride + 4 * ty);
        const float4 w1 = *reinterpret_cast<const float4*>(ws + kk * kWStride + 64 + 4 * ty);
        const float4 x0 = *reinterpret_cast<const float4*>(xs + kk * kRT + 4 * tx);
        const float4 x1 = *reinterpret_cast<const float4*>(xs + kk * kRT + 64 + 4 * tx);
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
            for (int j = 0; j < 8; ++j)
              acc[4 + i][j] = fmaf(wv[i], xv[j], acc[4 + i][j]);
        }
      }
    }
    if (ch % kChunks == kChunks - 1 && (a0 || a1)) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float4 t = *tot_at(i, h);
          t.x += acc[i][4 * h];
          t.y += acc[i][4 * h + 1];
          t.z += acc[i][4 * h + 2];
          t.w += acc[i][4 * h + 3];
          *tot_at(i, h) = t;
        }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 t = *tot_at(i, h);
      acc[i][4 * h] = t.x;
      acc[i][4 * h + 1] = t.y;
      acc[i][4 * h + 2] = t.z;
      acc[i][4 * h + 3] = t.w;
    }

  // columns this thread owns: 4tx.. and 64+4tx.. of the tile
  auto col_of = [&](int j) { return col0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4); };
  auto row_of = [&](int i) { return i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4; };

  // ---- kind 1: source rows added straight from global memory -----------
  for (int k = p.ptr1[tile]; k < p.ptr1[tile + 1]; ++k) {
    const Entry e = unpack(__ldg(p.ent1 + k));
    const float* buf = buf_of(p, e.src);
    const int64_t nrow = rows_of(p, e.src);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int o = row_of(i);
      if (o < e.out_row0 || o >= e.out_row0 + e.nrows) continue;
      const int64_t row = (int64_t)e.src_row0 + (o - e.out_row0 + e.w_row0);
      if (row >= nrow) continue;
      const float* src = buf + row * r;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = col_of(4 * h);
        if (p.vec) {
          if (col < r) {
            const float4 v = __ldg(reinterpret_cast<const float4*>(src + col));
            acc[i][4 * h] += v.x;
            acc[i][4 * h + 1] += v.y;
            acc[i][4 * h + 2] += v.z;
            acc[i][4 * h + 3] += v.w;
          }
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (col + u < r) acc[i][4 * h + u] += __ldg(src + col + u);
        }
      }
    }
  }

  // ---- one store of the tile --------------------------------------------
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t row = (int64_t)tile * kG + row_of(i);
    if (row >= p.n_out) continue;
    float* dst = p.y + row * r;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = col_of(4 * h);
      if (p.vec) {
        if (col < r)
          *reinterpret_cast<float4*>(dst + col) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                          acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (col + u < r) dst[col + u] = acc[i][4 * h + u];
      }
    }
  }
}

}  // namespace

extern "C" {

// Launch the cell program on `stream`; returns the cudaError_t of the launch.
int k2_cells(const float* W, const void* const* bufs, const int64_t* buf_rows,
             int n_bufs, const int* ptr0, const int* ent0, const int* ptr1,
             const int* ent1, float* y, int n_out, int r, void* stream) {
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
  p.ptr0 = ptr0;
  p.ent0 = reinterpret_cast<const int4*>(ent0);
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

const char* k2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
