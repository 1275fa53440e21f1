// Block-sparse-row SpMM for Hopper (sm_90a): out = A @ x, with A stored as
// dense 128x128 tiles at its nonzero block positions (Graph.to_bsr).
//
// Replaces the TPU kernel sgp_tpu/ops/bsr_kernel.py::_make_flat_kernel
// (launched by _bsr_spmm_padded, entered by bsr_spmm_prepared). Same result:
// each output row accumulates over its block row's stored tiles in f32, and
// block rows without tiles give zeros. The TPU kernel's sequential grid, its
// double-buffered DMA semaphores and its padding of x to 128 are TPU matters
// and have no counterpart here.
//
// Design. One CTA owns one output tile: BM = 32 rows of one block row times
// BN = 128 columns of F. The grid is (block row, row slice, F tile), so a
// graph with only 40 block rows (5,016 nodes) still gives 160 CTAs at F = 128
// and 640 at F = 512. The CTA walks row_ptr[r]..row_ptr[r+1]; for each stored
// tile it stages a 32x32 slab of A and a 32x128 slab of x in shared memory,
// in f32, and accumulates a 4x8 register tile per thread with FFMA. The next
// slab is loaded into registers while the current one is multiplied. Ragged
// N and F are masked here (x is read unpadded, rows past N read as 0); no
// atomics, so the sum order is fixed and the result deterministic.
//
// Numerics. f32 tiles: f32 FFMA only, no TF32 and no tensor cores (the TPU
// path runs Precision.HIGHEST). bf16 tiles: x is read as bf16, products and
// sums are f32, and the output is rounded to bf16 as the Pallas kernel's
// bf16 out_shape does.
//
// What bounds it on this card. Each stored tile is read once per F tile
// (64 KB in f32) and multiplied against a 128-column x slab: 2*128^3 flop per
// tile per F tile, 64 flop per byte of the block store. The H100's FFMA ridge
// is about 20 flop/byte (67 TFLOP/s over 3.35 TB/s), so at F >= 128 the f32
// path is bound by the FFMA rate, not by the block store's bytes; x (2.6 MB at
// N = 5,016, F = 128) stays in L2. At the slice the synthetic generator orders
// nodes at random, so the 100-nn operator fills almost every block position
// (nnzb ~ 1,600 of 40x40, ~105 MB of f32 tiles per hop). wgmma with TF32 is
// excluded by the numerics above; bf16 tiles on wgmma, TMA and an RCM
// reordering (sgp_tpu/graph/sparse.py::rcm_order) that empties blocks are the
// ways to a faster kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;                  // BSR tile edge
constexpr int kBM = 32;                      // output rows per CTA
constexpr int kBN = 128;                     // output columns per CTA
constexpr int kBK = 32;                      // k slab staged in shared memory
constexpr int kTM = 4;                       // rows per thread
constexpr int kTN = 8;                       // columns per thread (2 x float4)
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 128
constexpr int kLda = kBK + 4;                // padded A row, 16-byte aligned
constexpr int kALoads = kBM * kBK / kThreads;         // 8
constexpr int kXLoads = kBK * kBN / kThreads;         // 32
constexpr int kSlabsPerTile = kBlock / kBK;           // 4

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Loads slab s of a CTA's walk into registers: tile g_begin + s / 4, k range
// (s % 4) * 32 .. +32, A rows m0 .. m0 + 32 and x columns n0 .. n0 + 128.
template <typename T>
__device__ __forceinline__ void load_slab(const T* __restrict__ blocks,
                                          const int* __restrict__ block_cols,
                                          const T* __restrict__ x, int g_begin,
                                          int s, int m0, int n0, int n_rows, int f,
                                          float (&a_reg)[kALoads],
                                          float (&x_reg)[kXLoads]) {
  const int tid = threadIdx.x;
  const int g = g_begin + s / kSlabsPerTile;
  const int k0 = (s % kSlabsPerTile) * kBK;
  const T* a = blocks + (size_t)g * kBlock * kBlock + (size_t)m0 * kBlock + k0;
#pragma unroll
  for (int i = 0; i < kALoads; ++i) {
    const int e = i * kThreads + tid;  // consecutive threads, consecutive k
    a_reg[i] = to_f32(a[(e / kBK) * kBlock + e % kBK]);
  }
  const int row0 = block_cols[g] * kBlock + k0;
#pragma unroll
  for (int i = 0; i < kXLoads; ++i) {
    const int e = i * kThreads + tid;  // consecutive threads, consecutive n
    const int row = row0 + e / kBN;
    const int col = n0 + e % kBN;
    x_reg[i] = (row < n_rows && col < f) ? to_f32(x[(size_t)row * f + col]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bsr_spmm_kernel(const T* __restrict__ blocks, const int* __restrict__ block_cols,
                const int* __restrict__ row_ptr, const T* __restrict__ x,
                T* __restrict__ out, int n_rows, int f) {
  __shared__ __align__(16) float a_s[kBM * kLda];  // [m][k]
  __shared__ __align__(16) float x_s[kBK * kBN];   // [k][n]

  const int r = blockIdx.x;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.z * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);  // column group, 0..15
  const int ty = tid / (kBN / kTN);  // row group, 0..7

  const int g_begin = row_ptr[r];
  const int n_slabs = (row_ptr[r + 1] - g_begin) * kSlabsPerTile;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  float a_reg[kALoads];
  float x_reg[kXLoads];
  if (n_slabs > 0)
    load_slab(blocks, block_cols, x, g_begin, 0, m0, n0, n_rows, f, a_reg, x_reg);
  for (int s = 0; s < n_slabs; ++s) {
#pragma unroll
    for (int i = 0; i < kALoads; ++i) {
      const int e = i * kThreads + tid;
      a_s[(e / kBK) * kLda + e % kBK] = a_reg[i];
    }
#pragma unroll
    for (int i = 0; i < kXLoads; ++i) x_s[i * kThreads + tid] = x_reg[i];
    __syncthreads();
    if (s + 1 < n_slabs)  // in flight during the FFMAs below
      load_slab(blocks, block_cols, x, g_begin, s + 1, m0, n0, n_rows, f, a_reg, x_reg);

#pragma unroll
    for (int k = 0; k < kBK; k += 4) {
      float4 a4[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        a4[i] = *reinterpret_cast<const float4*>(&a_s[(ty * kTM + i) * kLda + k]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 b0 = *reinterpret_cast<const float4*>(&x_s[(k + kk) * kBN + tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&x_s[(k + kk) * kBN + kBN / 2 + tx * 4]);
        const float b[kTN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          const float av = kk == 0 ? a4[i].x : kk == 1 ? a4[i].y : kk == 2 ? a4[i].z : a4[i].w;
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = r * kBlock + m0 + ty * kTM + i;
    if (row >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = n0 + (j < 4 ? tx * 4 + j : kBN / 2 + tx * 4 + j - 4);
      if (col < f) store_out(out + (size_t)row * f + col, acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* blocks, const void* block_cols, const void* row_ptr,
           const void* x, void* out, int n_block_rows, int n_rows, int f,
           void* stream) {
  if (n_block_rows > 0 && n_rows > 0 && f > 0) {
    const dim3 grid(n_block_rows, kBlock / kBM, (f + kBN - 1) / kBN);
    bsr_spmm_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(blocks), static_cast<const int*>(block_cols),
        static_cast<const int*>(row_ptr), static_cast<const T*>(x),
        static_cast<T*>(out), n_rows, f);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out[n_rows, f] = A @ x[n_rows, f]; blocks [nnzb, 128, 128], block_cols
// [nnzb] and row_ptr [n_block_rows + 1] int32. All pointers are device
// pointers; the launch goes on `stream`. Returns cudaGetLastError().
extern "C" int sgp_bsr_spmm_f32(const void* blocks, const void* block_cols,
                                const void* row_ptr, const void* x, void* out,
                                int n_block_rows, int n_rows, int f,
                                void* stream) {
  return launch<float>(blocks, block_cols, row_ptr, x, out, n_block_rows,
                       n_rows, f, stream);
}

extern "C" int sgp_bsr_spmm_bf16(const void* blocks, const void* block_cols,
                                 const void* row_ptr, const void* x, void* out,
                                 int n_block_rows, int n_rows, int f,
                                 void* stream) {
  return launch<__nv_bfloat16>(blocks, block_cols, row_ptr, x, out,
                               n_block_rows, n_rows, f, stream);
}
