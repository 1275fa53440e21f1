// Block-sampled SDDMM for Hopper (sm_90a): for each stored block g of a
// 128x128 BSR pattern, out[g] = Q[rows[g]] @ K[cols[g]]^T, the scores of
// block-sparse graph attention at the stored blocks only.
//
// Replaces the TPU kernel sgp_tpu/ops/sddmm.py::_make_sddmm_kernel (launched
// by _sddmm_pallas_padded, entered by bsr_sddmm(variant="pallas")). Same
// result: [nnzb, 128, 128] f32, every element of every tile written, rows and
// columns past N exactly 0 (the TPU path pads q and k with zero rows). The
// TPU kernel walks the blocks in order on one core with double-buffered DMA
// and 128-wide D tiles; here the stored blocks run in parallel, one CTA each,
// and q and k are read unpadded.
//
// Design. One CTA of 256 threads owns one 128x128 output tile. It walks D in
// slabs of 32: each thread loads 16 elements of the Q row tile and 16 of the
// K row tile (consecutive threads on consecutive d, so a warp reads 32
// contiguous values of one row), converts them to f32 and stores them
// transposed ([d][row]) in shared memory; then it accumulates an 8x8
// register tile (rows ty*4..+4 and 64+ty*4..+4, columns tx*4..+4 and
// 64+tx*4..+4) with f32 FFMA, two float4 reads of each slab per d. The D
// tail and the rows past N are masked in the loads and read as 0. q and k
// take a row stride, so a per-head view q[:, h] of [N, H, D] needs no copy.
// Two CTAs fit on an SM (launch bounds), so one CTA's stores overlap
// another's products.
//
// Numerics. f32 inputs: f32 FFMA only, no TF32 and no tensor cores (the TPU
// path runs Precision.HIGHEST). bf16 inputs: read as bf16, converted to f32
// and accumulated in f32; the product of two bf16 values is exact in f32, as
// on the MXU. The sum runs over d in order: deterministic.
//
// What bounds it on this card. Per block: 2*128*128*D flop against a 64 KB
// f32 output store (q and k tiles are small and stay in L2). The H100's FFMA
// ridge is about 20 flop/byte (67 TFLOP/s over 3.35 TB/s), and a block does
// D/2 flop per output byte: at D = 64 (32 flop/byte) the FFMA rate bounds it,
// at D = 16 (8 flop/byte) the output store does. wgmma is excluded for f32 by
// the numerics (it would run TF32); for bf16, wgmma with TMA-fed tiles, and
// fusing the masked softmax so the f32 scores never reach device memory, are
// the ways to a faster kernel and are left to later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;                         // BSR tile edge
constexpr int kBK = 32;                             // D slab staged in shared memory
constexpr int kThreads = 256;
constexpr int kLd = kBlock + 4;                     // padded [d][row] row, 16-byte aligned
constexpr int kLoads = kBlock * kBK / kThreads;     // 16 elements a thread a slab

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Stage the slab d0..d0+32 of the 128 rows starting at row0 of x (row stride
// ld) into s[d][row], in f32; rows >= n and columns >= d read as 0. Lane c of
// warp w loads column d0 + c of rows w, w + 8, ..., w + 120: one pointer
// stepped by 8 rows, so the unrolled loads cost few registers.
template <typename T>
__device__ __forceinline__ void load_slab(const T* __restrict__ x, long long ld,
                                          int row0, int d0, int n, int d,
                                          float* __restrict__ s) {
  constexpr int kRowStep = kThreads / kBK;  // 8
  const int c = threadIdx.x % kBK;
  const int w = threadIdx.x / kBK;
  const bool col_ok = d0 + c < d;
  const T* p = x + (long long)(row0 + w) * ld + d0 + c;
  float* sp = s + c * kLd + w;
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const bool ok = col_ok && row0 + w + i * kRowStep < n;
    sp[i * kRowStep] = ok ? to_f32(p[i * kRowStep * ld]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
sddmm_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const int* __restrict__ rows, const int* __restrict__ cols,
             float* __restrict__ out, int n, int d, long long ldq,
             long long ldk) {
  __shared__ __align__(16) float q_s[kBK * kLd];  // [d][row of the Q tile]
  __shared__ __align__(16) float k_s[kBK * kLd];  // [d][row of the K tile]

  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // column group
  const int ty = tid / 16;  // row group
  const int q_row0 = rows[g] * kBlock;
  const int k_row0 = cols[g] * kBlock;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int d0 = 0; d0 < d; d0 += kBK) {
    load_slab(q, ldq, q_row0, d0, n, d, q_s);
    load_slab(k, ldk, k_row0, d0, n, d, k_s);
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kBK; ++c) {
      const float4 a0 = *reinterpret_cast<const float4*>(&q_s[c * kLd + ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&q_s[c * kLd + 64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&k_s[c * kLd + tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&k_s[c * kLd + 64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // every element of the tile, padding included; streaming stores, since the
  // scores are read once by the softmax and outgrow L2 at the slice
  float* tile = out + (size_t)g * kBlock * kBlock;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
    float* p = tile + (size_t)row * kBlock;
    __stcs(reinterpret_cast<float4*>(p + tx * 4),
           make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    __stcs(reinterpret_cast<float4*>(p + 64 + tx * 4),
           make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* rows, const void* cols,
           void* out, int nnzb, int n, int d, long long ldq, long long ldk,
           void* stream) {
  if (nnzb > 0) {
    sddmm_kernel<T><<<nnzb, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const int*>(rows), static_cast<const int*>(cols),
        static_cast<float*>(out), n, d, ldq, ldk);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out[nnzb, 128, 128] f32 = per stored block g, Q[rows[g]] @ K[cols[g]]^T.
// q and k are [n, d] with row strides ldq and ldk (elements) and unit column
// stride; rows and cols are [nnzb] int32 block indices. All pointers are
// device pointers; the launch goes on `stream`. Returns cudaGetLastError().
extern "C" int sgp_sddmm_f32(const void* q, const void* k, const void* rows,
                             const void* cols, void* out, int nnzb, int n,
                             int d, long long ldq, long long ldk,
                             void* stream) {
  return launch<float>(q, k, rows, cols, out, nnzb, n, d, ldq, ldk, stream);
}

extern "C" int sgp_sddmm_bf16(const void* q, const void* k, const void* rows,
                              const void* cols, void* out, int nnzb, int n,
                              int d, long long ldq, long long ldk,
                              void* stream) {
  return launch<__nv_bfloat16>(q, k, rows, cols, out, nnzb, n, d, ldq, ldk,
                               stream);
}
