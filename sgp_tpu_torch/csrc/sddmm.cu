// Block-sampled SDDMM for Hopper (sm_90a): for each stored block g of a
// 128x128 BSR pattern, out[g] = Q[rows[g]] @ K[cols[g]]^T, the scores of
// block-sparse graph attention at the stored blocks only.
//
// Replaces the TPU kernel sgp_tpu/ops/sddmm.py::_make_sddmm_kernel (launched
// by _sddmm_pallas_padded, entered by bsr_sddmm(variant="pallas")). Same
// result: [nnzb, 128, 128] f32, every element of every tile written, rows and
// columns past N exactly 0 (the TPU path pads q and k with zero rows). The
// TPU kernel walks the blocks in order on one core with double-buffered DMA
// and 128-wide D tiles; here persistent CTAs walk equal ranges of the blocks
// on every SM, and q and k are read unpadded.
//
// What bounds it on this card. Per block: a 64 KB f32 tile stored against
// 2 * 128 * 128 * D flop. At the attention slice (N 5,016, D 64, 1,600
// blocks) the stores are 105 MB, 31 us at 3.35 TB/s; the f32-accurate
// products are 3.4 GFLOP, 50 us by FFMA at 67 TFLOP/s but 20 us as 3xTF32 on
// the tensor cores at their published rate (three TF32 passes at 495
// TFLOP/s). So the products go to the tensor cores, where by that rate the
// store would set the pace (below: mma.sync does not reach it); at D = 16
// the store does. q and k (2.6 MB at the slice) come from L2.
//
// Design.
// - Work. A unit is one 32-wide D slab of one stored block. A persistent
//   grid of CTAs (as many as fit on the card's SMs, one an SM) takes equal
//   contiguous ranges of the blocks in their stored order, each block's
//   slabs in order. The blocks of a block row are adjacent there, so a CTA
//   keeps the row's Q tile in shared memory (D up to 64 in f32, 128 in
//   bf16) and copies only K's slabs until the row changes; above that width
//   Q's slabs stream beside K's. A block's sums stay in one CTA's registers.
// - Copies. Each unit's K slab (and Q slab, when the unit needs one) comes in
//   by 16-byte cp.async in a ring of 3 stages, two units ahead of the
//   products. The copy zero-fills the D tail and the rows past N. The wrapper
//   pads q or k into an aligned buffer where a row start is not 16-byte
//   aligned (D = 1 in f32, a strided head view).
// - Products. 8 warps, 4 along the rows x 2 along the columns, each a 32 x 64
//   tile of mma.sync fragments. f32: m16n8k8 in 3xTF32 (mma3): a new row's
//   Q slab is split into TF32 hi/lo once, when it lands, into a layout where
//   one 16-byte load gives a lane {hi, lo} of two fragment elements; K's
//   fragments are split in registers by integer rounding (split_int). bf16:
//   m16n8k16 on ldmatrix fragments, Q copied into its resident tile as it
//   lands. k steps past D are skipped (D = 16 runs 2 of a slab's 4).
// - Numerics. The tensor cores round an mma's sum toward zero: each k8 (f32)
//   or k16 (bf16) step's partial is formed from 0 and added into the f32
//   registers by FADD, so no sum over D sits in an mma accumulator (a bias
//   that the max error cannot see). No plain TF32, no wgmma for f32: one TF32
//   pass keeps 11 bits, and the TPU path runs Precision.HIGHEST.
// - Store. A finished tile goes out a warp at a time: each warp stages its
//   16 x 64 halves in its own shared memory (rows padded for conflict-free
//   writes) and writes them back as 16-byte streaming stores, full 128-byte
//   lines, while the other warps run their products; the stores drain while
//   the warp goes on to the next block. Every element of a tile is written by
//   one thread in a fixed order: two calls give the same bits, no atomics, no
//   workspace.
// - Resources (ptxas, sm_90a): __launch_bounds__(256, 1); f32 168 registers,
//   bf16 155, no spill (phase 1 of chip_smoke.py fails on one); 216 KB (f32)
//   / 130 KB (bf16) of dynamic shared memory; one CTA of 8 warps an SM.
//
// What holds it back (tools/k2_probe.py, CUDA graphs, H100 80GB HBM3 at
// 700 W): at the f32 slice it takes 0.113 ms against 0.032 of bytes. With
// two of the three TF32 passes taken out it takes 0.075: an m16n8k8 TF32
// mma.sync costs about 3 SM clocks, so the 3xTF32 products alone need ~56
// us, more than the store. Without the store it takes 0.094, without the
// products 0.054: the two overlap only in part. 16 warps a CTA (32 x 32
// tiles), the k loop unrolled by 2, the three passes interleaved over all
// fragments, and the store by bulk copy (cp.async.bulk) from a whole staged
// tile each changed the f32 time by less than 2% (the bulk copy cost bf16
// 10%); K's slabs split once into shared memory (a second barrier a unit,
// two ring stages) cost f32 19%. bf16 (one pass) runs at 0.046 ms, D = 16 at 0.051 (f32) and 0.037
// (bf16), where the store sets the pace.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_common.cuh"

namespace {

constexpr int kBlock = 128;                  // BSR tile edge
constexpr int kBK = 32;                      // D slab: a unit of work
constexpr int kThreads = 256;                // 4 x 2 warps of 32 x 64
constexpr int kStages = 3;                   // ring of staged units
constexpr int kWarpCols = 64;
constexpr int kNi = kWarpCols / 8;           // n tiles of 8 a warp
constexpr int kOutLd = kWarpCols + 8;        // staged output row, floats
constexpr int kOutBytes = (kThreads / 32) * 16 * kOutLd * 4;
constexpr int kMaxDevices = 64;

// One dtype's layout. A ring stage holds a unit's K slab, then its Q slab,
// as they come from memory ([row][d], rows of kLd elements). The resident Q
// tile holds kQSlabs slabs a row: f32 as uint32 words, each k8 step's 8
// columns as {hi, lo} of c, c + 4 for c = 0..3 (16 words), the row padded to
// 16 words past a multiple of 32 banks; bf16 as it came, padded by 8.
template <typename T>
struct Cfg {
  static constexpr bool kBf = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kEl = 16 / (int)sizeof(T);          // elements a 16-byte copy
  static constexpr int kLd = kBK + (kBf ? 8 : 4);          // staged slab row, elements
  static constexpr int kSlab = kBlock * kLd * (int)sizeof(T);
  static constexpr int kStage = 2 * kSlab;                 // K slab, Q slab
  static constexpr int kQSlabs = kBf ? 4 : 2;              // resident Q: D <= 128 / 64
  static constexpr int kQLd = kBf ? kQSlabs * kBK + 8 : kQSlabs * 2 * kBK + 16;
  static constexpr int kQBytes = kBlock * kQLd * 4 / (kBf ? 2 : 1);
  static constexpr int kBytes = kStages * kStage + kQBytes + kOutBytes;
};

// Copy the slab d0..d0+32 of the 128 rows from row0 of x (row stride ld) to
// s[row][d] by cp.async; columns past d and rows past n read as 0.
template <typename T>
__device__ __forceinline__ void copy_slab(const T* __restrict__ x, long long ld, int row0,
                                          int d0, int n, int d, T* s) {
  using S = Cfg<T>;
  constexpr int kRowChunks = kBK / S::kEl;
  constexpr int kChunks = kBlock * kRowChunks;
#pragma unroll
  for (int i = 0; i < kChunks / kThreads; ++i) {
    const int c = i * kThreads + threadIdx.x;
    const int m = c / kRowChunks, col = (c % kRowChunks) * S::kEl;
    const int left = d - d0 - col;
    const int bytes = row0 + m < n && left > 0
                          ? (left < S::kEl ? left : S::kEl) * (int)sizeof(T) : 0;
    cp_async16(s + m * S::kLd + col,
               bytes ? x + (long long)(row0 + m) * ld + d0 + col : x, bytes);
  }
}

// f32: a landed Q slab split into TF32 hi/lo, into slot `slot` of the
// resident tile (layout in Cfg)
__device__ __forceinline__ void stage_q(const float* __restrict__ raw, uint32_t* qt,
                                        int slot) {
  using S = Cfg<float>;
#pragma unroll
  for (int i = 0; i < kBlock * kBK / 4 / kThreads; ++i) {
    const int c = i * kThreads + threadIdx.x;
    const int m = c / (kBK / 4), j = c % (kBK / 4);   // float4 j: columns 4j..4j+3
    const float4 v = *reinterpret_cast<const float4*>(raw + m * S::kLd + 4 * j);
    uint32_t* w = qt + m * S::kQLd + slot * 2 * kBK + (j / 2) * 16 + (j % 2) * 2;
    const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      uint32_t hi, lo;
      split_int(e[t], hi, lo);
      *reinterpret_cast<uint2*>(w + 4 * t) = make_uint2(hi, lo);
    }
  }
}

// bf16: a landed Q slab copied into slot `slot` of the resident tile
__device__ __forceinline__ void stage_q(const __nv_bfloat16* __restrict__ raw,
                                        __nv_bfloat16* qt, int slot) {
  using S = Cfg<__nv_bfloat16>;
  constexpr int kRowChunks = kBK / S::kEl;
#pragma unroll
  for (int i = 0; i < kBlock * kRowChunks / kThreads; ++i) {
    const int c = i * kThreads + threadIdx.x;
    const int m = c / kRowChunks, col = (c % kRowChunks) * S::kEl;
    *reinterpret_cast<uint4*>(qt + m * S::kQLd + slot * kBK + col) =
        *reinterpret_cast<const uint4*>(raw + m * S::kLd + col);
  }
}

// f32: acc += Q_slab @ K_slab^T for the warp's 32 x 64 tile over `steps` k8
// steps, each step's partial formed from 0 by three TF32 mmas, added by FADD
__device__ __forceinline__ void products(const uint32_t* __restrict__ qt, int slot,
                                         const float* __restrict__ ks, int steps,
                                         float (&acc)[2][kNi][4]) {
  using S = Cfg<float>;
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const int wm = (threadIdx.x >> 5) & 3, wn = threadIdx.x >> 7;  // warp row, column
#pragma unroll 1
  for (int kk = 0; kk < steps; ++kk) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const uint32_t* a = qt + (wm * 32 + mi * 16 + g) * S::kQLd + slot * 2 * kBK + kk * 16 + c * 4;
      const uint4 x = *reinterpret_cast<const uint4*>(a);
      const uint4 y = *reinterpret_cast<const uint4*>(a + 8 * S::kQLd);
      ah[mi][0] = x.x; al[mi][0] = x.y; ah[mi][2] = x.z; al[mi][2] = x.w;
      ah[mi][1] = y.x; al[mi][1] = y.y; ah[mi][3] = y.z; al[mi][3] = y.w;
    }
#pragma unroll
    for (int ni = 0; ni < kNi; ++ni) {
      const float* b = ks + (wn * kWarpCols + ni * 8 + g) * S::kLd + kk * 8 + c;
      uint32_t bh0, bl0, bh1, bl1;
      split_int(b[0], bh0, bl0);
      split_int(b[4], bh1, bl1);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        float p[4] = {0.f, 0.f, 0.f, 0.f};
        mma3<false, false>(p, ah[mi], al[mi], bh0, bh1, bl0, bl1);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] += p[e];
      }
    }
  }
}

// bf16: the same over `steps` k16 steps, one m16n8k16 partial from 0 per
// fragment and step, added by FADD
__device__ __forceinline__ void products(const __nv_bfloat16* __restrict__ qt, int slot,
                                         const __nv_bfloat16* __restrict__ ks, int steps,
                                         float (&acc)[2][kNi][4]) {
  using S = Cfg<__nv_bfloat16>;
  const int lane = threadIdx.x & 31;
  const int wm = (threadIdx.x >> 5) & 3, wn = threadIdx.x >> 7;  // warp row, column
#pragma unroll 1
  for (int kk = 0; kk < steps; ++kk) {
    uint32_t a[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      ldmatrix_x4(a[mi], qt + (wm * 32 + mi * 16 + (lane & 15)) * S::kQLd + slot * kBK +
                             kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < kNi / 2; ++np) {
      uint32_t b[4];  // K rows are the columns of B: no transpose
      ldmatrix_x4(b, ks + (wn * kWarpCols + np * 16 + (lane >> 4) * 8 + (lane & 7)) * S::kLd +
                         kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          float p[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(p, a[mi], b[2 * h], b[2 * h + 1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][np * 2 + h][e] += p[e];
        }
    }
  }
}

// The warp's 32 x 64 part of a finished tile to `tile`, 16 rows at a time
// through the warp's staging rows: full 128-byte lines by 16-byte streaming
// stores (the scores are read once, by the softmax, and outgrow L2); then
// acc = 0.
__device__ __forceinline__ void store_tile(float (&acc)[2][kNi][4], float* stage,
                                           float* __restrict__ tile) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const int wm = (threadIdx.x >> 5) & 3, wn = threadIdx.x >> 7;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    __syncwarp();  // the lanes' reads of the last half are done
#pragma unroll
    for (int ni = 0; ni < kNi; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *reinterpret_cast<float2*>(stage + (g + 8 * h) * kOutLd + ni * 8 + 2 * c) =
            make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
        acc[mi][ni][2 * h] = acc[mi][ni][2 * h + 1] = 0.f;
      }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = i * 2 + (lane >> 4), col = (lane & 15) * 4;
      const float4 v = *reinterpret_cast<const float4*>(stage + r * kOutLd + col);
      __stcs(reinterpret_cast<float4*>(tile + (size_t)(wm * 32 + mi * 16 + r) * kBlock +
                                       wn * kWarpCols + col), v);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
sddmm_kernel(const T* __restrict__ q, const T* __restrict__ k, const int* __restrict__ rows,
             const int* __restrict__ cols, float* __restrict__ out, int nnzb, int n, int d,
             long long ldq, long long ldk) {
  using S = Cfg<T>;
  using QWord = typename std::conditional<S::kBf, __nv_bfloat16, uint32_t>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  QWord* qt = reinterpret_cast<QWord*>(smem + kStages * S::kStage);
  float* stage = reinterpret_cast<float*>(smem + kStages * S::kStage + S::kQBytes) +
                 (threadIdx.x >> 5) * 16 * kOutLd;

  const int ns = d > kBK ? (d + kBK - 1) / kBK : 1;  // slabs a block; D = 0 stores zeros
  const int g0 = (int)((long long)nnzb * blockIdx.x / gridDim.x);
  const int g1 = (int)((long long)nnzb * (blockIdx.x + 1) / gridDim.x);
  const int units = (g1 - g0) * ns;
  const bool resident = ns <= S::kQSlabs;
  // whether unit u copies its Q slab: always when Q streams, else for the
  // blocks that start a block row in this CTA's range
  auto with_q = [&](int u) {
    const int g = g0 + u / ns;
    return !resident || g == g0 || rows[g] != rows[g - 1];
  };
  auto issue = [&](int u) {
    const int g = g0 + u / ns, d0 = (u % ns) * kBK;
    T* st = reinterpret_cast<T*>(smem + (u % kStages) * S::kStage);
    copy_slab<T>(k, ldk, cols[g] * kBlock, d0, n, d, st);
    if (with_q(u)) copy_slab<T>(q, ldq, rows[g] * kBlock, d0, n, d, st + kBlock * S::kLd);
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < units) issue(s);
    cp_async_commit();
  }
  float acc[2][kNi][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNi; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  for (int u = 0; u < units; ++u) {
    cp_async_wait<kStages - 2>();  // unit u has landed
    __syncthreads();               // ... for every thread; unit u - 1 is done
    if (u + kStages - 1 < units) issue(u + kStages - 1);
    cp_async_commit();
    const T* st = reinterpret_cast<const T*>(smem + (u % kStages) * S::kStage);
    const int s = u % ns, slot = s % S::kQSlabs;
    if (with_q(u)) {
      stage_q(st + kBlock * S::kLd, qt, slot);
      __syncthreads();
    }
    const int left = d - s * kBK < kBK ? d - s * kBK : kBK;   // columns of this slab
    const int step = S::kBf ? 16 : 8;
    products(qt, slot, st, left > 0 ? (left + step - 1) / step : 0, acc);
    if (s == ns - 1)
      store_tile(acc, stage, out + (size_t)(g0 + u / ns) * kBlock * kBlock);
  }
}

// CTAs of the kernel that fit on the card at once, cached per device
template <typename T>
int resident_ctas(int* ctas) {
  static int cache[kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < kMaxDevices && cache[dev] > 0) {
    *ctas = cache[dev];
    return 0;
  }
  const int err = allow_smem(sddmm_kernel<T>, Cfg<T>::kBytes);
  if (err != 0) return err;
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sddmm_kernel<T>, kThreads,
                                                Cfg<T>::kBytes);
  *ctas = sms * per_sm;
  const int e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;
  if (*ctas <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (dev < kMaxDevices) cache[dev] = *ctas;
  return 0;
}

template <typename T>
int launch(const void* q, const void* k, const void* rows, const void* cols, void* out,
           int nnzb, int n, int d, long long ldq, long long ldk, void* stream) {
  if (nnzb <= 0) return static_cast<int>(cudaGetLastError());
  int ctas = 0;
  const int err = resident_ctas<T>(&ctas);
  if (err != 0) return err;
  if (ctas > nnzb) ctas = nnzb;
  sddmm_kernel<T><<<ctas, kThreads, Cfg<T>::kBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const int*>(rows),
      static_cast<const int*>(cols), static_cast<float*>(out), nnzb, n, d, ldq, ldk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out[nnzb, 128, 128] f32 = per stored block g, Q[rows[g]] @ K[cols[g]]^T.
// q and k are [n, d] with row strides ldq and ldk (elements), unit column
// stride, 16-byte aligned rows (base and stride); rows and cols are [nnzb]
// int32 block indices. All pointers are device pointers; the launch goes on
// `stream`. Returns cudaGetLastError().
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
