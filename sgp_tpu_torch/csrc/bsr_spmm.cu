// Block-sparse-row SpMM for Hopper (sm_90a): out = A @ x, with A stored as
// dense 128x128 tiles at its nonzero block positions (Graph.to_bsr).
//
// Replaces the TPU kernel sgp_tpu/ops/bsr_kernel.py::_make_flat_kernel
// (launched by _bsr_spmm_padded, entered by bsr_spmm_prepared). Same result:
// each output row is the f32 sum over its block row's stored tiles, and block
// rows without tiles give exact zeros. With bf16 tiles, x is read as bf16,
// products and sums are f32, and the output is rounded to bf16, as the Pallas
// kernel's bf16 out_shape does. The TPU kernel's sequential grid carries a
// block row's sum from one tile to the next; here the tiles are spread over
// every SM and the sums that cross CTAs are joined by a second pass.
//
// What bounds it on this card. The kernel multiplies each stored tile whole:
// 2 * 128 * 128 * F flop a tile, against 64 KB of f32 tiles read once (each
// n tile of 128 columns reads them again, mostly from L2). At the SGP slice
// (N 5,016, 1,600 of 40 x 40 block positions stored, 105 MB of f32 tiles)
// the bytes take 32 us at 3.35 TB/s; the f32-accurate products on the
// tensor cores (3xTF32, three TF32 passes at 495 TFLOP/s) take 5 us at
// F = 16, 20 us at F = 64, 41 us at F = 128 and 163 us at F = 512. So the
// bytes bound it up to F ~ 100 and the products above; the tiles' stored
// nonzeros alone (what chip_smoke.py's bound counts) are a few percent of
// the tiles, so by that count the bytes bound it at every F. bf16 tiles halve
// the bytes and run one bf16 pass at 989 TFLOP/s (7 us at F = 128).
//
// Design.
// - Work. A unit is one 32-deep k slab of one stored tile for one n tile of
//   BN columns (BN = 32, 64 or 128, the least that holds F, n tiles of 128
//   above). Units are ordered by block row, n tile, tile in CSR order, k slab.
//   A persistent grid of CTAs (as many as fit on the card's SMs) takes equal
//   contiguous ranges of that list, so every SM gets the same work whatever
//   the rows hold: a full 40 x 40 slice, one row with most tiles, empty rows.
// - Sums across CTAs. A CTA accumulates the 128 x BN output of its current
//   (block row, n tile) in registers and, at the segment's end, writes it
//   straight to out when its range held the whole segment. The segments cut
//   by the two ends of its range go to a workspace (two f32 tiles a CTA,
//   allocated by the wrapper); a second small kernel sums each cut segment's
//   parts in CTA order, 16 rows a CTA, and writes zeros for empty block
//   rows. No atomics and no waiting between CTAs: the sum order depends only
//   on the shapes and the SM count, and two calls give the same bits.
// - Products. 4 warps along the 128 rows x BN / 64 along the columns (one
//   at BN = 32), each a 32 x 64 tile of mma.sync fragments, up to 255
//   registers a thread (one CTA an SM at BN = 128, two below). f32: m16n8k8
//   in 3xTF32 (mma3, mma_common.cuh); x is split into TF32 hi/lo once, when
//   its slab is staged, into an interleaved shared-memory tile; A is split in
//   registers. bf16: m16n8k16 bf16 products, fragments by ldmatrix.
// - Numerics. The tensor cores round an mma's sum toward zero: each k8 (f32)
//   or k16 (bf16) step's partial is formed from 0 and added into the f32
//   registers by FADD, so no sum over a block row's k steps sits in an mma
//   accumulator (a bias that the max error cannot see).
// - Copies. Each slab of A (128 x 32) and of x (32 x BN) comes in by cp.async
//   16 bytes a thread, in a ring of 3 (f32) or 4 (bf16) stages, 2 or 3 slabs
//   in flight ahead of the products. A rows (36 floats, 40 bf16), the split
//   x rows (BN + 4 uint2) and the bf16 x rows (BN + 8) are padded so that
//   the fragment loads hit 32 distinct banks.
// - Ragged shapes. Rows of x past N are zero-filled by the copy; the wrapper
//   pads x's rows to a multiple of 16 bytes (F = 1 becomes 4 or 8 columns),
//   and every store is masked to the N x F output.
//
// What holds it back (tools/k1_variants.py, PERF.md): with the copies or
// the products taken out in turn, the products alone take ~85% of the f32
// time at F = 128. ptxas emits cvt.rna.tf32 as several instructions, and
// each mma.sync needs its own fragment loads, splits and FADDs, so the warps
// run out of issue slots long before the tensor cores are busy. wgmma with
// TMA is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_common.cuh"

namespace {

constexpr int kBlock = 128;                      // BSR tile edge
constexpr int kBK = 32;                          // k depth of a slab: a unit of work
constexpr int kUnitsPerTile = kBlock / kBK;      // 4
constexpr int kStagesF32 = 3;                    // ring of staged slabs
constexpr int kStagesBf16 = 4;
constexpr int kWarpCols = 64;                    // columns of a warp's tile (32 rows)
constexpr int kResidentThreads = 256;            // threads an SM: <= 255 registers each
constexpr int kJoinThreads = 256;
constexpr int kJoinRows = 16;                    // rows of a segment a join CTA sums
constexpr int kMaxDevices = 64;

// One instantiation's layout: 4 warps along the 128 rows x BN / kWarpCols
// along the columns, each a 32 x kWarpCols tile of mma fragments; shared
// memory holds kStages x (A slab, x slab), then (f32) the split x slab.
template <typename T, int BN>
struct Cfg {
  static constexpr bool kBf = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kWC = BN < kWarpCols ? BN : kWarpCols;
  static constexpr int kNi = kWC / 8;                       // n tiles of 8 a warp
  static constexpr int kThreads = 4 * (BN / kWC) * 32;
  static constexpr int kMinBlocks = kResidentThreads / kThreads;
  static constexpr int kEl = 16 / (int)sizeof(T);           // elements a 16-byte copy
  static constexpr int kLda = kBK + (kBf ? 8 : 4);          // A row, elements
  static constexpr int kLdx = BN + (kBf ? 8 : 0);           // staged x row, elements
  static constexpr int kLds = BN + 4;                       // split x row, uint2
  static constexpr int kStages = kBf ? kStagesBf16 : kStagesF32;
  static constexpr int kA = kBlock * kLda * (int)sizeof(T);
  static constexpr int kX = kBK * kLdx * (int)sizeof(T);
  static constexpr int kStage = kA + kX;
  static constexpr int kBytes = kStages * kStage + (kBf ? 0 : kBK * kLds * 8);
};

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// A place in the unit list: block row r (first tile row_ptr[r], cnt tiles),
// n tile j, tile t of the row, k slab ks.
struct Cursor {
  int r, first, cnt, j, t, ks;
};

// The unit u of the list. Units of row r, n tile j start at
// (row_ptr[r] * nt + j * cnt) * kUnitsPerTile.
__device__ Cursor locate(const int* __restrict__ row_ptr, int n_block_rows, int nt,
                         long long u) {
  const long long p = u / kUnitsPerTile;  // tile-unit
  const int q = (int)(p / nt);
  int lo = 0, hi = n_block_rows;  // row_ptr[lo] <= q < row_ptr[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (row_ptr[mid] <= q) lo = mid; else hi = mid;
  }
  Cursor c;
  c.r = lo;
  c.first = row_ptr[lo];
  c.cnt = row_ptr[lo + 1] - c.first;
  const long long off = p - (long long)c.first * nt;
  c.j = (int)(off / c.cnt);
  c.t = (int)(off % c.cnt);
  c.ks = (int)(u % kUnitsPerTile);
  return c;
}

// The next unit; only called when there is one, so the row search ends.
__device__ __forceinline__ void advance(Cursor& c, const int* __restrict__ row_ptr, int nt) {
  if (++c.ks < kUnitsPerTile) return;
  c.ks = 0;
  if (++c.t < c.cnt) return;
  c.t = 0;
  if (++c.j < nt) return;
  c.j = 0;
  do {
    c.first += c.cnt;
    ++c.r;
    c.cnt = row_ptr[c.r + 1] - c.first;
  } while (c.cnt == 0);
}

__device__ __forceinline__ long long segment_start(const Cursor& c, int nt) {
  return ((long long)c.first * nt + (long long)c.j * c.cnt) * kUnitsPerTile;
}

// Stage a unit's A slab (128 rows x kBK) and x slab (kBK rows x BN) by
// cp.async; rows of x past n_rows and columns past ldx read as 0.
template <typename T, int BN>
__device__ __forceinline__ void issue(const Cursor& c, const T* __restrict__ blocks,
                                      const int* __restrict__ block_cols,
                                      const T* __restrict__ x, int n_rows, int ldx,
                                      unsigned char* stage) {
  using S = Cfg<T, BN>;
  constexpr int kAChunks = kBlock * kBK / S::kEl;
  constexpr int kXChunks = kBK * BN / S::kEl;
  const int g = c.first + c.t;
  const int k0 = c.ks * kBK;
  const T* a = blocks + (size_t)g * kBlock * kBlock + k0;
  T* as = reinterpret_cast<T*>(stage);
#pragma unroll
  for (int i = 0; i < (kAChunks + S::kThreads - 1) / S::kThreads; ++i) {
    const int q = i * S::kThreads + threadIdx.x;
    if (kAChunks % S::kThreads != 0 && q >= kAChunks) break;
    const int m = q / (kBK / S::kEl), k = (q % (kBK / S::kEl)) * S::kEl;
    cp_async16(as + m * S::kLda + k, a + (size_t)m * kBlock + k, 16);
  }
  const int row0 = block_cols[g] * kBlock + k0;
  const int col0 = c.j * BN;
  T* xs = reinterpret_cast<T*>(stage + S::kA);
#pragma unroll
  for (int i = 0; i < (kXChunks + S::kThreads - 1) / S::kThreads; ++i) {
    const int q = i * S::kThreads + threadIdx.x;
    if (kXChunks % S::kThreads != 0 && q >= kXChunks) break;
    const int k = q / (BN / S::kEl), n = (q % (BN / S::kEl)) * S::kEl;
    const int row = row0 + k, col = col0 + n;
    const bool ok = row < n_rows && col < ldx;
    cp_async16(xs + k * S::kLdx + n, ok ? x + (size_t)row * ldx + col : x, ok ? 16 : 0);
  }
}

// Stage the CTA's unit i (of n) at cursor c, and record in `end` what its
// products end (see the main kernel). The place of the unit in its segment
// gives the segment's start relative to the CTA's first unit, so whole and
// slot need no 64-bit unit numbers.
template <typename T, int BN>
__device__ __forceinline__ void stage_unit(const Cursor& c, int i, int n, int* end,
                                           const T* __restrict__ blocks,
                                           const int* __restrict__ block_cols,
                                           const T* __restrict__ x, int n_rows, int ldx,
                                           unsigned char* stage) {
  issue<T, BN>(c, blocks, block_cols, x, n_rows, ldx, stage);
  if (threadIdx.x == 0) {
    const int pos = c.t * kUnitsPerTile + c.ks;  // in the segment
    const int start = i - pos, len = c.cnt * kUnitsPerTile;
    int flags = 0;
    if (pos == len - 1 || i == n - 1)
      flags = 1 | (start >= 0 && start + len <= n ? 2 : 0) | (start <= 0 ? 0 : 4);
    end[0] = c.r;
    end[1] = c.j;
    end[2] = flags;
  }
}

// f32: the staged x slab [kBK][BN] split into TF32 hi/lo once for all warps,
// interleaved as uint2 {hi, lo} in rows of kLds
template <int BN>
__device__ __forceinline__ void split_x(const float* __restrict__ xs, uint2* __restrict__ xp) {
  using S = Cfg<float, BN>;
  constexpr int kQuads = kBK * BN / 4;
#pragma unroll
  for (int i = 0; i < (kQuads + S::kThreads - 1) / S::kThreads; ++i) {
    const int q = i * S::kThreads + threadIdx.x;
    if (kQuads % S::kThreads != 0 && q >= kQuads) break;
    const int k = q / (BN / 4), n = (q % (BN / 4)) * 4;
    const float4 v = *reinterpret_cast<const float4*>(xs + k * BN + n);
    uint32_t h[4], l[4];
    split(v.x, h[0], l[0]);
    split(v.y, h[1], l[1]);
    split(v.z, h[2], l[2]);
    split(v.w, h[3], l[3]);
    uint4* d = reinterpret_cast<uint4*>(xp + k * S::kLds + n);
    d[0] = make_uint4(h[0], l[0], h[1], l[1]);
    d[1] = make_uint4(h[2], l[2], h[3], l[3]);
  }
}

// f32: acc += A_slab @ x_slab for the warp's 32 x kWC tile, one k8 step's
// partial at a time, each formed from 0 by three TF32 mmas and added by FADD;
// the warp's A fragments are split in registers
template <int BN>
__device__ __forceinline__ void products_f32(const float* __restrict__ as,
                                             const uint2* __restrict__ xp,
                                             float (&acc)[2][Cfg<float, BN>::kNi][4]) {
  using S = Cfg<float, BN>;
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const int wm = (threadIdx.x >> 5) & 3, wn = threadIdx.x >> 7;  // warp row, column
#pragma unroll 1  // unrolled, ptxas spills the f32 kernels even at 255 registers
  for (int kk = 0; kk < kBK; kk += 8) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const float* a = as + (wm * 32 + mi * 16 + g) * S::kLda + kk + c;
      split(a[0], ah[mi][0], al[mi][0]);
      split(a[8 * S::kLda], ah[mi][1], al[mi][1]);
      split(a[4], ah[mi][2], al[mi][2]);
      split(a[8 * S::kLda + 4], ah[mi][3], al[mi][3]);
    }
#pragma unroll
    for (int ni = 0; ni < S::kNi; ++ni) {
      const uint2* b = xp + (kk + c) * S::kLds + wn * S::kWC + ni * 8 + g;
      const uint2 b0 = b[0], b1 = b[4 * S::kLds];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        float p[4] = {0.f, 0.f, 0.f, 0.f};
        mma3<false, false>(p, ah[mi], al[mi], b0.x, b1.x, b0.y, b1.y);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] += p[e];
      }
    }
  }
}

// bf16: acc += A_slab @ x_slab, one m16n8k16 partial from 0 per fragment and
// k16 step, added by FADD
template <int BN>
__device__ __forceinline__ void products_bf16(const __nv_bfloat16* __restrict__ as,
                                              const __nv_bfloat16* __restrict__ xs,
                                              float (&acc)[2][Cfg<__nv_bfloat16, BN>::kNi][4]) {
  using S = Cfg<__nv_bfloat16, BN>;
  const int lane = threadIdx.x & 31;
  const int wm = (threadIdx.x >> 5) & 3, wn = threadIdx.x >> 7;  // warp row, column
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    uint32_t a[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      ldmatrix_x4(a[mi], as + (wm * 32 + mi * 16 + (lane & 15)) * S::kLda + kk + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < S::kNi / 2; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, xs + (kk + (lane & 15)) * S::kLdx + wn * S::kWC + np * 16 +
                               (lane >> 4) * 8);
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

// The end of a segment (block row r, n tile j) in this CTA: its 128 x BN sum
// straight to out (masked to n_rows x f) when the CTA held the whole
// segment, else as f32 to the CTA's workspace slot; then acc = 0.
template <typename T, int BN>
__device__ __forceinline__ void flush(float (&acc)[2][Cfg<T, BN>::kNi][4], bool whole,
                                      T* __restrict__ out, float* __restrict__ part, int r,
                                      int j, int n_rows, int f) {
  using S = Cfg<T, BN>;
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const int wm = (threadIdx.x >> 5) & 3, wn = threadIdx.x >> 7;  // warp row, column
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < S::kNi; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm * 32 + mi * 16 + g + h * 8;
        const int col = wn * S::kWC + ni * 8 + 2 * c;
        const float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
        if (whole) {
          const int orow = r * kBlock + row, ocol = j * BN + col;
          if (orow < n_rows) {
            if (ocol < f) store_out(out + (size_t)orow * f + ocol, v0);
            if (ocol + 1 < f) store_out(out + (size_t)orow * f + ocol + 1, v1);
          }
        } else {
          *reinterpret_cast<float2*>(part + row * BN + col) = make_float2(v0, v1);
        }
        acc[mi][ni][2 * h] = acc[mi][ni][2 * h + 1] = 0.f;
      }
}

template <typename T, int BN>
__global__ void __launch_bounds__(Cfg<T, BN>::kThreads, Cfg<T, BN>::kMinBlocks)
bsr_spmm_kernel(const T* __restrict__ blocks, const int* __restrict__ block_cols,
                const int* __restrict__ row_ptr, const T* __restrict__ x,
                T* __restrict__ out, float* __restrict__ ws, int n_block_rows, int n_rows,
                int f, int ldx, long long units) {
  using S = Cfg<T, BN>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nt = (f + BN - 1) / BN;
  const long long u0 = units * blockIdx.x / gridDim.x;
  const long long u1 = units * (blockIdx.x + 1) / gridDim.x;
  const int n = (int)(u1 - u0);
  Cursor ld = locate(row_ptr, n_block_rows, nt, u0);
  // what the products of each staged unit end: the segment's (r, j) and
  // whether its sum is flushed there (bit 0), whole (bit 1), to slot 1
  // (bit 2); written with the unit's copies, so that no second cursor
  // holds registers through the products
  __shared__ int ends[S::kStages][3];

#pragma unroll
  for (int s = 0; s < S::kStages - 1; ++s) {
    if (s < n) {
      if (s > 0) advance(ld, row_ptr, nt);
      stage_unit<T, BN>(ld, s, n, ends[s], blocks, block_cols, x, n_rows, ldx,
                        smem + s * S::kStage);
    }
    cp_async_commit();
  }

  float acc[2][S::kNi][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < S::kNi; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  for (int i = 0; i < n; ++i) {
    cp_async_wait<S::kStages - 2>();  // unit i has landed
    __syncthreads();               // ... for every thread; unit i - 1 is done
    if (i + S::kStages - 1 < n) {
      advance(ld, row_ptr, nt);
      const int s = (i + S::kStages - 1) % S::kStages;
      stage_unit<T, BN>(ld, i + S::kStages - 1, n, ends[s], blocks, block_cols, x, n_rows, ldx,
                        smem + s * S::kStage);
    }
    cp_async_commit();
    const unsigned char* stage = smem + (i % S::kStages) * S::kStage;
    if constexpr (S::kBf) {
      products_bf16<BN>(reinterpret_cast<const __nv_bfloat16*>(stage),
                        reinterpret_cast<const __nv_bfloat16*>(stage + S::kA), acc);
    } else {
      uint2* xp = reinterpret_cast<uint2*>(smem + S::kStages * S::kStage);
      split_x<BN>(reinterpret_cast<const float*>(stage + S::kA), xp);
      __syncthreads();
      products_f32<BN>(reinterpret_cast<const float*>(stage), xp, acc);
    }
    const int* e = ends[i % S::kStages];
    if (e[2] & 1)
      flush<T, BN>(acc, e[2] & 2, out,
                   ws + ((size_t)blockIdx.x * 2 + (e[2] >> 2)) * kBlock * BN, e[0], e[1],
                   n_rows, f);
  }
}

// The second pass, a CTA for kJoinRows rows (blockIdx.y) of a segment. CTA
// b (1 <= b < n_ctas) joins the segment that the start of CTA b's range
// cuts, when b is the first boundary inside it: the parts of CTAs b - 1, b,
// ... summed in that order (slot 0 of a CTA whose range starts in the
// segment, else slot 1). CTA i < n_block_rows * nt also writes the zeros of
// (block row i / nt, n tile i % nt) when that row has no tiles. Four columns
// a thread, the parts' loads in flight together.
template <typename T, int BN>
__global__ void __launch_bounds__(kJoinThreads)
bsr_spmm_join(const int* __restrict__ row_ptr, T* __restrict__ out,
              const float* __restrict__ ws, int n_block_rows, int n_rows, int f,
              long long units, int n_ctas) {
  constexpr int kQuads = kJoinRows * BN / 4;
  const int nt = (f + BN - 1) / BN;
  const int b = blockIdx.x, r0 = blockIdx.y * kJoinRows;
  int seg_r = -1, seg_j = 0, c_lo = 0, c_end = 0;
  long long start = 0;
  if (b >= 1 && b < n_ctas) {
    const long long u = units * b / n_ctas;
    const Cursor s = locate(row_ptr, n_block_rows, nt, u);
    start = segment_start(s, nt);
    const long long end = start + (long long)s.cnt * kUnitsPerTile;
    if (start < u && start >= units * (b - 1) / n_ctas) {
      seg_r = s.r;
      seg_j = s.j;
      c_lo = b - 1;
      c_end = b + 1;
      while (c_end < n_ctas && units * c_end / n_ctas < end) ++c_end;
    }
  }
  const bool empty = b < n_block_rows * nt && row_ptr[b / nt + 1] == row_ptr[b / nt];
  for (int q = threadIdx.x; q < kQuads; q += kJoinThreads) {
    const int row = r0 + q / (BN / 4), col = (q % (BN / 4)) * 4;
    if (seg_r >= 0) {
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int c = c_lo; c < c_end; ++c) {
        const int slot = units * c / n_ctas >= start ? 0 : 1;
        const float4 v = *reinterpret_cast<const float4*>(
            ws + ((size_t)c * 2 + slot) * kBlock * BN + row * BN + col);
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
      const int orow = seg_r * kBlock + row, ocol = seg_j * BN + col;
      const float s4[4] = {sum.x, sum.y, sum.z, sum.w};
      if (orow < n_rows) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (ocol + e < f) store_out(out + (size_t)orow * f + ocol + e, s4[e]);
      }
    }
    if (empty) {
      const int orow = (b / nt) * kBlock + row, ocol = (b % nt) * BN + col;
      if (orow < n_rows) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (ocol + e < f) store_out(out + (size_t)orow * f + ocol + e, 0.f);
      }
    }
  }
}

// CTAs of the main kernel that fit on the card at once, cached per device
template <typename T, int BN>
int resident_ctas(int* ctas) {
  static int cache[kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < kMaxDevices && cache[dev] > 0) {
    *ctas = cache[dev];
    return 0;
  }
  const int err = allow_smem(bsr_spmm_kernel<T, BN>, Cfg<T, BN>::kBytes);
  if (err != 0) return err;
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bsr_spmm_kernel<T, BN>,
                                                Cfg<T, BN>::kThreads, Cfg<T, BN>::kBytes);
  *ctas = sms * per_sm;
  const int e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;
  if (*ctas <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (dev < kMaxDevices) cache[dev] = *ctas;
  return 0;
}

// The launch plan for nnzb tiles and F = f: the main kernel's grid, and the
// workspace it needs (two f32 128 x BN tiles a CTA).
template <typename T, int BN>
int plan(int nnzb, int f, long long* units, int* ctas, long long* ws_bytes) {
  *units = (long long)nnzb * ((f + BN - 1) / BN) * kUnitsPerTile;
  *ctas = 0;
  *ws_bytes = 0;
  if (*units == 0) return 0;
  int resident = 0;
  const int err = resident_ctas<T, BN>(&resident);
  if (err != 0) return err;
  *ctas = (int)(resident < *units ? resident : *units);
  *ws_bytes = (long long)*ctas * 2 * kBlock * BN * (long long)sizeof(float);
  return 0;
}

template <typename T, int BN>
int launch_bn(const void* blocks, const void* block_cols, const void* row_ptr,
              const void* x, void* out, void* ws, int nnzb, int n_block_rows, int n_rows,
              int f, int ldx, void* stream) {
  long long units = 0, ws_bytes = 0;
  int ctas = 0;
  int err = plan<T, BN>(nnzb, f, &units, &ctas, &ws_bytes);
  if (err != 0) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ctas > 0)
    bsr_spmm_kernel<T, BN><<<ctas, Cfg<T, BN>::kThreads, Cfg<T, BN>::kBytes, s>>>(
        static_cast<const T*>(blocks), static_cast<const int*>(block_cols),
        static_cast<const int*>(row_ptr), static_cast<const T*>(x), static_cast<T*>(out),
        static_cast<float*>(ws), n_block_rows, n_rows, f, ldx, units);
  const int nt = (f + BN - 1) / BN;
  const int join = ctas > n_block_rows * nt ? ctas : n_block_rows * nt;
  if (join > 0)
    bsr_spmm_join<T, BN><<<dim3(join, kBlock / kJoinRows), kJoinThreads, 0, s>>>(
        static_cast<const int*>(row_ptr), static_cast<T*>(out),
        static_cast<const float*>(ws), n_block_rows, n_rows, f, units, ctas);
  return static_cast<int>(cudaGetLastError());
}

// BN: the least of 32, 64, 128 that holds F; n tiles of 128 above
int tile_columns(int f) {
  return f <= 32 ? 32 : f <= 64 ? 64 : 128;
}

template <typename T>
long long workspace(int nnzb, int f) {
  long long units = 0, bytes = 0;
  int ctas = 0, err = 0;
  switch (tile_columns(f)) {
    case 32: err = plan<T, 32>(nnzb, f, &units, &ctas, &bytes); break;
    case 64: err = plan<T, 64>(nnzb, f, &units, &ctas, &bytes); break;
    default: err = plan<T, 128>(nnzb, f, &units, &ctas, &bytes);
  }
  return err != 0 ? -(long long)err : bytes;
}

template <typename T>
int launch(const void* blocks, const void* block_cols, const void* row_ptr, const void* x,
           void* out, void* ws, int nnzb, int n_block_rows, int n_rows, int f, int ldx,
           void* stream) {
  if (n_block_rows <= 0 || n_rows <= 0 || f <= 0) return static_cast<int>(cudaGetLastError());
  switch (tile_columns(f)) {
    case 32:
      return launch_bn<T, 32>(blocks, block_cols, row_ptr, x, out, ws, nnzb, n_block_rows,
                              n_rows, f, ldx, stream);
    case 64:
      return launch_bn<T, 64>(blocks, block_cols, row_ptr, x, out, ws, nnzb, n_block_rows,
                              n_rows, f, ldx, stream);
    default:
      return launch_bn<T, 128>(blocks, block_cols, row_ptr, x, out, ws, nnzb, n_block_rows,
                               n_rows, f, ldx, stream);
  }
}

}  // namespace

// Bytes of f32 workspace that a call with nnzb tiles and F = f needs (0 for
// none), or minus a CUDA error code; for the current device.
extern "C" long long sgp_bsr_spmm_workspace_f32(int nnzb, int f) {
  return workspace<float>(nnzb, f);
}

extern "C" long long sgp_bsr_spmm_workspace_bf16(int nnzb, int f) {
  return workspace<__nv_bfloat16>(nnzb, f);
}

// out[n_rows, f] = A @ x[n_rows, :f]; blocks [nnzb, 128, 128], block_cols
// [nnzb] and row_ptr [n_block_rows + 1] int32; x has row stride ldx (a
// multiple of 16 bytes, columns f..ldx zero, 16-byte aligned); ws holds the
// bytes that sgp_bsr_spmm_workspace_* gave. All pointers are device pointers;
// the two launches go on `stream`. Returns cudaGetLastError().
extern "C" int sgp_bsr_spmm_f32(const void* blocks, const void* block_cols,
                                const void* row_ptr, const void* x, void* out, void* ws,
                                int nnzb, int n_block_rows, int n_rows, int f, int ldx,
                                void* stream) {
  return launch<float>(blocks, block_cols, row_ptr, x, out, ws, nnzb, n_block_rows, n_rows,
                       f, ldx, stream);
}

extern "C" int sgp_bsr_spmm_bf16(const void* blocks, const void* block_cols,
                                 const void* row_ptr, const void* x, void* out, void* ws,
                                 int nnzb, int n_block_rows, int n_rows, int f, int ldx,
                                 void* stream) {
  return launch<__nv_bfloat16>(blocks, block_cols, row_ptr, x, out, ws, nnzb, n_block_rows,
                               n_rows, f, ldx, stream);
}
