// Fused GatedGN dense all-pairs message aggregation for Hopper (sm_90a),
// forward and backward.
//
// Replaces the TPU kernels sgp_tpu/ops/gn_allpairs.py::_fwd_kernel and
// ::_bwd_kernel (launched by _fwd_call and _bwd_call under the custom VJP of
// gn_allpairs_aggregate). Same result: for each batch row b, destination i
// and source j with mask[i, j] != 0, with p_i, p_j [B,N,h2]:
//
//   s  = p_i[i] + p_j[j]               t  = act(s)          (h2 wide)
//   mt = t @ w2 + b2                   mb = act(mt)         (h wide)
//   g  = sigmoid(mb . wg + bg)         out[i] = sum_j mask[i,j] * g * mb
//
// and the backward recomputes the chain per pair and emits d_pi (row sums),
// d_pj (column sums) and the weight gradients dw2, db2, dwg, dbg. An optional
// window table limits row i to the columns [row_lo[i], row_hi[i]); entries
// outside it are not edges, as in the blocked plain version.
//
// What differs from the TPU kernel. Pallas computes all N^2 pairs of each
// 128 x 128 tile on the MXU and multiplies by the mask, because the TPU has
// no cheap per-pair path. Here the chain is FFMA work (f32 without TF32) and
// only the set mask entries are computed: at 14.75% density that is 6.8x
// fewer pairs. Skipping a masked pair differs from multiplying it by 0 only
// where the pair's chain is not finite; the inputs are finite.
//
// Design. The per-pair chain is K4's (csrc/gn_ell.cu): lane k holds s[k] and
// t[k] (h2 <= 32), each lane owns the output channels lane and lane + 32
// (h <= 64) with its two columns of w2 in registers, t goes through 128 bytes
// of shared memory, and the gate is a butterfly warp sum. A block of four
// warps takes one work item at a time from a global counter (a persistent
// grid): a destination row in the forward. The four warps split the row's
// window into 32-column words (warp w takes words w, w + 4, ...), ballot each
// word's 32 mask bytes and run the chain only on the set bits; p_j[j] comes
// straight from global memory (642 KB at the slice, L2-resident) and is
// loaded one pair ahead. The four partial sums of a row are added in a fixed
// order through shared memory, so an empty row gives exactly 0 and the
// result does not depend on the schedule. The counter balances rows of very
// different degree (a threshold graph's boundary nodes have a quarter of an
// interior node's neighbours).
//
// Backward, two passes, deterministic, no atomics on data:
//  1. rows: chunks of kChunk destination rows. Per pair the chain, the
//     cotangents and K4's reduce-scatter for dt; d_pi is the row sum (fixed
//     order as above); each warp keeps its share of dw2 (its two columns, 64
//     registers), db2, dwg and dbg over the chunk and writes it to a scratch
//     row per (chunk, warp); a last kernel sums the rows in order.
//  2. columns: d_pj[j] = sum_i mask[i,j] * ds_ij is a sum across rows, so a
//     second pass walks the transposed mask per source column (within the
//     column's range of windows, each pair checked against its row's window)
//     and recomputes the chain. The mask need not be symmetric.
//
// Numerics. f32 inputs: full f32, FFMA only. bf16 inputs round where the
// Pallas kernel and its wrapper round: w2 and wg arrive rounded to bf16 (held
// in f32), ghat arrives rounded to bf16 (held in f32), t is rounded to bf16
// before the w2 product, dmt is rounded to bf16 for the dw2 product only (dt
// contracts the rounded w2 with the f32 dmt); every sum is f32.
//
// What bounds it on this card. Per pair the forward does 2*h2*h = 4,096 FLOP
// of FFMA plus the gate, and ~h2 + h + 1 transcendentals, on inputs that sit
// in L2: FFMA and MUFU issue bound it (bytes are the mask, N^2 bytes, read
// once). The backward does three times the FFMA plus 31 shuffles a pair in
// pass 1 and twice the FFMA in pass 2. The ways to a faster kernel: bf16 mma
// for the h2 x h products, and one recompute pass instead of two.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kH2 = 32;                       // max h2: one lane per channel
constexpr int kH = 64;                        // max h: two channels per lane
constexpr int kWarps = 4;                     // warps per block, one item
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 4;                     // rows per backward item
constexpr int kPart = kH2 * kH + 2 * kH + 1;  // dw2 [32][64], db2, dwg, dbg
constexpr unsigned kFull = 0xffffffffu;

enum Act { kSilu = 0, kTanh = 1, kRelu = 2, kElu = 3 };

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

template <int A>
__device__ __forceinline__ float act(float x) {
  if (A == kSilu) return x * sigmoid(x);
  if (A == kTanh) return tanhf(x);
  if (A == kRelu) return fmaxf(x, 0.f);
  return x > 0.f ? x : expm1f(x);  // elu
}

template <int A>
__device__ __forceinline__ float dact(float x) {
  if (A == kSilu) {
    const float s = sigmoid(x);
    return s * (1.f + x * (1.f - s));
  }
  if (A == kTanh) {
    const float t = tanhf(x);
    return 1.f - t * t;
  }
  if (A == kRelu) return x > 0.f ? 1.f : 0.f;
  return x > 0.f ? 1.f : expf(x);  // elu
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
// v rounded to T's precision, as the Pallas kernel's .astype(cdt)
__device__ __forceinline__ float round_as(float v, float) { return v; }
__device__ __forceinline__ float round_as(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The weights of one lane: its two columns of w2 (rows past h2 and columns
// past h are 0) and its entries of b2 and wg.
struct LaneWeights {
  float w2a[kH2], w2b[kH2];
  float b2a, b2b, wga, wgb, bg;

  __device__ __forceinline__ void load(const float* __restrict__ w2,
                                       const float* __restrict__ b2,
                                       const float* __restrict__ wg,
                                       const float* __restrict__ bgp, int h2, int h) {
    const int lane = threadIdx.x & 31;
    const bool ok0 = lane < h, ok1 = lane + 32 < h;
#pragma unroll
    for (int k = 0; k < kH2; ++k) {
      w2a[k] = (k < h2 && ok0) ? w2[k * h + lane] : 0.f;
      w2b[k] = (k < h2 && ok1) ? w2[k * h + lane + 32] : 0.f;
    }
    b2a = ok0 ? b2[lane] : 0.f;
    b2b = ok1 ? b2[lane + 32] : 0.f;
    wga = ok0 ? wg[lane] : 0.f;
    wgb = ok1 ? wg[lane + 32] : 0.f;
    bg = *bgp;
  }

  // mt for the lane's two channels from t in shared memory (32 floats).
  __device__ __forceinline__ void message(const float* ts, float& m0, float& m1) const {
    float a0 = b2a, a1 = b2b, c0 = 0.f, c1 = 0.f;  // two chains per channel
#pragma unroll
    for (int k = 0; k < kH2; k += 4) {
      const float4 t4 = *reinterpret_cast<const float4*>(ts + k);
      a0 = fmaf(t4.x, w2a[k], a0);
      a1 = fmaf(t4.x, w2b[k], a1);
      c0 = fmaf(t4.y, w2a[k + 1], c0);
      c1 = fmaf(t4.y, w2b[k + 1], c1);
      a0 = fmaf(t4.z, w2a[k + 2], a0);
      a1 = fmaf(t4.z, w2b[k + 2], a1);
      c0 = fmaf(t4.w, w2a[k + 3], c0);
      c1 = fmaf(t4.w, w2b[k + 3], c1);
    }
    m0 = a0 + c0;
    m1 = a1 + c1;
  }

  // dt[lane] = sum_c w2[lane, c] dmt[c], from each lane's dmt of its two
  // channels: each lane holds the products of its two columns for all 32 k;
  // a reduce-scatter over the warp (31 shuffles) leaves dt[lane] in lane.
  __device__ __forceinline__ float dt(float d0, float d1, int lane) const;
};

// One step of a warp reduce-scatter: r[i] and r[i + O] stand for two
// indices whose sums go to the lanes without and with bit O; each lane keeps
// its half, adds the partner's, and r[0 .. O) then stand for its half.
template <int O>
__device__ __forceinline__ void reduce_scatter_stage(float (&r)[16], int lane) {
  const bool hi = lane & O;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = hi ? r[i] : r[i + O];
    r[i] = (hi ? r[i + O] : r[i]) + __shfl_xor_sync(kFull, send, O);
  }
}

__device__ __forceinline__ float LaneWeights::dt(float d0, float d1, int lane) const {
  float r[16];
  const bool hi16 = lane & 16;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float lo = fmaf(w2a[i], d0, w2b[i] * d1);
    const float up = fmaf(w2a[i + 16], d0, w2b[i + 16] * d1);
    const float send = hi16 ? lo : up;
    r[i] = (hi16 ? up : lo) + __shfl_xor_sync(kFull, send, 16);
  }
  reduce_scatter_stage<8>(r, lane);
  reduce_scatter_stage<4>(r, lane);
  reduce_scatter_stage<2>(r, lane);
  reduce_scatter_stage<1>(r, lane);
  return r[0];
}

// The set entries of one mask row within [lo, hi), this warp's share: the
// 32-column words w, w + kWarps, ... counted from lo. next() is warp-uniform.
struct PairWalk {
  const uint8_t* row;
  int hi, j0;
  unsigned bits;

  __device__ __forceinline__ PairWalk(const uint8_t* r, int lo, int hi_, int warp)
      : row(r), hi(hi_), j0(lo + 32 * (warp - kWarps)), bits(0u) {}

  // the next set column, or -1 when the warp's share is done
  __device__ __forceinline__ int next() {
    while (bits == 0u) {
      j0 += 32 * kWarps;
      if (j0 >= hi) return -1;
      const int j = j0 + (threadIdx.x & 31);
      bits = __ballot_sync(kFull, j < hi && row[j] != 0);
    }
    const int k = __ffs(bits) - 1;
    bits &= bits - 1u;
    return j0 + k;
  }
};

// Thread 0 takes the next item from the counter; every thread returns it.
__device__ __forceinline__ int next_item(int* counter, int* item_s) {
  if (threadIdx.x == 0) *item_s = atomicAdd(counter, 1);
  __syncthreads();
  return *item_s;
}

template <int A, typename T>
__global__ void __launch_bounds__(kThreads)
gn_allpairs_fwd_kernel(const T* __restrict__ p_i, const T* __restrict__ p_j,
                       const uint8_t* __restrict__ mask, const int* __restrict__ row_lo,
                       const int* __restrict__ row_hi, const float* __restrict__ w2,
                       const float* __restrict__ b2, const float* __restrict__ wg,
                       const float* __restrict__ bgp, float* __restrict__ out,
                       int* __restrict__ counter, int rows, int n, int h2, int h) {
  __shared__ __align__(16) float t_s[kWarps][kH2];
  __shared__ float acc_s[kWarps][kH];
  __shared__ int item_s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* ts = t_s[warp];
  LaneWeights w;
  w.load(w2, b2, wg, bgp, h2, h);
  const bool in_h2 = lane < h2;

  for (int row = next_item(counter, &item_s); row < rows;
       row = next_item(counter, &item_s)) {
    const int i = row % n;
    const T* pj = p_j + (size_t)(row - i) * h2 + lane;  // batch row's p_j
    const float pi = in_h2 ? to_f32(p_i[(size_t)row * h2 + lane]) : 0.f;
    PairWalk walk(mask + (size_t)i * n, row_lo[i], row_hi[i], warp);
    float acc0 = 0.f, acc1 = 0.f;
    int j = walk.next();
    float next = (j >= 0 && in_h2) ? to_f32(pj[(size_t)j * h2]) : 0.f;
    while (j >= 0) {
      const float cur = next;
      j = walk.next();
      if (j >= 0 && in_h2) next = to_f32(pj[(size_t)j * h2]);
      ts[lane] = round_as(act<A>(pi + cur), T());
      __syncwarp();
      float m0, m1;
      w.message(ts, m0, m1);
      __syncwarp();  // ts is rewritten by the next pair
      const float mb0 = act<A>(m0), mb1 = act<A>(m1);
      const float g = sigmoid(warp_sum(fmaf(w.wga, mb0, w.wgb * mb1)) + w.bg);
      acc0 = fmaf(g, mb0, acc0);
      acc1 = fmaf(g, mb1, acc1);
    }
    acc_s[warp][lane] = acc0;
    acc_s[warp][lane + 32] = acc1;
    __syncthreads();
    if (threadIdx.x < h) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < kWarps; ++q) s += acc_s[q][threadIdx.x];
      out[(size_t)row * h + threadIdx.x] = s;
    }
  }
}

// Backward pass 1: d_pi and the weight-gradient partials, kChunk rows an item.
template <int A, typename T>
__global__ void __launch_bounds__(kThreads)
gn_allpairs_bwd_rows_kernel(const T* __restrict__ p_i, const T* __restrict__ p_j,
                            const uint8_t* __restrict__ mask, const int* __restrict__ row_lo,
                            const int* __restrict__ row_hi, const float* __restrict__ w2,
                            const float* __restrict__ b2, const float* __restrict__ wg,
                            const float* __restrict__ bgp, const float* __restrict__ ghat,
                            float* __restrict__ dpi, float* __restrict__ part,
                            int* __restrict__ counter, int rows, int n, int h2, int h) {
  __shared__ __align__(16) float t_s[kWarps][kH2];
  __shared__ float d_s[kWarps][kH2];
  __shared__ int item_s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* ts = t_s[warp];
  LaneWeights w;
  w.load(w2, b2, wg, bgp, h2, h);
  const bool in_h2 = lane < h2;
  const int chunks = (rows + kChunk - 1) / kChunk;

  for (int chunk = next_item(counter, &item_s); chunk < chunks;
       chunk = next_item(counter, &item_s)) {
    float dwa[kH2], dwb[kH2];  // this lane's columns c0, c1 of dw2
#pragma unroll
    for (int k = 0; k < kH2; ++k) dwa[k] = dwb[k] = 0.f;
    float db2a = 0.f, db2b = 0.f, dwga = 0.f, dwgb = 0.f, dbg = 0.f;

    for (int row = chunk * kChunk; row < min(rows, (chunk + 1) * kChunk); ++row) {
      const int i = row % n;
      const T* pj = p_j + (size_t)(row - i) * h2 + lane;
      const float pi = in_h2 ? to_f32(p_i[(size_t)row * h2 + lane]) : 0.f;
      const float e0 = lane < h ? ghat[(size_t)row * h + lane] : 0.f;
      const float e1 = lane + 32 < h ? ghat[(size_t)row * h + lane + 32] : 0.f;
      PairWalk walk(mask + (size_t)i * n, row_lo[i], row_hi[i], warp);
      float dpi_acc = 0.f;
      int j = walk.next();
      float next = (j >= 0 && in_h2) ? to_f32(pj[(size_t)j * h2]) : 0.f;
      while (j >= 0) {
        const float cur = next;
        j = walk.next();
        if (j >= 0 && in_h2) next = to_f32(pj[(size_t)j * h2]);
        // recompute the forward chain of this pair
        const float s = pi + cur;
        ts[lane] = round_as(act<A>(s), T());
        __syncwarp();
        float m0, m1;
        w.message(ts, m0, m1);
        const float mb0 = act<A>(m0), mb1 = act<A>(m1);
        const float g = sigmoid(warp_sum(fmaf(w.wga, mb0, w.wgb * mb1)) + w.bg);
        // cotangents: e = ghat * mask (mask is 1 here)
        const float dgz = warp_sum(fmaf(e0, mb0, e1 * mb1)) * g * (1.f - g);
        const float dmt0 = fmaf(e0, g, w.wga * dgz) * dact<A>(m0);
        const float dmt1 = fmaf(e1, g, w.wgb * dgz) * dact<A>(m1);
        db2a += dmt0;
        db2b += dmt1;
        dwga = fmaf(mb0, dgz, dwga);
        dwgb = fmaf(mb1, dgz, dwgb);
        dbg += dgz;
        const float q0 = round_as(dmt0, T()), q1 = round_as(dmt1, T());
        // dw2[k, c] += t[k] * dmt[c] for the lane's two columns
#pragma unroll
        for (int k = 0; k < kH2; k += 4) {
          const float4 t4 = *reinterpret_cast<const float4*>(ts + k);
          dwa[k] = fmaf(t4.x, q0, dwa[k]);
          dwb[k] = fmaf(t4.x, q1, dwb[k]);
          dwa[k + 1] = fmaf(t4.y, q0, dwa[k + 1]);
          dwb[k + 1] = fmaf(t4.y, q1, dwb[k + 1]);
          dwa[k + 2] = fmaf(t4.z, q0, dwa[k + 2]);
          dwb[k + 2] = fmaf(t4.z, q1, dwb[k + 2]);
          dwa[k + 3] = fmaf(t4.w, q0, dwa[k + 3]);
          dwb[k + 3] = fmaf(t4.w, q1, dwb[k + 3]);
        }
        __syncwarp();  // ts is rewritten by the next pair
        dpi_acc += w.dt(dmt0, dmt1, lane) * dact<A>(s);
      }
      d_s[warp][lane] = dpi_acc;
      __syncthreads();
      if (threadIdx.x < h2) {
        float sum = 0.f;
#pragma unroll
        for (int q = 0; q < kWarps; ++q) sum += d_s[q][threadIdx.x];
        dpi[(size_t)row * h2 + threadIdx.x] = sum;
      }
      __syncthreads();  // d_s is rewritten by the next row
    }

    float* p = part + ((size_t)chunk * kWarps + warp) * kPart;
#pragma unroll
    for (int k = 0; k < kH2; ++k) {
      p[k * kH + lane] = dwa[k];
      p[k * kH + lane + 32] = dwb[k];
    }
    p[kH2 * kH + lane] = db2a;
    p[kH2 * kH + lane + 32] = db2b;
    p[kH2 * kH + kH + lane] = dwga;
    p[kH2 * kH + kH + lane + 32] = dwgb;
    if (lane == 0) p[kH2 * kH + 2 * kH] = dbg;
  }
}

// Backward pass 2: d_pj, one source column an item, over the transposed mask.
template <int A, typename T>
__global__ void __launch_bounds__(kThreads)
gn_allpairs_bwd_cols_kernel(const T* __restrict__ p_i, const T* __restrict__ p_j,
                            const uint8_t* __restrict__ mask_t,
                            const int* __restrict__ row_lo, const int* __restrict__ row_hi,
                            const int* __restrict__ col_lo, const int* __restrict__ col_hi,
                            const float* __restrict__ w2, const float* __restrict__ b2,
                            const float* __restrict__ wg, const float* __restrict__ bgp,
                            const float* __restrict__ ghat, float* __restrict__ dpj,
                            int* __restrict__ counter, int cols, int n, int h2, int h) {
  __shared__ __align__(16) float t_s[kWarps][kH2];
  __shared__ float d_s[kWarps][kH2];
  __shared__ int item_s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* ts = t_s[warp];
  LaneWeights w;
  w.load(w2, b2, wg, bgp, h2, h);
  const bool in_h2 = lane < h2;

  for (int col = next_item(counter, &item_s); col < cols;
       col = next_item(counter, &item_s)) {
    const int j = col % n;
    const size_t base = (size_t)(col - j);  // this batch row's first node
    const float pj = in_h2 ? to_f32(p_j[(size_t)col * h2 + lane]) : 0.f;
    PairWalk walk(mask_t + (size_t)j * n, col_lo[j], col_hi[j], warp);
    // the next destination i whose window holds column j
    auto next_i = [&]() {
      int i;
      do {
        i = walk.next();
      } while (i >= 0 && !(row_lo[i] <= j && j < row_hi[i]));
      return i;
    };
    float dpj_acc = 0.f;
    int i = next_i();
    float pi_n = 0.f, e0_n = 0.f, e1_n = 0.f;
    if (i >= 0) {
      pi_n = in_h2 ? to_f32(p_i[(base + i) * h2 + lane]) : 0.f;
      e0_n = lane < h ? ghat[(base + i) * h + lane] : 0.f;
      e1_n = lane + 32 < h ? ghat[(base + i) * h + lane + 32] : 0.f;
    }
    while (i >= 0) {
      const float pi = pi_n, e0 = e0_n, e1 = e1_n;
      i = next_i();
      if (i >= 0) {
        pi_n = in_h2 ? to_f32(p_i[(base + i) * h2 + lane]) : 0.f;
        e0_n = lane < h ? ghat[(base + i) * h + lane] : 0.f;
        e1_n = lane + 32 < h ? ghat[(base + i) * h + lane + 32] : 0.f;
      }
      const float s = pi + pj;
      ts[lane] = round_as(act<A>(s), T());
      __syncwarp();
      float m0, m1;
      w.message(ts, m0, m1);
      __syncwarp();  // ts is rewritten by the next pair
      const float mb0 = act<A>(m0), mb1 = act<A>(m1);
      const float g = sigmoid(warp_sum(fmaf(w.wga, mb0, w.wgb * mb1)) + w.bg);
      const float dgz = warp_sum(fmaf(e0, mb0, e1 * mb1)) * g * (1.f - g);
      const float dmt0 = fmaf(e0, g, w.wga * dgz) * dact<A>(m0);
      const float dmt1 = fmaf(e1, g, w.wgb * dgz) * dact<A>(m1);
      dpj_acc += w.dt(dmt0, dmt1, lane) * dact<A>(s);
    }
    d_s[warp][lane] = dpj_acc;
    __syncthreads();
    if (threadIdx.x < h2) {
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < kWarps; ++q) sum += d_s[q][threadIdx.x];
      dpj[(size_t)col * h2 + threadIdx.x] = sum;
    }
  }
}

// grads = [dw2 (h2*h), db2 (h), dwg (h), dbg (1)]: each entry the sum of its
// column of the per-(chunk, warp) partials, in order.
__global__ void gn_allpairs_wgrad_reduce(const float* __restrict__ part, int n_parts, int h2,
                                         int h, float* __restrict__ grads) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int n_out = h2 * h + 2 * h + 1;
  if (j >= n_out) return;
  int col;
  if (j < h2 * h) col = (j / h) * kH + j % h;
  else if (j < h2 * h + h) col = kH2 * kH + (j - h2 * h);
  else if (j < h2 * h + 2 * h) col = kH2 * kH + kH + (j - h2 * h - h);
  else col = kH2 * kH + 2 * kH;
  float acc = 0.f;
  for (int w = 0; w < n_parts; ++w) acc += part[(size_t)w * kPart + col];
  grads[j] = acc;
}

template <typename K>
int occupancy(K kernel, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  *blocks = sms * per_sm;
  return static_cast<int>(cudaGetLastError());
}

template <int A, typename T>
int blocks_for(int pass, int* blocks) {
  if (pass == 0) return occupancy(gn_allpairs_fwd_kernel<A, T>, blocks);
  if (pass == 1) return occupancy(gn_allpairs_bwd_rows_kernel<A, T>, blocks);
  return occupancy(gn_allpairs_bwd_cols_kernel<A, T>, blocks);
}

template <int A, typename T>
int fwd(const void* p_i, const void* p_j, const void* mask, const void* row_lo,
        const void* row_hi, const void* w2, const void* b2, const void* wg, const void* bg,
        void* out, void* counter, int rows, int n, int h2, int h, int blocks,
        cudaStream_t stream) {
  gn_allpairs_fwd_kernel<A, T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(p_i), static_cast<const T*>(p_j),
      static_cast<const uint8_t*>(mask), static_cast<const int*>(row_lo),
      static_cast<const int*>(row_hi), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(wg),
      static_cast<const float*>(bg), static_cast<float*>(out), static_cast<int*>(counter),
      rows, n, h2, h);
  return static_cast<int>(cudaGetLastError());
}

template <int A, typename T>
int bwd(const void* p_i, const void* p_j, const void* mask, const void* mask_t,
        const void* row_lo, const void* row_hi, const void* col_lo, const void* col_hi,
        const void* w2, const void* b2, const void* wg, const void* bg, const void* ghat,
        void* dpi, void* dpj, void* part, void* grads, void* counters, int rows, int n,
        int h2, int h, int blocks_rows, int blocks_cols, cudaStream_t stream) {
  int* cnt = static_cast<int*>(counters);
  gn_allpairs_bwd_rows_kernel<A, T><<<blocks_rows, kThreads, 0, stream>>>(
      static_cast<const T*>(p_i), static_cast<const T*>(p_j),
      static_cast<const uint8_t*>(mask), static_cast<const int*>(row_lo),
      static_cast<const int*>(row_hi), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(wg),
      static_cast<const float*>(bg), static_cast<const float*>(ghat),
      static_cast<float*>(dpi), static_cast<float*>(part), cnt, rows, n, h2, h);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  gn_allpairs_bwd_cols_kernel<A, T><<<blocks_cols, kThreads, 0, stream>>>(
      static_cast<const T*>(p_i), static_cast<const T*>(p_j),
      static_cast<const uint8_t*>(mask_t), static_cast<const int*>(row_lo),
      static_cast<const int*>(row_hi), static_cast<const int*>(col_lo),
      static_cast<const int*>(col_hi), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(wg),
      static_cast<const float*>(bg), static_cast<const float*>(ghat),
      static_cast<float*>(dpj), cnt + 1, rows, n, h2, h);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int n_out = h2 * h + 2 * h + 1;
  const int n_parts = (rows + kChunk - 1) / kChunk * kWarps;
  gn_allpairs_wgrad_reduce<<<(n_out + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(part), n_parts, h2, h, static_cast<float*>(grads));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dispatch on (activation, input dtype): act is 0 silu/swish, 1 tanh,
// 2 relu, 3 elu; bf16 is 0 for f32 inputs, 1 for bf16 ones.
#define GN_ALLPAIRS_DISPATCH(CALL)                              \
  switch (act * 2 + (bf16 ? 1 : 0)) {                           \
    case 0: return CALL(kSilu, float);                          \
    case 1: return CALL(kSilu, __nv_bfloat16);                  \
    case 2: return CALL(kTanh, float);                          \
    case 3: return CALL(kTanh, __nv_bfloat16);                  \
    case 4: return CALL(kRelu, float);                          \
    case 5: return CALL(kRelu, __nv_bfloat16);                  \
    case 6: return CALL(kElu, float);                           \
    case 7: return CALL(kElu, __nv_bfloat16);                   \
    default: return static_cast<int>(cudaErrorInvalidValue);    \
  }

// The persistent grid of a kernel: pass 0 the forward, 1 the backward's row
// pass, 2 its column pass; blocks per SM at full occupancy times the SMs of
// the current device.
extern "C" int sgp_gn_allpairs_blocks(int act, int bf16, int pass, int* blocks) {
#define CALL(A, T) blocks_for<A, T>(pass, blocks)
  GN_ALLPAIRS_DISPATCH(CALL)
#undef CALL
}

// The rows of scratch the backward needs: one per (chunk of 4 rows, warp),
// each of 2,177 floats.
extern "C" int sgp_gn_allpairs_parts(int rows) {
  return (rows + kChunk - 1) / kChunk * kWarps;
}

// out [rows, h] f32 from p_i, p_j [rows, h2] (f32 or bf16; rows = B * N,
// batch row b at rows b*N ..), mask [n, n] uint8 (nonzero = edge, dst-major),
// row_lo, row_hi [n] int32 (row i sweeps columns [row_lo[i], row_hi[i])),
// w2 [h2, h], b2 [h], wg [h], bg [1] f32 (w2 and wg already rounded to the
// input dtype), counter [1] int32 zeroed. h2 <= 32, h <= 64. Device
// pointers; launched on `stream`. Returns cudaGetLastError().
extern "C" int sgp_gn_allpairs_fwd(int act, int bf16, const void* p_i, const void* p_j,
                                   const void* mask, const void* row_lo, const void* row_hi,
                                   const void* w2, const void* b2, const void* wg,
                                   const void* bg, void* out, void* counter, int rows, int n,
                                   int h2, int h, int blocks, void* stream) {
  if (h2 > kH2 || h > kH) return static_cast<int>(cudaErrorInvalidValue);
#define CALL(A, T)                                                                     \
  fwd<A, T>(p_i, p_j, mask, row_lo, row_hi, w2, b2, wg, bg, out, counter, rows, n, h2, h, \
            blocks, static_cast<cudaStream_t>(stream))
  GN_ALLPAIRS_DISPATCH(CALL)
#undef CALL
}

// The backward for the forward's inputs, the transposed mask mask_t [n, n]
// uint8, the column ranges col_lo, col_hi [n] int32 (column j is held by
// rows within [col_lo[j], col_hi[j]) only) and ghat [rows, h] f32 (rounded
// to the input dtype): dpi, dpj [rows, h2] f32 and grads = [dw2 (h2*h),
// db2 (h), dwg (h), dbg (1)] f32 through the scratch `part`
// [sgp_gn_allpairs_parts(rows), 2177] f32; counters [2] int32 zeroed. Three
// launches on `stream`.
extern "C" int sgp_gn_allpairs_bwd(int act, int bf16, const void* p_i, const void* p_j,
                                   const void* mask, const void* mask_t, const void* row_lo,
                                   const void* row_hi, const void* col_lo,
                                   const void* col_hi, const void* w2, const void* b2,
                                   const void* wg, const void* bg, const void* ghat,
                                   void* dpi, void* dpj, void* part, void* grads,
                                   void* counters, int rows, int n, int h2, int h,
                                   int blocks_rows, int blocks_cols, void* stream) {
  if (h2 > kH2 || h > kH) return static_cast<int>(cudaErrorInvalidValue);
#define CALL(A, T)                                                                      \
  bwd<A, T>(p_i, p_j, mask, mask_t, row_lo, row_hi, col_lo, col_hi, w2, b2, wg, bg, ghat, \
            dpi, dpj, part, grads, counters, rows, n, h2, h, blocks_rows, blocks_cols,   \
            static_cast<cudaStream_t>(stream))
  GN_ALLPAIRS_DISPATCH(CALL)
#undef CALL
}
