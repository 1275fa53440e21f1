// Fused GatedGN ELL message aggregation for Hopper (sm_90a), forward and
// backward.
//
// Replaces the TPU kernels sgp_tpu/ops/gn_ell.py::_fwd_kernel and
// ::_bwd_kernel (launched by _fwd_call and _bwd_call under the custom VJP of
// gn_ell_aggregate). Same result: for each destination node n of each batch
// row b and each of its D padded neighbour slots d, with p_i [B,N,h2], the
// gathered p_j[src] as pjn [B,N,D,h2] and the slot mask [N,D]:
//
//   s  = p_i[n] + pjn[n,d]             t  = act(s)          (h2 wide)
//   mt = t @ w2 + b2                   mb = act(mt)         (h wide)
//   g  = sigmoid(mb . wg + bg)         out[n] = sum_d mask[n,d] * g * mb
//
// and the backward recomputes the chain per pair and emits d_pi (summed over
// d), d_pjn (the gather's cotangent, which the caller's autograd scatter-adds
// into d_p_j) and the weight gradients dw2, db2, dwg, dbg. The TPU kernel's
// padding of D to 128 and N to 32 and its channels-on-sublanes transposes are
// TPU matters: here N and D are read unpadded and masked slots are skipped.
//
// Design. One warp owns one (b, n) row and walks its D slots; a persistent
// grid, sized by the occupancy calculator, strides over the B*N rows. Lane k
// holds s[k] and t[k] (h2 <= 32); each lane owns the two output channels
// c0 = lane and c1 = lane + 32 (h <= 64), with its two columns of w2 in
// registers. t goes through a 128-byte slot of shared memory, so each lane
// reads all of t as 8 broadcast float4 loads and forms mt[c0], mt[c1] with
// 64 FFMA. The gate is a butterfly warp sum; the sum over d stays in
// registers. Channels past h2 and h are zero-padded (every activation in the
// table maps 0 to 0). No atomics anywhere.
// Backward: lane k forms dt[k] = sum_c w2[k,c] dmt[c] by a reduce-scatter
// over the warp (31 shuffles; each lane starts from its own two columns of
// w2, so w2 stays in registers once), its d_pjn and d_pi entries, and the
// lane's two columns of dw2 (64 register accumulators, t broadcast again from
// shared memory). Each warp writes its weight-gradient partial sums to a
// scratch row; a second kernel sums the rows in a fixed order, so the result
// is deterministic.
//
// Numerics. f32 inputs: full f32, FFMA only, no TF32. bf16 inputs round where
// the Pallas kernel rounds: t is rounded to bf16 before the w2 product, dmt
// before the w2^T and dw2 products (w2 and wg arrive already rounded to bf16,
// held in f32), d_pjn is stored as bf16; every sum is f32.
//
// What bounds it on this card. Per pair the forward does 2*h2*h = 4,096 FLOP
// of FFMA and ~2*(h2+h) transcendental operations on 128 bytes of pjn (f32):
// 32 FLOP per byte against an FFMA ridge of ~20, so FFMA and MUFU issue bound
// it, not HBM; the backward does three times the FFMA plus 31 shuffles a pair.
// The ways to a faster kernel: bf16 mma for the three h2 x h products, and
// gathering p_j[src] in the kernel instead of reading the gathered pjn.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kH2 = 32;                       // max h2: one lane per channel
constexpr int kH = 64;                        // max h: two channels per lane
constexpr int kWarps = 4;                     // warps per block
constexpr int kThreads = kWarps * 32;
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
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
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

// Bit j of the result: slot j0 + j of the row is valid.
__device__ __forceinline__ unsigned slot_bits(const uint8_t* __restrict__ mrow, int j0, int d) {
  const int j = j0 + (threadIdx.x & 31);
  return __ballot_sync(kFull, j < d && mrow[j] != 0);
}

template <int A, typename T>
__global__ void __launch_bounds__(kThreads)
gn_ell_fwd_kernel(const T* __restrict__ p_i, const T* __restrict__ pjn,
                  const uint8_t* __restrict__ mask, const float* __restrict__ w2,
                  const float* __restrict__ b2, const float* __restrict__ wg,
                  const float* __restrict__ bgp, float* __restrict__ out, int rows,
                  int n, int d, int h2, int h) {
  __shared__ __align__(16) float t_s[kWarps][kH2];
  const int lane = threadIdx.x & 31;
  float* ts = t_s[threadIdx.x >> 5];
  LaneWeights w;
  w.load(w2, b2, wg, bgp, h2, h);
  const bool in_h2 = lane < h2;

  for (int row = blockIdx.x * kWarps + (threadIdx.x >> 5); row < rows;
       row += gridDim.x * kWarps) {
    const float pi = in_h2 ? to_f32(p_i[(size_t)row * h2 + lane]) : 0.f;
    const T* pj = pjn + (size_t)row * d * h2 + lane;
    const uint8_t* mrow = mask + (size_t)(row % n) * d;
    float acc0 = 0.f, acc1 = 0.f;
    float next = (in_h2 && d > 0) ? to_f32(pj[0]) : 0.f;
    unsigned bits = 0;
    for (int j = 0; j < d; ++j) {
      const float cur = next;
      if (in_h2 && j + 1 < d) next = to_f32(pj[(size_t)(j + 1) * h2]);
      if ((j & 31) == 0) bits = slot_bits(mrow, j, d);
      if (!((bits >> (j & 31)) & 1u)) continue;  // padding: adds exactly 0
      ts[lane] = round_as(act<A>(pi + cur), T());
      __syncwarp();
      float m0, m1;
      w.message(ts, m0, m1);
      __syncwarp();  // ts is rewritten by the next slot
      const float mb0 = act<A>(m0), mb1 = act<A>(m1);
      const float g = sigmoid(warp_sum(fmaf(w.wga, mb0, w.wgb * mb1)) + w.bg);
      acc0 = fmaf(g, mb0, acc0);
      acc1 = fmaf(g, mb1, acc1);
    }
    if (lane < h) out[(size_t)row * h + lane] = acc0;
    if (lane + 32 < h) out[(size_t)row * h + lane + 32] = acc1;
  }
}

template <int A, typename T>
__global__ void __launch_bounds__(kThreads)
gn_ell_bwd_kernel(const T* __restrict__ p_i, const T* __restrict__ pjn,
                  const uint8_t* __restrict__ mask, const float* __restrict__ w2,
                  const float* __restrict__ b2, const float* __restrict__ wg,
                  const float* __restrict__ bgp, const float* __restrict__ ghat,
                  float* __restrict__ dpi, T* __restrict__ dpjn, float* __restrict__ part,
                  int rows, int n, int d, int h2, int h) {
  __shared__ __align__(16) float t_s[kWarps][kH2];
  const int lane = threadIdx.x & 31;
  float* ts = t_s[threadIdx.x >> 5];
  LaneWeights w;
  w.load(w2, b2, wg, bgp, h2, h);
  const bool in_h2 = lane < h2;

  float dwa[kH2], dwb[kH2];  // this lane's columns c0, c1 of dw2
#pragma unroll
  for (int k = 0; k < kH2; ++k) dwa[k] = dwb[k] = 0.f;
  float db2a = 0.f, db2b = 0.f, dwga = 0.f, dwgb = 0.f, dbg = 0.f;

  for (int row = blockIdx.x * kWarps + (threadIdx.x >> 5); row < rows;
       row += gridDim.x * kWarps) {
    const float pi = in_h2 ? to_f32(p_i[(size_t)row * h2 + lane]) : 0.f;
    const T* pj = pjn + (size_t)row * d * h2 + lane;
    T* dpj = dpjn + (size_t)row * d * h2 + lane;
    const uint8_t* mrow = mask + (size_t)(row % n) * d;
    const float e0 = lane < h ? ghat[(size_t)row * h + lane] : 0.f;
    const float e1 = lane + 32 < h ? ghat[(size_t)row * h + lane + 32] : 0.f;
    float dpi_acc = 0.f;
    float next = (in_h2 && d > 0) ? to_f32(pj[0]) : 0.f;
    unsigned bits = 0;
    for (int j = 0; j < d; ++j) {
      const float cur = next;
      if (in_h2 && j + 1 < d) next = to_f32(pj[(size_t)(j + 1) * h2]);
      if ((j & 31) == 0) bits = slot_bits(mrow, j, d);
      if (!((bits >> (j & 31)) & 1u)) {  // padding: zero cotangent
        if (in_h2) store(dpj + (size_t)j * h2, 0.f);
        continue;
      }
      // recompute the forward chain of this pair
      const float s = pi + cur;
      const float tk = round_as(act<A>(s), T());
      ts[lane] = tk;
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
      __syncwarp();  // ts is rewritten by the next slot
      // dt[k] = sum_c w2[k, c] dmt[c]: each lane holds the products of its
      // two columns for all 32 k; a reduce-scatter leaves dt[lane] in lane.
      float r[16];
      const bool hi16 = lane & 16;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float lo = fmaf(w.w2a[i], q0, w.w2b[i] * q1);
        const float up = fmaf(w.w2a[i + 16], q0, w.w2b[i + 16] * q1);
        const float send = hi16 ? lo : up;
        r[i] = (hi16 ? up : lo) + __shfl_xor_sync(kFull, send, 16);
      }
      reduce_scatter_stage<8>(r, lane);
      reduce_scatter_stage<4>(r, lane);
      reduce_scatter_stage<2>(r, lane);
      reduce_scatter_stage<1>(r, lane);
      const float ds = r[0] * dact<A>(s);
      dpi_acc += ds;
      if (in_h2) store(dpj + (size_t)j * h2, ds);
    }
    if (in_h2) dpi[(size_t)row * h2 + lane] = dpi_acc;
  }

  float* p = part + (size_t)(blockIdx.x * kWarps + (threadIdx.x >> 5)) * kPart;
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

// grads = [dw2 (h2*h), db2 (h), dwg (h), dbg (1)]: each entry the sum of its
// column of the per-warp partials, in warp order.
__global__ void gn_ell_wgrad_reduce(const float* __restrict__ part, int n_parts, int h2,
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

template <int A, typename T>
int blocks_for(int backward, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (backward)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gn_ell_bwd_kernel<A, T>, kThreads, 0);
  else
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gn_ell_fwd_kernel<A, T>, kThreads, 0);
  *blocks = sms * per_sm;
  return static_cast<int>(cudaGetLastError());
}

template <int A, typename T>
int fwd(const void* p_i, const void* pjn, const void* mask, const void* w2, const void* b2,
        const void* wg, const void* bg, void* out, int rows, int n, int d, int h2, int h,
        int blocks, cudaStream_t stream) {
  gn_ell_fwd_kernel<A, T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(p_i), static_cast<const T*>(pjn),
      static_cast<const uint8_t*>(mask), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(wg),
      static_cast<const float*>(bg), static_cast<float*>(out), rows, n, d, h2, h);
  return static_cast<int>(cudaGetLastError());
}

template <int A, typename T>
int bwd(const void* p_i, const void* pjn, const void* mask, const void* w2, const void* b2,
        const void* wg, const void* bg, const void* ghat, void* dpi, void* dpjn, void* part,
        void* grads, int rows, int n, int d, int h2, int h, int blocks, cudaStream_t stream) {
  gn_ell_bwd_kernel<A, T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(p_i), static_cast<const T*>(pjn),
      static_cast<const uint8_t*>(mask), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(wg),
      static_cast<const float*>(bg), static_cast<const float*>(ghat),
      static_cast<float*>(dpi), static_cast<T*>(dpjn), static_cast<float*>(part), rows, n, d,
      h2, h);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int n_out = h2 * h + 2 * h + 1;
  gn_ell_wgrad_reduce<<<(n_out + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(part), blocks * kWarps, h2, h, static_cast<float*>(grads));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dispatch on (activation, input dtype): act is 0 silu/swish, 1 tanh,
// 2 relu, 3 elu; bf16 is 0 for f32 inputs, 1 for bf16 ones.
#define GN_ELL_DISPATCH(CALL)                                   \
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

// The persistent grid of the forward (backward = 0) or backward kernel:
// blocks per SM at full occupancy times the SMs of the current device. The
// backward's scratch holds blocks * 4 rows of 2,177 floats.
extern "C" int sgp_gn_ell_blocks(int act, int bf16, int backward, int* blocks) {
#define CALL(A, T) blocks_for<A, T>(backward, blocks)
  GN_ELL_DISPATCH(CALL)
#undef CALL
}

// out [rows, h] f32 from p_i [rows, h2], pjn [rows, d, h2] (f32 or bf16),
// mask [n, d] uint8 (row r uses mask row r % n), w2 [h2, h], b2 [h], wg [h],
// bg [1] f32 (w2 and wg already rounded to the input dtype). h2 <= 32,
// h <= 64. Device pointers; launched on `stream`. Returns cudaGetLastError().
extern "C" int sgp_gn_ell_fwd(int act, int bf16, const void* p_i, const void* pjn,
                              const void* mask, const void* w2, const void* b2,
                              const void* wg, const void* bg, void* out, int rows, int n,
                              int d, int h2, int h, int blocks, void* stream) {
  if (h2 > kH2 || h > kH) return static_cast<int>(cudaErrorInvalidValue);
#define CALL(A, T) \
  fwd<A, T>(p_i, pjn, mask, w2, b2, wg, bg, out, rows, n, d, h2, h, blocks, \
            static_cast<cudaStream_t>(stream))
  GN_ELL_DISPATCH(CALL)
#undef CALL
}

// The backward for the forward's inputs and ghat [rows, h] f32: dpi
// [rows, h2] f32, dpjn [rows, d, h2] in the input dtype, and grads =
// [dw2 (h2*h), db2 (h), dwg (h), dbg (1)] f32 through the scratch `part`
// [blocks * 4, 2177] f32. Two launches on `stream`.
extern "C" int sgp_gn_ell_bwd(int act, int bf16, const void* p_i, const void* pjn,
                              const void* mask, const void* w2, const void* b2,
                              const void* wg, const void* bg, const void* ghat, void* dpi,
                              void* dpjn, void* part, void* grads, int rows, int n, int d,
                              int h2, int h, int blocks, void* stream) {
  if (h2 > kH2 || h > kH) return static_cast<int>(cudaErrorInvalidValue);
#define CALL(A, T)                                                                   \
  bwd<A, T>(p_i, pjn, mask, w2, b2, wg, bg, ghat, dpi, dpjn, part, grads, rows, n, d, \
            h2, h, blocks, static_cast<cudaStream_t>(stream))
  GN_ELL_DISPATCH(CALL)
#undef CALL
}
