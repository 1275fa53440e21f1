// The GatedGN pair chain shared by the all-pairs kernels (gn_allpairs.cu,
// K3) and the ELL kernels (gn_ell.cu, K4) for Hopper (sm_90a): the 16-pair
// tensor-core tile (mma.sync m16n8k8, 3xTF32 for f32 operands) that both
// forwards (fwd_batch), K3's row and column passes and K4's backward
// (pair_batch) run. The chain, for s = p_i + p_j (h2 wide):
//
//   t  = act(s)        mt = t @ w2 + b2        mb = act(mt)   (h wide)
//   g  = sigmoid(mb . wg + bg)                 out = sum over pairs g * mb
//
// Everything here sits in an anonymous namespace: each source that includes
// it gets its own copy, as when the code stood in each source.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_common.cuh"

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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
// v rounded to T's precision, as the Pallas kernel's .astype(cdt)
__device__ __forceinline__ float round_as(float v, float) { return v; }
__device__ __forceinline__ float round_as(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// -- the backward on the tensor cores ----------------------------------------
// A warp gathers the set entries of its mask words into batches of kB = 16
// pairs and runs the chain of a batch as matrix products on the tensor cores
// (mma.sync m16n8k8, TF32 in, f32 accumulate). Fragments as in the PTX ISA,
// with g = lane >> 2 and c = lane & 3: A a0 (row g, col c), a1 (g + 8, c),
// a2 (g, c + 4), a3 (g + 8, c + 4); B b0 (k c, n g), b1 (k c + 4, n g); C c0,
// c1 (row g, cols 2c, 2c + 1), c2, c3 (row g + 8, the same cols). A thread
// thus holds pairs g and g + 8 of a batch, channels nt * 8 + 2c + e.

constexpr int kB = 16;           // pairs a batch: the products' M
constexpr int kLdT = kH2 + 4;    // row of the t tile: A reads conflict-free
constexpr int kLdD = kH + 4;     // row of the dmt tile, likewise
constexpr int kFrag = 1024;      // w2 fragments of one layout, a uint4 each
// |mt| below which relu's branch is settled by an FFMA recompute: far above
// 3xTF32's error on mt (~1e-6 at unit scale), rare among the pairs
constexpr float kReluNear = 1e-4f;

// A warp's staging tile: the batch's t, and dact(mt) overwritten by dmt,
// in shared memory, to be read back in the A and B layouts; dact(s), kept
// there for ds (registers are the scarce resource of the row pass).
struct WarpTile {
  float t[kB * kLdT];
  float s[kB * kLdT];
  float d[kB * kLdD];
  int idx[kB];                   // the other node of each pair
};
// dynamic shared memory of a backward block: w2 split hi/lo in the B layout
// of mt = t @ w2 and in that of dt = dmt @ w2^T (16 KB each), the tiles
// (67.25 KB in all)
constexpr int kBwdSmem = 2 * kFrag * (int)sizeof(uint4) + kWarps * (int)sizeof(WarpTile);

// an operand of four values: split, or as it is when TF32 holds it exactly
template <bool kExact>
__device__ __forceinline__ void operand(float v0, float v1, float v2, float v3,
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float v[4] = {v0, v1, v2, v3};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (kExact) {
      hi[r] = __float_as_uint(v[r]);
      lo[r] = 0u;
    } else {
      split(v[r], hi[r], lo[r]);
    }
  }
}

// The tile's sigmoid: the MUFU's ex2 and reciprocal (a few ulp), not
// expf and an IEEE division, whose range reduction and slow-path checks
// cost more issue than the rest of a pair's chain.
__device__ __forceinline__ float sigmoid_fast(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}

// act(x), with its derivative in d from the same transcendental: silu's one
// sigmoid, tanh's tanh, elu's exp
template <int A>
__device__ __forceinline__ float act_dact(float x, float& d) {
  if (A == kSilu) {
    const float s = sigmoid_fast(x);
    d = s * (1.f + x * (1.f - s));
    return x * s;
  }
  if (A == kTanh) {
    const float t = tanhf(x);
    d = 1.f - t * t;
    return t;
  }
  if (A == kRelu) {
    d = x > 0.f ? 1.f : 0.f;
    return fmaxf(x, 0.f);
  }
  const float em = expm1f(x);  // elu
  d = x > 0.f ? 1.f : em + 1.f;
  return x > 0.f ? x : em;
}

__device__ __forceinline__ uint4 pack_split(float v0, float v1) {
  uint4 r;
  split(v0, r.x, r.z);
  split(v1, r.y, r.w);
  return r;
}

// w2 into the two fragment layouts ({b0 hi, b1 hi, b0 lo, b1 lo} a lane;
// rows past h2 and columns past h are 0), b2 and wg into shared memory.
// kDt false: the forward's mt layout alone (wdt unused).
template <bool kDt = true>
__device__ void load_weights(const float* __restrict__ w2, const float* __restrict__ b2,
                             const float* __restrict__ wg, int h2, int h, uint4* wmt,
                             uint4* wdt, float* b2s, float* wgs) {
  auto at = [&](int k, int col) { return (k < h2 && col < h) ? w2[k * h + col] : 0.f; };
  for (int q = threadIdx.x; q < kFrag; q += kThreads) {
    const int lane = q & 31, g = lane >> 2, c = lane & 3;
    const int kk = q >> 8, nt = (q >> 5) & 7;  // mt: [k step 4][n tile 8][lane]
    wmt[q] = pack_split(at(kk * 8 + c, nt * 8 + g), at(kk * 8 + c + 4, nt * 8 + g));
    if constexpr (kDt) {
      const int kd = q >> 7, nd = (q >> 5) & 3;  // dt: [k step 8][n tile 4][lane]
      wdt[q] = pack_split(at(nd * 8 + g, kd * 8 + c), at(nd * 8 + g, kd * 8 + c + 4));
    }
  }
  if (threadIdx.x < kH) {
    b2s[threadIdx.x] = threadIdx.x < h ? b2[threadIdx.x] : 0.f;
    wgs[threadIdx.x] = threadIdx.x < h ? wg[threadIdx.x] : 0.f;
  }
  __syncthreads();
}

// The set entries of one mask row within [lo, hi), this warp's share (the
// 32-column words w, w + kStride, ... counted from lo: K3's four warps share
// a row, a K4 warp takes all of its row with kStride 1 and w 0), kB at a
// time. With lo_of / hi_of, entry k is taken only where lo_of[k] <= key <
// hi_of[k] (the column pass's window check). Warp-uniform.
template <int kStride>
struct BatchWalkT {
  const uint8_t* row;
  const int* lo_of;
  const int* hi_of;
  int hi, j0, key;
  unsigned bits;

  __device__ __forceinline__ BatchWalkT(const uint8_t* r, int lo, int hi_, int warp,
                                        const int* lo_of_ = nullptr,
                                        const int* hi_of_ = nullptr, int key_ = 0)
      : row(r), lo_of(lo_of_), hi_of(hi_of_), hi(hi_), j0(lo + 32 * (warp - kStride)),
        key(key_), bits(0u) {}

  // the next batch's entries into idx[0 .. count); 0 when the share is done
  __device__ __forceinline__ int fill(int* idx) {
    const int lane = threadIdx.x & 31;
    int cnt = 0;
    while (cnt < kB) {
      if (bits == 0u) {
        j0 += 32 * kStride;
        if (j0 >= hi) break;
        const int j = j0 + lane;
        bool set = j < hi && row[j] != 0;
        if (set && lo_of != nullptr) set = lo_of[j] <= key && key < hi_of[j];
        bits = __ballot_sync(kFull, set);
        continue;
      }
      const int take = min(kB - cnt, __popc(bits));
      const bool mine = (bits >> lane) & 1u;
      const int rank = __popc(bits & ((1u << lane) - 1u));
      if (mine && rank < take) idx[cnt + rank] = j0 + lane;
      bits = __ballot_sync(kFull, mine && rank >= take);
      cnt += take;
    }
    __syncwarp();
    return cnt;
  }
};
using BatchWalk = BatchWalkT<kWarps>;

// The row pass's weight-gradient partials of one warp in registers: dw2 as
// the C fragments of a [32 x 64] product, and dbg. db2 and dwg (16 channels
// a thread) live in shared memory, a slot per (lane row g, channel), so that
// the pass fits its registers without spilling.
constexpr int kLdW = kH + 4;                       // a slot row: 2-way banks
constexpr int kWSum = 2 * 8 * kLdW;                // [db2, dwg][g][channel]
struct WGrad {
  float dw[2][8][4];
  float dbg;

  // zero the partials and the warp's slots
  __device__ __forceinline__ void clear(float* wsum) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) dw[mi][nt][r] = 0.f;
    dbg = 0.f;
    for (int k = threadIdx.x & 31; k < kWSum; k += 32) wsum[k] = 0.f;
    __syncwarp();
  }

  // the warp's partials as one scratch row p of kPart floats: dw2 [32][64],
  // db2 and dwg (each channel's 8 slots summed in order), dbg
  __device__ __forceinline__ void write(const float* wsum, float* __restrict__ p) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          p[(mi * 16 + g + (r >> 1) * 8) * kH + nt * 8 + 2 * c + (r & 1)] = dw[mi][nt][r];
    __syncwarp();  // db2, dwg: each channel's 8 slots (rows g) in order
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int ch = lane; ch < kH; ch += 32) {
        float v = 0.f;
#pragma unroll
        for (int gg = 0; gg < 8; ++gg) v += wsum[(q * 8 + gg) * kLdW + ch];
        p[kH2 * kH + q * kH + ch] = v;
      }
    float s = dbg;  // the same in the 4 lanes of a quad: sum over g
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) s += __shfl_xor_sync(kFull, s, o);
    if (lane == 0) p[kH2 * kH + 2 * kH] = s;
  }
};
constexpr int kBwdRowsSmem = kBwdSmem + kWarps * kWSum * (int)sizeof(float);

// k step kk of m += t @ w2 from a warp's t tile (kk * 8 .. kk * 8 + 7),
// for the n tiles nh .. nh + nn - 1. The step's partial is formed by the mma from
// 0 and added to m by FADD: the tensor cores round their sum toward zero,
// so 12 mmas accumulating into m bias mt toward zero by a few ulp, and the
// forward's outputs with it. A training run sums that bias over every node:
// so accumulated, chip_smoke.py's full-graph run drifted 2.1e-4 from the
// plain f32 run in 8 steps (its limit is 1e-4).
template <bool kBf>
__device__ __forceinline__ void mt_step(float (&m)[8][4], const float* __restrict__ t,
                                        const uint4* __restrict__ wmt, int kk, int nh,
                                        int nn = 4) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const float* t0 = t + g * kLdT + kk * 8 + c;
  uint32_t ah[4], al[4];
  operand<kBf>(t0[0], t0[8 * kLdT], t0[4], t0[8 * kLdT + 4], ah, al);
#pragma unroll
  for (int nt = nh; nt < nh + nn; ++nt) {
    const uint4 w = wmt[(kk * 8 + nt) * 32 + lane];
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    mma3<kBf, kBf>(f, ah, al, w.x, w.y, w.z, w.w);
#pragma unroll
    for (int r = 0; r < 4; ++r) m[nt][r] += f[r];
  }
}

// One batch of cnt <= kB pairs. kRows: the pairs share the destination row
// (p_i in own, ghat at gh, p_j rows at po; the weight gradients accumulate,
// db2 and dwg into the lane's slots at wsum); else they share the source
// column (p_j in own, p_i and ghat rows at po and gh). ds = dt * dact(s) of the valid pairs accumulates into dsum. Slots past
// cnt take a cotangent of 0 and are left out of every sum.
// What K4 asks beyond K3 (all false for K3): kRoundDt rounds dmt as the
// input for the dt product too, as the Pallas ELL kernel does (the
// all-pairs one rounds it for dw2 only); kStoreDs also stores each valid
// pair's ds at the pair's row of ds_out (h2 wide, in T), through the tile's
// s; kFresh forms each k step of mt and dt, and each batch's dw2 terms, in
// fresh fragments and adds them by FADD. (The tensor cores add into their
// accumulator with truncation, a drift of up to ~2^-23 of the sum an mma:
// K4's warp keeps dw2 over ~2,400 pairs, 450 mmas, and drifts by ~2e-5 of
// it; with fresh fragments the sum over batches rounds to nearest. mt and
// dt summed over their 4 and 8 k steps in the accumulator put d_pi 4-6x and
// d_pjn 2-3x as far from float64 as the plain version on the 100-nn
// training slice's inputs, and phase 5 of chip_smoke.py then drifted from
// the plain run (tools/k4_fwd_probe.py). K3's chunks are a third as long.)
template <int A, typename T, bool kRows, bool kRoundDt = false, bool kStoreDs = false,
          bool kFresh = false>
__device__ __forceinline__ void pair_batch(const uint4* __restrict__ wmt,
                                           const uint4* __restrict__ wdt,
                                           const float* __restrict__ b2s,
                                           const float* __restrict__ wgs, float bg,
                                           const float* __restrict__ w2,
                                           WarpTile& wt, int cnt, const T* __restrict__ po,
                                           const float (&own)[4][2],
                                           const float* __restrict__ gh, int h2, int h,
                                           float (&dsum)[4][2], WGrad& wgr,
                                           float* __restrict__ wsum,
                                           T* __restrict__ ds_out = nullptr) {
  constexpr bool kBf = std::is_same<T, __nv_bfloat16>::value;  // t, w2 exact in TF32
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  bool ok[2];
  int node[2];
#pragma unroll
  for (int pr = 0; pr < 2; ++pr) {
    ok[pr] = g + 8 * pr < cnt;
    node[pr] = ok[pr] ? wt.idx[g + 8 * pr] : 0;
  }
  // ghat rows hold kH channels, zero past h: float2 loads of channels 2c,
  // 2c + 1. (A padding slot's dgz and dmt are set to 0 whatever its ghat.)
  auto ghat2 = [&](int pr, int nt) {
    return *reinterpret_cast<const float2*>(gh + (kRows ? 0 : (size_t)node[pr] * kH) +
                                            nt * 8 + 2 * c);
  };

  // 1. s in dt's C layout; t (rounded as the input) and dact(s) to the tile
#pragma unroll
  for (int pr = 0; pr < 2; ++pr)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ch = nt * 8 + 2 * c + e;
        const float o = (ok[pr] && ch < h2) ? to_f32(po[(size_t)node[pr] * h2 + ch]) : 0.f;
        float ds;
        const float t = act_dact<A>(own[nt][e] + o, ds);
        wt.t[(g + 8 * pr) * kLdT + ch] = round_as(t, T());
        wt.s[(g + 8 * pr) * kLdT + ch] = ds;
      }
  __syncwarp();

  // 2. mt = t @ w2 + b2: M 16 pairs, K h2, N h
  float m[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    m[nt][0] = m[nt][2] = b2s[nt * 8 + 2 * c];
    m[nt][1] = m[nt][3] = b2s[nt * 8 + 2 * c + 1];
  }
  if constexpr (kFresh) {
#pragma unroll 1
    for (int kk = 0; kk < 4; ++kk) mt_step<kBf>(m, wt.t, wmt, kk, 0, 8);
  } else {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* t0 = wt.t + g * kLdT + kk * 8 + c;
      uint32_t ah[4], al[4];
      operand<kBf>(t0[0], t0[8 * kLdT], t0[4], t0[8 * kLdT + 4], ah, al);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const uint4 w = wmt[(kk * 8 + nt) * 32 + lane];
        mma3<kBf, kBf>(m[nt], ah, al, w.x, w.y, w.z, w.w);
      }
    }
  }

  // 3. mb and dact(mt) from one transcendental; the gate and dgz are sums
  //    over the 64 channels: the thread's 16, then 2 quad shuffles
  // the column pass's pairs have rows of their own: their ghat is loaded
  // once (the row pass's one row is an L1 broadcast, loaded where used)
  float2 ecol[2][8];
  if constexpr (!kRows) {
#pragma unroll
    for (int pr = 0; pr < 2; ++pr)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) ecol[pr][nt] = ghat2(pr, nt);
  }
  auto ghat_at = [&](int pr, int nt, int e) {
    const float2 v = kRows ? ghat2(pr, nt) : ecol[pr][nt];
    return e ? v.y : v.x;
  };
  float z[2] = {0.f, 0.f}, ez[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int pr = r >> 1, ch = nt * 8 + 2 * c + (r & 1);
      if (A == kRelu && fabsf(m[nt][r]) < kReluNear && ch < h) {
        // relu's derivative jumps at 0: take the side f32 FFMA takes
        const float* t0 = wt.t + (g + 8 * pr) * kLdT;
        float acc = b2s[ch];
#pragma unroll 1
        for (int k = 0; k < h2; ++k) acc = fmaf(t0[k], w2[k * h + ch], acc);
        m[nt][r] = acc;
      }
      float dm;
      const float mb = act_dact<A>(m[nt][r], dm);
      m[nt][r] = mb;
      wt.d[(g + 8 * pr) * kLdD + ch] = dm;
      z[pr] = fmaf(wgs[ch], mb, z[pr]);
      ez[pr] = fmaf(ghat_at(pr, nt, r & 1), mb, ez[pr]);
    }
  float gate[2], dgz[2];
#pragma unroll
  for (int pr = 0; pr < 2; ++pr) {
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      z[pr] += __shfl_xor_sync(kFull, z[pr], o);
      ez[pr] += __shfl_xor_sync(kFull, ez[pr], o);
    }
    gate[pr] = sigmoid_fast(z[pr] + bg);
    dgz[pr] = ok[pr] ? ez[pr] * gate[pr] * (1.f - gate[pr]) : 0.f;
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ch = nt * 8 + 2 * c + e;
      float db = 0.f, dw = 0.f;  // the thread's two pairs, then its slots
#pragma unroll
      for (int pr = 0; pr < 2; ++pr) {
        float* dp = wt.d + (g + 8 * pr) * kLdD + ch;
        const float dmt =
            ok[pr] ? fmaf(ghat_at(pr, nt, e), gate[pr], wgs[ch] * dgz[pr]) * *dp : 0.f;
        *dp = dmt;
        db += dmt;
        dw = fmaf(m[nt][2 * pr + e], dgz[pr], dw);
      }
      if constexpr (kRows) {
        float* slot = wsum + g * kLdW + ch;  // this thread's own slots
        slot[0] += db;
        slot[8 * kLdW] += dw;
      }
    }
  if constexpr (kRows) wgr.dbg += dgz[0] + dgz[1];
  __syncwarp();

  // 4. dt = dmt @ w2^T: M 16, K h, N h2; ds = dt * dact(s) into dsum
  constexpr bool kDExact = kRoundDt && kBf;  // dmt rounded to bf16: exact in TF32
  auto dmt_dt = [](float v) { return kRoundDt ? round_as(v, T()) : v; };
  float q[4][4] = {};
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const float* d0 = wt.d + g * kLdD + kk * 8 + c;
    uint32_t ah[4], al[4];
    operand<kDExact>(dmt_dt(d0[0]), dmt_dt(d0[8 * kLdD]), dmt_dt(d0[4]),
                     dmt_dt(d0[8 * kLdD + 4]), ah, al);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const uint4 w = wdt[(kk * 4 + nt) * 32 + lane];
      if constexpr (kFresh) {
        float f[4] = {0.f, 0.f, 0.f, 0.f};
        mma3<kDExact, kBf>(f, ah, al, w.x, w.y, w.z, w.w);
#pragma unroll
        for (int r = 0; r < 4; ++r) q[nt][r] += f[r];
      } else {
        mma3<kDExact, kBf>(q[nt], ah, al, w.x, w.y, w.z, w.w);
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int pr = r >> 1, e = r & 1;
      if (!ok[pr]) continue;
      float* sd = wt.s + (g + 8 * pr) * kLdT + nt * 8 + 2 * c + e;
      if constexpr (kStoreDs) {  // ds replaces dact(s) in the tile, stored below
        *sd *= q[nt][r];
        dsum[nt][e] += *sd;
      } else {
        dsum[nt][e] = fmaf(q[nt][r], *sd, dsum[nt][e]);
      }
    }

  // 5. rows: dw2 += t^T @ dmt, dmt rounded as the input: M h2, K 16, N h
  if constexpr (kRows) {
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const float* t0 = wt.t + (ks * 8 + c) * kLdT + mi * 16 + g;
        operand<kBf>(t0[0], t0[8], t0[4 * kLdT], t0[4 * kLdT + 8], ah[mi], al[mi]);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float* d0 = wt.d + (ks * 8 + c) * kLdD + nt * 8 + g;
        uint32_t bh0, bl0, bh1, bl1;
        const float v0 = round_as(d0[0], T()), v1 = round_as(d0[4 * kLdD], T());
        if (kBf) {
          bh0 = __float_as_uint(v0);
          bh1 = __float_as_uint(v1);
          bl0 = bl1 = 0u;
        } else {
          split(v0, bh0, bl0);
          split(v1, bh1, bl1);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          if constexpr (kFresh) {
            float f[4] = {0.f, 0.f, 0.f, 0.f};
            mma3<kBf, kBf>(f, ah[mi], al[mi], bh0, bh1, bl0, bl1);
#pragma unroll
            for (int r = 0; r < 4; ++r) wgr.dw[mi][nt][r] += f[r];
          } else {
            mma3<kBf, kBf>(wgr.dw[mi][nt], ah[mi], al[mi], bh0, bh1, bl0, bl1);
          }
        }
      }
    }
  }

  // 6. each valid pair's ds from the tile to its row of ds_out, a lane a
  //    channel (one coalesced row a pair)
  if constexpr (kStoreDs) {
    __syncwarp();
    if (lane < h2)
      for (int p = 0; p < cnt; ++p)
        store(ds_out + (size_t)wt.idx[p] * h2 + lane, wt.s[p * kLdT + lane]);
  }
  __syncwarp();  // the tile and idx are rewritten by the next batch
}

// -- the forward on the tensor cores -----------------------------------------
// The same 16-pair batches and mt product as pair_batch, without the
// backward's tiles: a forward warp stages t alone.
struct FwdTile {
  float t[kB * kLdT];
  int idx[kB];                   // the other node of each pair
};
// dynamic shared memory of a forward block: w2 split hi/lo in the mt layout
// (16 KB), the tiles (25.25 KB in all)
constexpr int kFwdSmem = kFrag * (int)sizeof(uint4) + kWarps * (int)sizeof(FwdTile);
// forward blocks an SM at the least (K3's and K4's): ptxas keeps the forward
// under 128 registers (K3's takes 92-122), and 16 warps an SM hide more of
// its chain's latency than 12 with more registers each
constexpr int kFwdBlocks = 4;

// act(x) with the MUFU's sigmoid for silu; tanh and elu as in act
template <int A>
__device__ __forceinline__ float act_fast(float x) {
  return A == kSilu ? x * sigmoid_fast(x) : act<A>(x);
}

// One forward batch of cnt <= kB pairs that share a node (own: its
// projection on the lane's channel, lane < h2; 0 past h2), the other nodes'
// rows at po: acc[nt][e] += g * mb over the valid pairs, for the thread's
// channels nt * 8 + 2c + e, each pair's g and mb from the thread's rows g
// and g + 8. The sum stays in registers, added by FFMA (never inside an mma
// accumulator, which truncates). A padding slot's t is 0 and its gate 0.
template <int A, typename T>
__device__ __forceinline__ void fwd_batch(const uint4* __restrict__ wmt,
                                          const float* __restrict__ b2s,
                                          const float* __restrict__ wgs, float bg,
                                          FwdTile& wt, int cnt, const T* __restrict__ po,
                                          float own, int h2, float (&acc)[8][2]) {
  constexpr bool kBf = std::is_same<T, __nv_bfloat16>::value;  // t, w2 exact in TF32
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;

  // 1. t = act(own + po) rounded as the input, a lane a channel: each pair's
  //    row is one coalesced load, the 16 loads in flight together
  float o[kB];
#pragma unroll
  for (int p = 0; p < kB; ++p)
    o[p] = (p < cnt && lane < h2) ? to_f32(po[(size_t)wt.idx[p] * h2 + lane]) : 0.f;
#pragma unroll
  for (int p = 0; p < kB; ++p)
    wt.t[p * kLdT + lane] = p < cnt ? round_as(act_fast<A>(own + o[p]), T()) : 0.f;
  __syncwarp();

  // 2. mt = t @ w2 + b2 (M 16 pairs, K h2, N h) and mb = act(mt), in two
  //    halves of 32 channels, the k loop rolled: with the partials of all 8
  //    n tiles (or of every k step) in flight, ptxas spills the f32 kernels
  //    even at 168 registers; a half keeps 4 in flight, and the first
  //    half's mb waits in 16 registers (92-122 registers, no spill).
  float m[8][4];
  float z[2] = {0.f, 0.f};  // the gate's sums over the thread's 16 channels
#pragma unroll
  for (int nh = 0; nh < 8; nh += 4) {
#pragma unroll
    for (int nt = nh; nt < nh + 4; ++nt) {
      m[nt][0] = m[nt][2] = b2s[nt * 8 + 2 * c];
      m[nt][1] = m[nt][3] = b2s[nt * 8 + 2 * c + 1];
    }
#pragma unroll 1
    for (int kk = 0; kk < 4; ++kk) mt_step<kBf>(m, wt.t, wmt, kk, nh);
#pragma unroll
    for (int nt = nh; nt < nh + 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        m[nt][r] = act_fast<A>(m[nt][r]);
        z[r >> 1] = fmaf(wgs[nt * 8 + 2 * c + (r & 1)], m[nt][r], z[r >> 1]);
      }
  }

  // 3. the gate's sums over the 64 channels: 2 quad shuffles; g * mb of the
  //    valid pairs into acc
  float gate[2];
#pragma unroll
  for (int pr = 0; pr < 2; ++pr) {
#pragma unroll
    for (int o2 = 1; o2 <= 2; o2 <<= 1) z[pr] += __shfl_xor_sync(kFull, z[pr], o2);
    gate[pr] = g + 8 * pr < cnt ? sigmoid_fast(z[pr] + bg) : 0.f;
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      acc[nt][e] = fmaf(gate[0], m[nt][e], acc[nt][e]);
      acc[nt][e] = fmaf(gate[1], m[nt][2 + e], acc[nt][e]);
    }
  __syncwarp();  // the tile and idx are rewritten by the next batch
}

// the thread's projections of one node on the channels of dt's C layout
template <typename T>
__device__ __forceinline__ void own_row(const T* __restrict__ p, int h2, float (&own)[4][2]) {
  const int c = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ch = nt * 8 + 2 * c + e;
      own[nt][e] = ch < h2 ? to_f32(p[ch]) : 0.f;
    }
}

// grads = [dw2 (h2*h), db2 (h), dwg (h), dbg (1)]: each entry the sum of its
// column of the per-warp partials (K3: a row per (chunk, warp); K4: a row
// per warp of the grid). A block takes 32 entries; its 8 rows of threads sum
// the partials w = y, y + 8, ... in order, then row 0 adds the 8 sums in
// order: the same order on every run.
constexpr int kReduceRows = 8;

__global__ void wgrad_reduce(const float* __restrict__ part, int n_parts, int h2, int h,
                             float* __restrict__ grads) {
  __shared__ float sums[kReduceRows][32];
  const int j = blockIdx.x * 32 + threadIdx.x;
  const int n_out = h2 * h + 2 * h + 1;
  int col = 0;
  if (j < h2 * h) col = (j / h) * kH + j % h;
  else if (j < h2 * h + h) col = kH2 * kH + (j - h2 * h);
  else if (j < h2 * h + 2 * h) col = kH2 * kH + kH + (j - h2 * h - h);
  else col = kH2 * kH + 2 * kH;
  float acc = 0.f;
  if (j < n_out)
    for (int w = threadIdx.y; w < n_parts; w += kReduceRows) acc += part[(size_t)w * kPart + col];
  sums[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && j < n_out) {
    float total = 0.f;
#pragma unroll
    for (int y = 0; y < kReduceRows; ++y) total += sums[y][threadIdx.x];
    grads[j] = total;
  }
}

template <typename K>
int occupancy(K kernel, int smem, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  const int err = allow_smem(kernel, smem);
  if (err != 0) return err;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  *blocks = sms * per_sm;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
