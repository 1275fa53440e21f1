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
// Design of the forward: K3's forward tile (fwd_batch, gated_pair.cuh) on a
// row of slots. One warp owns one (b, n) row; a persistent grid, sized by the
// occupancy calculator at four blocks an SM, strides over the B*N rows. The
// warp gathers the row's valid slots (ballot and popc ranks, BatchWalkT<1>)
// into batches of 16 pairs whose partner is the slot's row of pjn. In a batch
// lane k forms t[k] = act(p_i[k] + pjn[slot][k]) of each pair (one coalesced
// row a pair, the 16 loads in flight together) into a shared tile; mt = t @
// w2 + b2 runs on mma.sync m16n8k8 in two halves of 32 channels, with w2
// split hi/lo in shared memory in the B layout; mb, the gate's quad-shuffle
// sum and g * mb are computed on the accumulator fragments, and a thread's 16
// channel sums stay in registers over the row. At the row's end they are
// summed over the warp's 8 rows of threads by shuffles, in a fixed order: a
// row with no valid slot gives exactly 0, and two calls give the same bits.
// Channels past h2 and h are zero-padded (every activation in the table maps
// 0 to 0). No atomics and no __syncthreads after the weights are loaded: the
// warp owns its row.
//
// Design of the backward: K3's row pass (gn_allpairs.cu) on a row of slots,
// with the 16-pair tensor-core tile of gated_pair.cuh. The same persistent
// grid, a warp per (b, n) row. The warp gathers the row's valid slots (ballot
// and popc ranks) into batches of 16 pairs whose partner is the slot's row of
// pjn; a batch's three h2 x h products (the recompute of mt, dt and dw2) run
// on mma.sync m16n8k8, and each valid pair's ds = dt * dact(s) is stored to
// d_pjn beside its sum into d_pi. A masked slot gets a d_pjn of exactly 0,
// written from the mask's ballot. dw2 stays in fragments over the warp's
// whole loop, each batch's terms formed by the mma from 0 and added by FADD
// (kFresh: a sum over ~2,400 pairs inside the mma's truncating accumulator
// drifts by ~2e-5), and so are the k steps of mt and dt (summed inside it,
// they put d_pi 4-6x and d_pjn 2-3x as far from float64 as the plain
// version); db2 and dwg in per-lane shared slots; at the end each warp
// writes one scratch row of partials and a second kernel sums the rows in a
// fixed order, so the result is deterministic. d_pi needs no
// __syncthreads: the warp owns its row.
//
// Numerics. f32 inputs: in both directions every product of two f32
// operands is 3xTF32 (about 2^-21 relative) and the sigmoid the MUFU's (a
// few ulp). The forward forms each k step of mt from 0 and adds it by FADD
// (mt_step: summed inside the mma's truncating accumulator, mt would carry a
// bias of a few ulp toward zero into every message), and the sums over
// slots are FFMA outside the tensor cores. In the backward relu's branch is
// settled by an FFMA recompute where |mt| < 1e-4. bf16 inputs round where
// the Pallas kernel rounds: t is rounded to bf16 before the w2 product, dmt
// before the w2^T and dw2 products (w2 and wg arrive already rounded to
// bf16, held in f32; ghat is not rounded), d_pjn is stored as bf16; every
// sum is f32. A bf16 value is exact in TF32, so each bf16 product is one
// mma.
//
// What bounds it on this card. Per pair the forward does one h2 x h product
// on the tensor cores (2*h2*h = 4,096 FLOP, three times over for f32) and
// 2*(h2+h+1) = 194 MUFU operations (an ex2 and a reciprocal a sigmoid) on 128
// bytes of pjn (f32): the MUFU bounds it, HBM (pjn streams once, unlike K3's
// L2-resident p_j) a little below. A row of 100 slots fills 7 batches, the
// last with 4 of its 16 pairs. The backward does three such products on the
// tensor cores (three times over for f32) and reads pjn and writes d_pjn (256
// bytes a pair for f32): bytes bound it. The ways to a faster kernel:
// gathering p_j[src] in both directions instead of reading the gathered pjn
// (no pjn in HBM, and the gather and its scatter-add gone from the layer),
// and filling the last batch of a row with the next row's slots.

#include "gated_pair.cuh"

namespace {

// The forward: a warp per (b, n) row, its valid slots in batches of 16
// pairs on K3's forward tile (fwd_batch); the warp owns its row, so its sums
// need no other warp. Shared memory as K3's forward: w2's mt fragments and
// a FwdTile a warp (kFwdSmem, dynamic), kFwdBlocks blocks an SM.
template <int A, typename T>
__global__ void __launch_bounds__(kThreads, kFwdBlocks)
gn_ell_fwd_kernel(const T* __restrict__ p_i, const T* __restrict__ pjn,
                  const uint8_t* __restrict__ mask, const float* __restrict__ w2,
                  const float* __restrict__ b2, const float* __restrict__ wg,
                  const float* __restrict__ bgp, float* __restrict__ out, int rows,
                  int n, int d, int h2, int h) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* wmt = reinterpret_cast<uint4*>(smem);
  __shared__ float b2s[kH], wgs[kH];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, c = lane & 3;
  FwdTile& wt = reinterpret_cast<FwdTile*>(wmt + kFrag)[warp];
  load_weights<false>(w2, b2, wg, h2, h, wmt, nullptr, b2s, wgs);
  const float bg = *bgp;

  for (int row = blockIdx.x * kWarps + warp; row < rows; row += gridDim.x * kWarps) {
    const float own = lane < h2 ? to_f32(p_i[(size_t)row * h2 + lane]) : 0.f;
    float acc[8][2] = {};
    BatchWalkT<1> walk(mask + (size_t)(row % n) * d, 0, d, 0);
    for (int cnt = walk.fill(wt.idx); cnt > 0; cnt = walk.fill(wt.idx))
      fwd_batch<A, T>(wmt, b2s, wgs, bg, wt, cnt, pjn + (size_t)row * d * h2, own, h2, acc);
    // each channel's sum over the 8 lane rows g (a row with no valid slot: 0)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = acc[nt][e];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(kFull, v, o);
        const int ch = nt * 8 + 2 * c + e;
        if (lane < 4 && ch < h) out[(size_t)row * h + ch] = v;
      }
  }
}

// The backward: d_pi, d_pjn and the weight-gradient partials, a warp per
// row. Shared memory as K3's row pass: w2's fragments, the warps' tiles and
// their db2 / dwg slots (kBwdRowsSmem, dynamic), two blocks an SM. (Two
// blocks as the floor: ptxas otherwise chooses 168 registers for some
// instantiations and spills.)
template <int A, typename T>
__global__ void __launch_bounds__(kThreads, 2)
gn_ell_bwd_kernel(const T* __restrict__ p_i, const T* __restrict__ pjn,
                  const uint8_t* __restrict__ mask, const float* __restrict__ w2,
                  const float* __restrict__ b2, const float* __restrict__ wg,
                  const float* __restrict__ bgp, const float* __restrict__ ghat,
                  float* __restrict__ dpi, T* __restrict__ dpjn, float* __restrict__ part,
                  int rows, int n, int d, int h2, int h) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* wmt = reinterpret_cast<uint4*>(smem);
  uint4* wdt = wmt + kFrag;
  __shared__ float b2s[kH], wgs[kH];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, c = lane & 3;
  WarpTile* tiles = reinterpret_cast<WarpTile*>(wdt + kFrag);
  WarpTile& wt = tiles[warp];
  float* wsum = reinterpret_cast<float*>(tiles + kWarps) + warp * kWSum;
  load_weights(w2, b2, wg, h2, h, wmt, wdt, b2s, wgs);
  const float bg = *bgp;

  WGrad wgr;
  wgr.clear(wsum);

  for (int row = blockIdx.x * kWarps + warp; row < rows; row += gridDim.x * kWarps) {
    const uint8_t* mrow = mask + (size_t)(row % n) * d;
    T* dpj = dpjn + (size_t)row * d * h2;
    float own[4][2], dsum[4][2] = {};
    own_row(p_i + (size_t)row * h2, h2, own);
    BatchWalkT<1> walk(mrow, 0, d, 0);
    for (int cnt = walk.fill(wt.idx); cnt > 0; cnt = walk.fill(wt.idx))
      pair_batch<A, T, true, true, true, true>(wmt, wdt, b2s, wgs, bg, w2, wt, cnt,
                                               pjn + (size_t)row * d * h2, own,
                                               ghat + (size_t)row * kH, h2, h, dsum, wgr,
                                               wsum, dpj);
    // d_pi: the sum over the 8 lane rows g of each channel's column
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = dsum[nt][e];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(kFull, v, o);
        const int ch = nt * 8 + 2 * c + e;
        if (lane < 4 && ch < h2) dpi[(size_t)row * h2 + ch] = v;
      }
    // masked slots: a cotangent of exactly 0
    for (int j0 = 0; j0 < d; j0 += 32) {
      const int j = j0 + lane;
      for (unsigned pad = __ballot_sync(kFull, j < d && mrow[j] == 0); pad != 0u;
           pad &= pad - 1u)
        if (lane < h2) store(dpj + (size_t)(j0 + __ffs(pad) - 1) * h2 + lane, 0.f);
    }
  }

  wgr.write(wsum, part + (size_t)(blockIdx.x * kWarps + warp) * kPart);
}

template <int A, typename T>
int blocks_for(int backward, int* blocks) {
  if (backward) return occupancy(gn_ell_bwd_kernel<A, T>, kBwdRowsSmem, blocks);
  return occupancy(gn_ell_fwd_kernel<A, T>, kFwdSmem, blocks);
}

template <int A, typename T>
int fwd(const void* p_i, const void* pjn, const void* mask, const void* w2, const void* b2,
        const void* wg, const void* bg, void* out, int rows, int n, int d, int h2, int h,
        int blocks, cudaStream_t stream) {
  const int err = allow_smem(gn_ell_fwd_kernel<A, T>, kFwdSmem);
  if (err != 0) return err;
  gn_ell_fwd_kernel<A, T><<<blocks, kThreads, kFwdSmem, stream>>>(
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
  int err = allow_smem(gn_ell_bwd_kernel<A, T>, kBwdRowsSmem);
  if (err != 0) return err;
  gn_ell_bwd_kernel<A, T><<<blocks, kThreads, kBwdRowsSmem, stream>>>(
      static_cast<const T*>(p_i), static_cast<const T*>(pjn),
      static_cast<const uint8_t*>(mask), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(wg),
      static_cast<const float*>(bg), static_cast<const float*>(ghat),
      static_cast<float*>(dpi), static_cast<T*>(dpjn), static_cast<float*>(part), rows, n, d,
      h2, h);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int n_out = h2 * h + 2 * h + 1;
  wgrad_reduce<<<(n_out + 31) / 32, dim3(32, kReduceRows), 0, stream>>>(
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
// blocks per SM at full occupancy (each with its dynamic shared memory)
// times the SMs of the current device. The backward's scratch holds
// blocks * 4 rows of 2,177 floats.
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

// The backward for the forward's inputs and ghat [rows, 64] f32 (columns
// past h zero): dpi [rows, h2] f32, dpjn [rows, d, h2] in the input dtype,
// and grads = [dw2 (h2*h), db2 (h), dwg (h), dbg (1)] f32 through the
// scratch `part` [blocks * 4, 2177] f32. Two launches on `stream`.
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
