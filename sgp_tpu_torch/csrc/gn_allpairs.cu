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
// no cheap per-pair path. Here only the set mask entries are computed: at
// 14.75% density that is 6.8x fewer pairs. Skipping a masked pair differs
// from multiplying it by 0 only where the pair's chain is not finite; the
// inputs are finite.
//
// Design of the forward. A block of four warps takes one work item at a time
// from a global counter (a persistent grid): a destination row. The four
// warps split the row's window into 32-column words (warp w takes words w,
// w + 4, ...), ballot each word's 32 mask bytes and gather the set bits into
// batches of 16 pairs (BatchWalk, gated_pair.cuh). A batch runs on the
// backward's tensor-core tile (fwd_batch): lane k forms t[k] = act(p_i[k] +
// p_j[j][k]) of each pair (p_j comes straight from global memory, 642 KB at
// the slice, L2-resident, one coalesced row a pair) into a shared tile; mt =
// t @ w2 + b2 is 32 mma.sync m16n8k8 (three times over for f32, 3xTF32), in
// two halves of 32 channels, each k step's partial added to mt by FADD, with
// w2 split hi/lo in shared memory in the B layout; mb, the gate's quad-shuffle
// sum and g * mb are computed on the accumulator fragments, and a thread's
// 16 channel sums stay in registers over the row. At the row's end they are
// summed over the warp's 8 rows of threads by shuffles, then the four warps'
// sums in a fixed order through shared memory, so an empty row gives exactly
// 0 and the result does not depend on the schedule. The counter balances
// rows of very different degree (a threshold graph's boundary nodes have a
// quarter of an interior node's neighbours).
//
// Backward, two passes, deterministic, no atomics on data:
//  1. rows: chunks of kChunk destination rows. d_pi is the row sum (fixed
//     order as above); each warp keeps its share of dw2, db2, dwg and dbg
//     over the chunk and writes it to a scratch row per (chunk, warp); a last
//     kernel sums the rows in order.
//  2. columns: d_pj[j] = sum_i mask[i,j] * ds_ij is a sum across rows, so a
//     second pass walks the transposed mask per source column (within the
//     column's range of windows, each pair checked against its row's window)
//     and recomputes the chain. The mask need not be symmetric.
// In both passes a warp gathers its set mask entries (ballot and popc ranks)
// into batches of 16 pairs, and a batch's three h2 x h products -- mt = t @
// w2, dt = dmt @ w2^T and, in the row pass, dw2 += t^T @ dmt -- run on the
// tensor cores (mma.sync m16n8k8 TF32, f32 accumulation), with the chain's
// elementwise work on the accumulator fragments: a sigmoid is computed once
// for act and dact, the gate and dgz are quad-shuffle sums. dw2 stays in
// accumulator fragments over the whole chunk. t and dmt go through a per-warp
// shared tile to be read back as A and B operands; w2 sits in shared memory,
// split hi/lo, in the B layouts of both products it enters (16 KB each, so
// every fragment load is one conflict-free 16-byte read). A batch's padding
// slots take a cotangent of 0 and are left out of every sum.
//
// Numerics. f32 inputs: every product of two f32 operands is 3xTF32 (x = hi +
// lo, both TF32; hi*hi + hi*lo + lo*hi, about 2^-21 relative), never TF32
// alone; the sums over pairs are FFMA and FADD outside the tensor cores (an
// mma accumulator adds with truncation), and so are the forward's sums of
// mt's four k steps (mt_step, gated_pair.cuh). bf16 inputs round where the Pallas
// kernel and its wrapper round: w2 and wg arrive rounded to bf16 (held in
// f32), ghat arrives rounded to bf16 (held in f32), t is rounded to bf16
// before the w2 product, dmt is rounded to bf16 for the dw2 product only (dt
// contracts the rounded w2 with the f32 dmt); every sum is f32. A bf16 value
// is exact in TF32 and is not split: mt and dw2 take one product, dt two.
// The sigmoid is the MUFU's (ex2, reciprocal: a few ulp). relu's derivative
// jumps at 0, so where 3xTF32 leaves |mt| < 1e-4 the backward recomputes the
// pair's mt with FFMA, and the branch is the one f32 takes; the forward needs
// no such step (relu is continuous: an error in mt moves mb by no more).
//
// What bounds it on this card. Per pair the forward does one h2 x h product
// (2*h2*h = 4,096 FLOP, three times over for f32) plus the gate, and h2 + h
// + 1 sigmoids, on inputs that sit in L2: the MUFU bounds it (bytes are the
// mask, N^2 bytes, read once). The backward does the recompute, dt and dw2
// (three h2 x h products a pair in pass 1, two in pass 2) on the tensor
// cores, three times over for f32; the transcendentals (one sigmoid per
// channel of s and of mt, and the gate's) and the elementwise chain on the
// FMA pipe are the rest. The way to a faster backward: one recompute pass
// instead of two.
//
// The pair tile (fwd_batch, pair_batch and their helpers) and the
// weight-gradient reduce are shared with K4 in gated_pair.cuh.

#include "gated_pair.cuh"

namespace {

constexpr int kChunk = 4;                     // rows per backward item

// Thread 0 takes the next item from the counter; every thread returns it.
__device__ __forceinline__ int next_item(int* counter, int* item_s) {
  if (threadIdx.x == 0) *item_s = atomicAdd(counter, 1);
  __syncthreads();
  return *item_s;
}

template <int A, typename T>
__global__ void __launch_bounds__(kThreads, kFwdBlocks)
gn_allpairs_fwd_kernel(const T* __restrict__ p_i, const T* __restrict__ p_j,
                       const uint8_t* __restrict__ mask, const int* __restrict__ row_lo,
                       const int* __restrict__ row_hi, const float* __restrict__ w2,
                       const float* __restrict__ b2, const float* __restrict__ wg,
                       const float* __restrict__ bgp, float* __restrict__ out,
                       int* __restrict__ counter, int rows, int n, int h2, int h) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* wmt = reinterpret_cast<uint4*>(smem);
  __shared__ float b2s[kH], wgs[kH];
  __shared__ float acc_s[kWarps][kH];
  __shared__ int item_s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, c = lane & 3;
  FwdTile& wt = reinterpret_cast<FwdTile*>(wmt + kFrag)[warp];
  load_weights<false>(w2, b2, wg, h2, h, wmt, nullptr, b2s, wgs);
  const float bg = *bgp;

  for (int row = next_item(counter, &item_s); row < rows;
       row = next_item(counter, &item_s)) {
    const int i = row % n;
    const float own = lane < h2 ? to_f32(p_i[(size_t)row * h2 + lane]) : 0.f;
    float acc[8][2] = {};
    BatchWalk walk(mask + (size_t)i * n, row_lo[i], row_hi[i], warp);
    for (int cnt = walk.fill(wt.idx); cnt > 0; cnt = walk.fill(wt.idx))
      fwd_batch<A, T>(wmt, b2s, wgs, bg, wt, cnt, p_j + (size_t)(row - i) * h2, own, h2,
                      acc);
    // each channel's sum over the thread rows g, then over the warps in order
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = acc[nt][e];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(kFull, v, o);
        if (lane < 4) acc_s[warp][nt * 8 + 2 * c + e] = v;
      }
    __syncthreads();
    if (threadIdx.x < h) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < kWarps; ++q) s += acc_s[q][threadIdx.x];
      out[(size_t)row * h + threadIdx.x] = s;
    }
  }
}

// The four warps' dsum of one row (or column), summed over the lanes of a
// channel and then over the warps in order, into out[0 .. h2).
__device__ __forceinline__ void item_total(float (&dsum)[4][2], float (*d_s)[kH2],
                                           float* __restrict__ out, int h2) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, c = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = dsum[nt][e];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(kFull, v, o);
      if (lane < 4) d_s[warp][nt * 8 + 2 * c + e] = v;
    }
  __syncthreads();
  if (threadIdx.x < h2) {
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) sum += d_s[q][threadIdx.x];
    out[threadIdx.x] = sum;
  }
  __syncthreads();  // d_s is rewritten by the next item
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
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* wmt = reinterpret_cast<uint4*>(smem);
  uint4* wdt = wmt + kFrag;
  __shared__ float b2s[kH], wgs[kH];
  __shared__ float d_s[kWarps][kH2];
  __shared__ int item_s;
  const int warp = threadIdx.x >> 5;
  WarpTile* tiles = reinterpret_cast<WarpTile*>(wdt + kFrag);
  WarpTile& wt = tiles[warp];
  float* wsum = reinterpret_cast<float*>(tiles + kWarps) + warp * kWSum;
  load_weights(w2, b2, wg, h2, h, wmt, wdt, b2s, wgs);
  const float bg = *bgp;
  const int chunks = (rows + kChunk - 1) / kChunk;

  for (int chunk = next_item(counter, &item_s); chunk < chunks;
       chunk = next_item(counter, &item_s)) {
    WGrad wgr;
    wgr.clear(wsum);

    for (int row = chunk * kChunk; row < min(rows, (chunk + 1) * kChunk); ++row) {
      const int i = row % n;
      float own[4][2], dsum[4][2] = {};
      own_row(p_i + (size_t)row * h2, h2, own);
      BatchWalk walk(mask + (size_t)i * n, row_lo[i], row_hi[i], warp);
      for (int cnt = walk.fill(wt.idx); cnt > 0; cnt = walk.fill(wt.idx))
        pair_batch<A, T, true>(wmt, wdt, b2s, wgs, bg, w2, wt, cnt,
                               p_j + (size_t)(row - i) * h2, own, ghat + (size_t)row * kH,
                               h2, h, dsum, wgr, wsum);
      item_total(dsum, d_s, dpi + (size_t)row * h2, h2);
    }
    wgr.write(wsum, part + ((size_t)chunk * kWarps + warp) * kPart);
  }
}

// Backward pass 2: d_pj, one source column an item, over the transposed mask.
// (Two blocks an SM as the floor: ptxas then takes the ~165 registers the
// pass needs instead of spilling at 128; shared memory allows three.)
template <int A, typename T>
__global__ void __launch_bounds__(kThreads, 2)
gn_allpairs_bwd_cols_kernel(const T* __restrict__ p_i, const T* __restrict__ p_j,
                            const uint8_t* __restrict__ mask_t,
                            const int* __restrict__ row_lo, const int* __restrict__ row_hi,
                            const int* __restrict__ col_lo, const int* __restrict__ col_hi,
                            const float* __restrict__ w2, const float* __restrict__ b2,
                            const float* __restrict__ wg, const float* __restrict__ bgp,
                            const float* __restrict__ ghat, float* __restrict__ dpj,
                            int* __restrict__ counter, int cols, int n, int h2, int h) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* wmt = reinterpret_cast<uint4*>(smem);
  uint4* wdt = wmt + kFrag;
  __shared__ float b2s[kH], wgs[kH];
  __shared__ float d_s[kWarps][kH2];
  __shared__ int item_s;
  const int warp = threadIdx.x >> 5;
  WarpTile& wt = reinterpret_cast<WarpTile*>(wdt + kFrag)[warp];
  load_weights(w2, b2, wg, h2, h, wmt, wdt, b2s, wgs);
  const float bg = *bgp;
  WGrad unused;

  for (int col = next_item(counter, &item_s); col < cols;
       col = next_item(counter, &item_s)) {
    const int j = col % n;
    const size_t base = (size_t)(col - j);  // this batch row's first node
    float own[4][2], dsum[4][2] = {};
    own_row(p_j + (size_t)col * h2, h2, own);
    // destinations i of column j whose window holds j
    BatchWalk walk(mask_t + (size_t)j * n, col_lo[j], col_hi[j], warp, row_lo, row_hi, j);
    for (int cnt = walk.fill(wt.idx); cnt > 0; cnt = walk.fill(wt.idx))
      pair_batch<A, T, false>(wmt, wdt, b2s, wgs, bg, w2, wt, cnt, p_i + base * h2, own,
                              ghat + base * kH, h2, h, dsum, unused, nullptr);
    item_total(dsum, d_s, dpj + (size_t)col * h2, h2);
  }
}

template <int A, typename T>
int blocks_for(int pass, int* blocks) {
  if (pass == 0) return occupancy(gn_allpairs_fwd_kernel<A, T>, kFwdSmem, blocks);
  if (pass == 1) return occupancy(gn_allpairs_bwd_rows_kernel<A, T>, kBwdRowsSmem, blocks);
  return occupancy(gn_allpairs_bwd_cols_kernel<A, T>, kBwdSmem, blocks);
}

template <int A, typename T>
int fwd(const void* p_i, const void* p_j, const void* mask, const void* row_lo,
        const void* row_hi, const void* w2, const void* b2, const void* wg, const void* bg,
        void* out, void* counter, int rows, int n, int h2, int h, int blocks,
        cudaStream_t stream) {
  const int err = allow_smem(gn_allpairs_fwd_kernel<A, T>, kFwdSmem);
  if (err != 0) return err;
  gn_allpairs_fwd_kernel<A, T><<<blocks, kThreads, kFwdSmem, stream>>>(
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
  int err = allow_smem(gn_allpairs_bwd_rows_kernel<A, T>, kBwdRowsSmem);
  if (err == 0) err = allow_smem(gn_allpairs_bwd_cols_kernel<A, T>, kBwdSmem);
  if (err != 0) return err;
  gn_allpairs_bwd_rows_kernel<A, T><<<blocks_rows, kThreads, kBwdRowsSmem, stream>>>(
      static_cast<const T*>(p_i), static_cast<const T*>(p_j),
      static_cast<const uint8_t*>(mask), static_cast<const int*>(row_lo),
      static_cast<const int*>(row_hi), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(wg),
      static_cast<const float*>(bg), static_cast<const float*>(ghat),
      static_cast<float*>(dpi), static_cast<float*>(part), cnt, rows, n, h2, h);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  gn_allpairs_bwd_cols_kernel<A, T><<<blocks_cols, kThreads, kBwdSmem, stream>>>(
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
  wgrad_reduce<<<(n_out + 31) / 32, dim3(32, kReduceRows), 0, stream>>>(
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
// rows within [col_lo[j], col_hi[j]) only) and ghat [rows, 64] f32 (rounded
// to the input dtype, columns past h zero): dpi, dpj [rows, h2] f32 and grads = [dw2 (h2*h),
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
