// The helpers the hand-written kernels for Hopper (sm_90a) share: operands
// split for 3xTF32, the mma.sync m16n8k8 TF32 and m16n8k16 bf16 products,
// 16-byte cp.async copies, ldmatrix fragment loads, and the opt-in to
// dynamic shared memory above 48 KB. The block SpMM (bsr_spmm.cu, K1), the
// SDDMM (sddmm.cu, K2) and the GatedGN pair tile (gated_pair.cuh, K3 and K4)
// include it; those files define constants of the same names, so none can
// include another.
//
// Everything here sits in an anonymous namespace: each source that includes
// it gets its own copy.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// x rounded to TF32 (10 mantissa bits), as the bits of an f32
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

// x = hi + lo, both exact in TF32, to about 2^-22 of x: 3xTF32 operands
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// tf32() and split() in integer arithmetic, two integer instructions a
// rounding: adding half of the 13 dropped bits, then clearing them, rounds
// the magnitude to nearest with ties away from zero, as cvt.rna does, for
// every finite x that does not round past the largest float
__device__ __forceinline__ uint32_t tf32_int(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_int(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_int(x);
  lo = tf32_int(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b: a_hi b_hi + a_hi b_lo + a_lo b_hi, the small terms first; an
// exact operand has no lo, and its terms are left out
template <bool kAExact, bool kBExact>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                     uint32_t bl0, uint32_t bl1) {
  if (!kBExact) mma(d, ah, bl0, bl1);
  if (!kAExact) mma(d, al, bh0, bh1);
  mma(d, ah, bh0, bh1);
}

// 16-byte asynchronous copies global -> shared (cp.async.cg): src_bytes of
// the 16 are read and the rest of the destination is zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d += a b on bf16 operands, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Lets a kernel take `smem` bytes of dynamic shared memory (above 48 KB it
// must be asked for); a no-op for 0.
template <typename K>
int allow_smem(K kernel, int smem) {
  if (smem > 0)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
