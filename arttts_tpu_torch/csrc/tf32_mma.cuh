// Pieces shared by the port's tensor-core kernels (K1 in resblock2d.cu, K2
// and K3 in updown.cu, K4 in mrf.cu, K5 in upsample1d.cu): `cp.async`
// staging (K6 in mas.cu uses it too), the 3xTF32 split and the
// `mma.sync.m16n8k8` TF32 product, and two launch helpers.
//
// 3xTF32 (CUTLASS's name): each operand a is split as a_hi = tf32(a)
// (cvt.rna: round to nearest, ties away) and a_lo = a - a_hi (which the
// tensor core reads truncated to TF32), and every product is
// a_lo*b_hi + a_hi*b_lo + a_hi*b_hi with float32 accumulation; the dropped
// a_lo*b_lo term is about 2^-22 of a*b. One TF32 pass (2^-11) misses the
// port's 1e-4 tolerance at the U-Net's depths of K (tests/test_torch_kernels.py
// shows both on the CPU).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace arttts {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4-byte copy; `valid` false writes a zero (src-size 0, nothing is read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// 16-byte copy; `valid` false writes zeros (src-size 0)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo: hi = tf32(x), lo = x - hi exactly (a float32). The tensor
// core reads the top 19 bits of a TF32 operand's register, so lo enters the
// product truncated to TF32: hi + lo then holds x to 2^-21 relative.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// Fragments of m16n8k8 (PTX ISA), lane = 4*g + t: A a0 (g, t), a1 (g+8, t),
// a2 (g, t+4), a3 (g+8, t+4); B b0 (k=t, n=g), b1 (t+4, g); C c0 (g, 2t),
// c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[n] += a*b[n] over n tiles in 3xTF32: the small terms first, the large
// one last; pass-major, so consecutive mma's write different accumulators
template <int N>
__device__ __forceinline__ void mma3(float (&acc)[N][4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[N][2],
                                     const uint32_t (&bl)[N][2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(acc[n], al, bh[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(acc[n], ah, bl[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(acc[n], ah, bh[n]);
}

// Let `kernel` take `bytes` of dynamic shared memory (above 48 KB needs it).
template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

// the card's SM count (or minus a CUDA error code), read once
inline int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return e == cudaSuccess ? v : -(int)e;
  }();
  return n;
}

}  // namespace arttts
