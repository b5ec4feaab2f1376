// Pieces shared by the port's tensor-core kernels (K1 in resblock2d.cu, K2
// and K3 in updown.cu, K4 in mrf.cu, K5 in upsample1d.cu): `cp.async`
// staging (K6 in mas.cu uses it too), the 3xTF32 split and the
// `mma.sync.m16n8k8` TF32 product, Hopper's `wgmma` TF32 product with both
// operands in shared memory and the `mbarrier`s that pace it (K1's float32
// 3x3 route), and two launch helpers.
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

// ---- Hopper's warpgroup product (`wgmma`, sm_90a) with both operands in
// shared memory. A warpgroup of 4 warps multiplies a 64 x 8 TF32 A by an
// 8 x 64 TF32 B into a 64 x 64 float32 accumulator (32 registers a thread:
// register 4j + 2h + e holds row 16w + g + 8h, column 8j + 2t + e, for warp
// w of the group and lane 4g + t). TF32 operands must be K-major: core
// matrices of 8 rows (m or n) x 16 bytes (4 k), no swizzle; `lbo` is the
// byte step between the two core matrices along k, `sbo` between those
// along m or n. An operand's start address is any 16-byte boundary.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

// d += a * b (a, b descriptors); `wgmma_fence` before the first product of a
// group, `wgmma_commit` after its last, `wgmma_wait<N>` before d is read
__device__ __forceinline__ void wgmma_m64n64k8(float (&d)[32], uint64_t a, uint64_t b) {
  // scale-d is a predicate (true: accumulate), then A's and B's signs
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "n"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N of this warpgroup's committed groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the accumulator where it is across this point: the compiler does not
// know that an in-flight `wgmma` writes it.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// This thread's shared-memory writes become visible to `wgmma`'s reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- mbarriers in shared memory: `count` arrivals complete a phase; a
// waiter names the parity of the phase it waits for (0, 1, 0, ...)
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
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
