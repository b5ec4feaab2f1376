// Pieces of the bf16 mode of the port's tensor-core kernels (K1 in
// resblock2d.cu, K2 and K3 in updown.cu, K4 in mrf.cu): the
// `mma.sync.m16n8k16` bf16 product with float32 accumulation, and the
// rounding of float32 operands to bf16 pairs.
//
// The mode computes the function of the JAX package's bf16 TPU kernels
// (`bf16=True` in arttts_tpu/ops/resblock2d_pallas.py, updown_pallas.py and
// mrf_pallas.py): each operand of a product is rounded to bf16 to nearest,
// ties to even (as `astype(jnp.bfloat16)` rounds), every product is summed
// in float32, and biases, statistics and activations stay float32. Inputs
// and outputs stay float32 in device memory and are rounded as the
// fragments are built, so the float32 staging of each kernel serves both
// modes.
//
// One k16 step covers 8 input channels at two taps: K index 2t + e of the
// fragments (PTX ISA, m16n8k16 .bf16: lane = 4 g + t holds K 2t, 2t+1 in
// its first register and 2t+8, 2t+9 in its second, for A and B alike) is
// channel t at tap e of the pair, 2t + 8 + e channel t + 4. That is what a
// 3xTF32 k8 step reads for two consecutive taps, so the kernels keep their
// shared-memory layouts and address arithmetic. A tap count that is odd
// pads its last pair with zeros on both operands.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace arttts {

// {lo, hi} rounded to bf16 (to nearest, ties to even) in one register: lo
// in the low half, the lower K index of the fragment's pair
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x rounded to bf16 and back (the attention core's rounding points)
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Fragments of m16n8k16 .bf16 (PTX ISA), lane = 4 g + t: A a0 (g, 2t..2t+1),
// a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..); B b0 (k = 2t..2t+1,
// n = g), b1 (k = 2t+8.., n = g); C as m16n8k8: c0 (g, 2t), c1 (g, 2t+1),
// c2 (g+8, 2t), c3 (g+8, 2t+1).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace arttts
