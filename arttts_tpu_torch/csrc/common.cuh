// Shared helpers of the port's hand-written Hopper kernels.
//
// Every kernel computes to float32 accuracy: on the CUDA cores, or (K1's
// products in resblock2d.cu, K2 and K3 in updown.cu, K4's in mrf.cu, K5's
// in upsample1d.cu) on the tensor cores in 3xTF32 (tf32_mma.cuh). Launchers are
// `extern "C"` functions with a plain C interface (bound from Python with
// ctypes): device pointers, sizes and the caller's stream in, a CUDA error
// code out (0 on success), checked right after each launch.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace arttts {

constexpr int kThreads = 256;  // every kernel of the port runs 256-thread blocks

__device__ __forceinline__ float mish(float x) {
  // x * tanh(softplus(x)); softplus in the overflow-free form
  // max(x, 0) + log1p(exp(-|x|)), as jax.nn.softplus computes it
  const float sp = fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
  return x * tanhf(sp);
}

__host__ __device__ __forceinline__ int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

}  // namespace arttts

// Return the launch's error code from the enclosing launcher if it failed.
#define ARTTTS_CHECK_LAUNCH()                        \
  do {                                               \
    const cudaError_t err_ = cudaGetLastError();     \
    if (err_ != cudaSuccess) return (int)err_;       \
  } while (0)

// Each source file builds into a library of its own, so every library
// carries its own copy of this lookup.
extern "C" const char* arttts_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
