// K5 as it was before its redesign (arttts_tpu_torch/csrc/upsample1d.cu up
// to commit 8c824d0), kept for measurement only: scripts/upsample_variants.py
// builds it beside the current kernel and times both. The port never calls
// it.
//
// K5: leaky ReLU (0.1) + ConvTranspose1d with kernel 2 * stride, torch
// semantics, plus bias: (B, Cin, T) -> (B, Cout, T_out) float32, with
// T_out = (T - 1) * s - 2 * p + 2 * s + output_padding.
//
// Replaces the TPU kernel `_ups_kernel` behind `upsample_packed` in
// arttts_tpu/ops/upsample_pallas.py (HiFi-GAN's stride-2, k=4 upsamples,
// 128 -> 64 and 64 -> 32 channels). The TPU kernel works on 128-lane packed
// rows with a probed (3 * 128, 128) matrix; none of that is carried over.
// Here the taps are routed directly: output frame o, with u = o + p,
// q = u / s and r = u % s, reads exactly two input frames,
//
//     out[o] = bias + sum_ci w[ci][co][r] * X[q] + w[ci][co][r + s] * X[q - 1],
//
// X = lrelu(x), zero outside [0, T). Nothing of the input-dilated form's
// zeros is multiplied.
//
// What bounds it on the H100: per output element 2 * Cin multiply-adds
// against 4 bytes written and 4 * Cin / s read, so it is bound by
// operations on the CUDA cores, though only a few times above the ridge
// (0.05 ms of FLOP against 0.015 ms of bytes at 128 -> 64, T=49,152). The
// design keeps every input value and weight read once from device memory
// per block: a block stages a chunk of 16 input channels' X over its q
// range (plus one frame) and their weights in shared memory; each thread
// holds 8 output channels x 4 values of q x s phases (64 accumulators),
// channels uniform per warp so weights are broadcast reads, q 32 apart so
// the warp's X reads hit distinct banks.
#include "common.cuh"

namespace {

using arttts::ceil_div;
using arttts::kThreads;

constexpr float kSlope = 0.1f;
constexpr int kCiChunk = 16;
constexpr int kCoMax = 64;  // output channels per block (8 per warp, 4 or 8 warps)
constexpr int kQT = 4;      // values of q per thread, 32 apart

template <int S>
__global__ void __launch_bounds__(kThreads)
upsample_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ out, int Cin, int Cout,
                int T, int pad, int T_out, int q_lo, int warps_c) {
  constexpr int K = 2 * S;
  const int q_tile = (8 / warps_c) * 32 * kQT;  // q values per block
  const int co_tile = 8 * warps_c;
  __shared__ float xs[kCiChunk][2 * 32 * kQT + 1];  // q_tile <= 256
  __shared__ __align__(16) float ws[kCiChunk][K][kCoMax];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cg = warp % warps_c;
  const int lq = (warp / warps_c) * 32 * kQT + lane;  // local q of accumulator column 0
  const int qb = q_lo + blockIdx.x * q_tile;          // q of local column 0
  const int cb = blockIdx.y * co_tile;
  const int b = blockIdx.z;
  const float* xb = x + (size_t)b * Cin * T;

  float acc[8][kQT][S];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < kQT; ++j)
#pragma unroll
      for (int r = 0; r < S; ++r) acc[i][j][r] = 0.f;

  for (int ci0 = 0; ci0 < Cin; ci0 += kCiChunk) {
    // xs[ci][l] = X[qb - 1 + l], l in [0, q_tile]
    for (int i = threadIdx.x; i < kCiChunk * (q_tile + 1); i += kThreads) {
      const int ci = i / (q_tile + 1), l = i % (q_tile + 1);
      const int g = qb - 1 + l;
      float v = 0.f;
      if (ci0 + ci < Cin && g >= 0 && g < T) {
        v = xb[(size_t)(ci0 + ci) * T + g];
        v = v >= 0.f ? v : kSlope * v;
      }
      xs[ci][l] = v;
    }
    // ws[ci][tap][c] = w[ci0 + ci][cb + c][tap]; per ci the run is contiguous
    for (int i = threadIdx.x; i < kCiChunk * co_tile * K; i += kThreads) {
      const int ci = i / (co_tile * K), n = i % (co_tile * K);
      const int c = n / K, tap = n % K;
      const int gci = ci0 + ci, co = cb + c;
      ws[ci][tap][c] =
          (gci < Cin && co < Cout) ? w[((size_t)gci * Cout + co) * K + tap] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int ci = 0; ci < kCiChunk; ++ci) {
      float xq[kQT], xm[kQT];
#pragma unroll
      for (int j = 0; j < kQT; ++j) {
        xq[j] = xs[ci][lq + 32 * j + 1];
        xm[j] = xs[ci][lq + 32 * j];
      }
#pragma unroll
      for (int tap = 0; tap < K; ++tap) {
        const float4 wa = *reinterpret_cast<const float4*>(&ws[ci][tap][cg * 8]);
        const float4 wb = *reinterpret_cast<const float4*>(&ws[ci][tap][cg * 8 + 4]);
        const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
        // tap r < S reads X[q] into phase r; tap r + S reads X[q - 1]
        const int r = tap % S;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < kQT; ++j)
            acc[i][j][r] = fmaf(wv[i], tap < S ? xq[j] : xm[j], acc[i][j][r]);
      }
    }
    __syncthreads();
  }

  float* ob = out + (size_t)b * Cout * T_out;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int co = cb + cg * 8 + i;
    if (co >= Cout) continue;
    const float bv = bias[co];
#pragma unroll
    for (int j = 0; j < kQT; ++j) {
      const int q = qb + lq + 32 * j;
#pragma unroll
      for (int r = 0; r < S; ++r) {
        const int o = S * q + r - pad;
        if (o >= 0 && o < T_out) ob[(size_t)co * T_out + o] = acc[i][j][r] + bv;
      }
    }
  }
}

}  // namespace

// lrelu + ConvTranspose1d(kernel 2 * stride, stride, padding, output_padding)
// + bias; w in torch layout (Cin, Cout, 2 * stride). Takes stride 2 and Cout
// a multiple of 32.
extern "C" int upsample1d(const float* x, const float* w, const float* bias, float* out,
                          int B, int Cin, int Cout, int T, int stride, int pad,
                          int output_padding, void* stream) {
  if (stride != 2 || Cout % 32 != 0 || pad < 0) return (int)cudaErrorInvalidValue;
  const int T_out = (T - 1) * stride - 2 * pad + 2 * stride + output_padding;
  if (T_out <= 0) return (int)cudaErrorInvalidValue;
  const int warps_c = Cout >= kCoMax ? 8 : 4;
  const int q_tile = (8 / warps_c) * 32 * kQT;
  const int q_lo = pad / stride;
  const int q_hi = (T_out - 1 + pad) / stride;
  const dim3 grid(ceil_div(q_hi - q_lo + 1, q_tile), ceil_div(Cout, 8 * warps_c), B);
  upsample_kernel<2><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, w, bias, out, Cin, Cout, T, pad, T_out, q_lo, warps_c);
  ARTTTS_CHECK_LAUNCH();
  return 0;
}
