// K2 and K3: the stride-2 convolutions at the U-Net's resolution boundaries.
//
// K2 `downsample3x3s2` replaces the TPU kernels `_down_kernel`
// (downsample2d_to_real64, C=64) and `_down_wide_kernel` (downsample2d_wide,
// C=128) of arttts_tpu/ops/updown_pallas.py: Downsample2d, a 3x3 conv with
// stride 2 and zero padding 1, plus bias, on the masked input.
//
// K3 `convt4x4s2` replaces `_convt_wide_kernel` (conv_transpose2d_wide,
// C=128) and `_convt_kernel` (conv_transpose2d_from_real64, C=64):
// ConvTranspose2d with a 4x4 kernel, stride 2, padding 1, in torch
// semantics (out[oy] gathers x[iy] * w[ky] where oy = 2*iy - 1 + ky), plus
// bias, on the masked input. The weight is in torch layout (in, out, kh, kw).
//
// Layout: (B, C, H, T) float32; frames t >= lengths[b] of the input read as
// zero (lengths at the input's resolution).
//
// What bounds them on the H100: the multiply-adds, on the CUDA cores in
// float32 (2*9*Cin per output element for K2, 2*4*Cin for K3, against
// 8 bytes of input and output per element); both are compute-bound. The
// design is that of K1's convolution: a block computes a 64-channel x
// 8-row x 32-column output tile, 8 channels x 8 columns per thread, with the
// input window and the weights staged in shared memory, so every loaded
// value feeds 8 multiply-adds. K3 evaluates only the 4 taps of the 16 that
// reach each output (the parities of oy + 1 and ox + 1 pick them), so it
// never multiplies the zeros an input-dilated formulation would insert.
#include "common.cuh"

namespace {

using arttts::ceil_div;
using arttts::kThreads;

constexpr int kCoTile = 64;
constexpr int kRows = 8;
constexpr int kCols = 32;

// Grid: (output tiles, Cout / 64, B); output (Ho, To) = (ceil(H/2), ceil(T/2)).
constexpr int kDownCi = 4;
constexpr int kDownInRows = 2 * kRows + 1;  // 17 input rows per 8 output rows
constexpr int kDownInCols = 2 * kCols + 2;  // 65 input columns, padded to 66

__global__ void __launch_bounds__(kThreads)
downsample_kernel(const float* __restrict__ x, const int* __restrict__ lengths,
                  const float* __restrict__ w, const float* __restrict__ bias,
                  float* __restrict__ out, int Cin, int Cout, int H, int T, int Ho,
                  int To) {
  __shared__ float in_s[kDownCi][kDownInRows][kDownInCols];
  __shared__ __align__(16) float w_s[kDownCi][9][kCoTile];
  const int tid = threadIdx.x;
  const int cog = tid / 32;
  const int pg = tid % 32;
  const int r = pg / 4;
  const int cq = (pg % 4) * 8;
  const int tiles_t = ceil_div(To, kCols);
  const int oy0 = (blockIdx.x / tiles_t) * kRows;
  const int ox0 = (blockIdx.x % tiles_t) * kCols;
  const int co0 = blockIdx.y * kCoTile;
  const int b = blockIdx.z;
  const int len = lengths[b];
  const int iy0 = 2 * oy0 - 1, ix0 = 2 * ox0 - 1;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int ci0 = 0; ci0 < Cin; ci0 += kDownCi) {
    constexpr int kPlane = kDownInRows * kDownInCols;
    for (int i = tid; i < kDownCi * kPlane; i += kThreads) {
      const int ci = i / kPlane;
      const int rr = (i % kPlane) / kDownInCols;
      const int cc = (i % kPlane) % kDownInCols;
      const int gci = ci0 + ci, row = iy0 + rr, t = ix0 + cc;
      float v = 0.f;
      if (gci < Cin && row >= 0 && row < H && t >= 0 && t < T && t < len)
        v = x[((size_t)(b * Cin + gci) * H + row) * T + t];
      in_s[ci][rr][cc] = v;
    }
    for (int i = tid; i < kDownCi * 9 * kCoTile; i += kThreads) {
      const int co = i % kCoTile;
      const int k = (i / kCoTile) % 9;
      const int ci = i / (kCoTile * 9);
      const int gci = ci0 + ci;
      w_s[ci][k][co] = gci < Cin ? w[((size_t)(co0 + co) * Cin + gci) * 9 + k] : 0.f;
    }
    __syncthreads();
    for (int ci = 0; ci < kDownCi; ++ci) {
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
        float xin[17];
#pragma unroll
        for (int j = 0; j < 17; ++j) xin[j] = in_s[ci][2 * r + kh][2 * cq + j];
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const float4 wa = *reinterpret_cast<const float4*>(&w_s[ci][kh * 3 + kw][cog * 8]);
          const float4 wb = *reinterpret_cast<const float4*>(&w_s[ci][kh * 3 + kw][cog * 8 + 4]);
          const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(wv[i], xin[2 * j + kw], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }
  const int oy = oy0 + r;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int co = co0 + cog * 8 + i;
    const float bv = bias[co];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ox = ox0 + cq + j;
      if (oy < Ho && ox < To) out[((size_t)(b * Cout + co) * Ho + oy) * To + ox] = acc[i][j] + bv;
    }
  }
}

// Grid: (output tiles, Cout / 64, B); output (2H, 2T). Output tile origins
// are even, so a tile of 8 x 32 outputs reads the input rows
// oy0/2 - 1 .. oy0/2 + 4 and columns ox0/2 - 1 .. ox0/2 + 16.
constexpr int kUpCi = 8;
constexpr int kUpInRows = kRows / 2 + 2;
constexpr int kUpInCols = kCols / 2 + 2;

__global__ void __launch_bounds__(kThreads)
convt_kernel(const float* __restrict__ x, const int* __restrict__ lengths,
             const float* __restrict__ w, const float* __restrict__ bias,
             float* __restrict__ out, int Cin, int Cout, int H, int T) {
  __shared__ float in_s[kUpCi][kUpInRows][kUpInCols];
  __shared__ __align__(16) float w_s[kUpCi][16][kCoTile];
  const int tid = threadIdx.x;
  const int cog = tid / 32;
  const int pg = tid % 32;
  const int r = pg / 4;
  const int cq = (pg % 4) * 8;
  const int Ho = 2 * H, To = 2 * T;
  const int tiles_t = ceil_div(To, kCols);
  const int oy0 = (blockIdx.x / tiles_t) * kRows;
  const int ox0 = (blockIdx.x % tiles_t) * kCols;
  const int co0 = blockIdx.y * kCoTile;
  const int b = blockIdx.z;
  const int len = lengths[b];
  const int iy0 = oy0 / 2 - 1, ix0 = ox0 / 2 - 1;

  // the two kernel rows reaching output row oy: ky = py and py + 2 with
  // py = (oy + 1) % 2, from input row (oy + 1 - ky) / 2
  const int oy = oy0 + r;
  const int py = (oy + 1) & 1;
  const int base = cq / 2;  // local input column of output column cq's kx=3 tap

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int ci0 = 0; ci0 < Cin; ci0 += kUpCi) {
    constexpr int kPlane = kUpInRows * kUpInCols;
    for (int i = tid; i < kUpCi * kPlane; i += kThreads) {
      const int ci = i / kPlane;
      const int rr = (i % kPlane) / kUpInCols;
      const int cc = (i % kPlane) % kUpInCols;
      const int gci = ci0 + ci, row = iy0 + rr, t = ix0 + cc;
      float v = 0.f;
      if (gci < Cin && row >= 0 && row < H && t >= 0 && t < T && t < len)
        v = x[((size_t)(b * Cin + gci) * H + row) * T + t];
      in_s[ci][rr][cc] = v;
    }
    for (int i = tid; i < kUpCi * 16 * kCoTile; i += kThreads) {
      const int co = i % kCoTile;
      const int k = (i / kCoTile) % 16;
      const int ci = i / (kCoTile * 16);
      const int gci = ci0 + ci;
      w_s[ci][k][co] = gci < Cin ? w[((size_t)gci * Cout + co0 + co) * 16 + k] : 0.f;
    }
    __syncthreads();
    for (int ci = 0; ci < kUpCi; ++ci) {
#pragma unroll
      for (int tap = 0; tap < 2; ++tap) {
        const int ky = py + 2 * tap;
        const int iy_local = (oy + 1 - ky) / 2 - iy0;
        float xin[6];
#pragma unroll
        for (int j = 0; j < 6; ++j) xin[j] = in_s[ci][iy_local][base + j];
#pragma unroll
        for (int kx = 0; kx < 4; ++kx) {
          const float4 wa = *reinterpret_cast<const float4*>(&w_s[ci][ky * 4 + kx][cog * 8]);
          const float4 wb = *reinterpret_cast<const float4*>(&w_s[ci][ky * 4 + kx][cog * 8 + 4]);
          const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
          // output column cq + j (even j = 2m: kx 1 and 3; odd j = 2m + 1:
          // kx 0 and 2), input column (ox + 1 - kx) / 2
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int j = (kx & 1) ? 2 * m : 2 * m + 1;
            const float xv = xin[m + (kx == 0 ? 2 : kx == 3 ? 0 : 1)];
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[i][j] = fmaf(wv[i], xv, acc[i][j]);
          }
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int co = co0 + cog * 8 + i;
    const float bv = bias[co];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ox = ox0 + cq + j;
      if (oy < Ho && ox < To) out[((size_t)(b * Cout + co) * Ho + oy) * To + ox] = acc[i][j] + bv;
    }
  }
}

}  // namespace

extern "C" int downsample3x3s2(const float* x, const int* lengths, const float* w,
                               const float* bias, float* out, int B, int Cin, int Cout,
                               int H, int T, void* stream) {
  const int Ho = (H + 1) / 2, To = (T + 1) / 2;
  const dim3 grid(ceil_div(Ho, kRows) * ceil_div(To, kCols), Cout / kCoTile, B);
  downsample_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(x, lengths, w, bias, out,
                                                                  Cin, Cout, H, T, Ho, To);
  ARTTTS_CHECK_LAUNCH();
  return 0;
}

extern "C" int convt4x4s2(const float* x, const int* lengths, const float* w,
                          const float* bias, float* out, int B, int Cin, int Cout, int H,
                          int T, void* stream) {
  const dim3 grid(ceil_div(2 * H, kRows) * ceil_div(2 * T, kCols), Cout / kCoTile, B);
  convt_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(x, lengths, w, bias, out, Cin,
                                                             Cout, H, T);
  ARTTTS_CHECK_LAUNCH();
  return 0;
}
