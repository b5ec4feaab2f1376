// K1: one whole U-Net ResnetBlock2d, with Rezero(LinearAttention2d) fused
// behind it where the block has one.
//
// Replaces the TPU kernel `_resblock_kernel` of
// arttts_tpu/ops/resblock2d_pallas.py, reached through `resblock2d_packed`
// (C=64, full resolution) and `resblock2d_wide` (C=128/256 and the real64
// variant). Semantics are those of models/unet2d.py ResnetBlock2d:
//   h1 = conv3x3(x*m) + b1          -> GroupNorm(8) -> mish -> *m -> +temb -> *m
//   h2 = conv3x3(.)  + b2           -> GroupNorm(8) -> mish -> *m
//   y  = h2 + (x*m  or  W_res (x*m) + b_res)
//   y += g * (W_o (q ctx) + b_o)     (attention, 4 heads of 32)
// GroupNorm statistics either exclude padded frames (masked) or cover every
// frame of the image (unmasked, as flax nn.GroupNorm does), per the caller.
//
// Layout: images are (B, C, H, T) float32, H = feature rows, T = frames; an
// input may arrive as two channel chunks, so the skip concatenation of the
// U-Net's up path is never materialised.
//
// What bounds it on the H100: the two 3x3 convolutions, ~99% of the block's
// operations (2*9*Cin*Cout per output element); float32 on the CUDA cores
// (67 TFLOP/s) makes the block compute-bound at every level. The design
// keeps the convolution's operands in shared memory and registers: a block
// computes a 64-channel x 8-row x 32-frame output tile, 8 channels x 8
// frames per thread, so each input value loaded from shared memory feeds 8
// multiply-adds and each weight 8. GroupNorm needs statistics over the whole
// image before any element can be normalised; the conv kernel writes one
// partial (sum, sum of squares) per tile and group, and a second small kernel
// reduces them in a fixed order in double precision. No float atomics, so
// the result is the same on every run.
#include "common.cuh"

namespace {

using arttts::ceil_div;
using arttts::kThreads;
using arttts::mish;

constexpr int kCoTile = 64;   // output channels per block
constexpr int kRows = 8;      // output rows per block
constexpr int kCols = 32;     // output frames per block
constexpr int kCiStep = 8;    // input channels staged per shared-memory round
constexpr int kGroups = 8;    // GroupNorm groups (the U-Net's `groups`)

// Input channel `ci` of a two-chunk image at (b, row, frame): chunk 0 holds
// channels [0, c0), chunk 1 channels [c0, c0 + c1).
__device__ __forceinline__ float load_chunked(const float* __restrict__ x0, int c0,
                                              const float* __restrict__ x1, int c1,
                                              int b, int ci, int row, int t, int H,
                                              int T) {
  if (ci < c0) return x0[((size_t)(b * c0 + ci) * H + row) * T + t];
  return x1[((size_t)(b * c1 + ci - c0) * H + row) * T + t];
}

// 3x3 convolution, stride 1, zero padding 1, on the masked input (frames
// t >= lengths[b] read as zero), plus bias. Writes the raw output and one
// (sum, sum of squares) partial per (batch, 8-channel slot, spatial tile).
// Grid: (spatial tiles, Cout / 64, B).
__global__ void __launch_bounds__(kThreads)
conv3x3_stats_kernel(const float* __restrict__ x0, int c0, const float* __restrict__ x1,
                     int c1, const int* __restrict__ lengths, const float* __restrict__ w,
                     const float* __restrict__ bias, float* __restrict__ out,
                     float* __restrict__ partial, int H, int T, int Cout,
                     int masked_stats) {
  __shared__ float in_s[kCiStep][kRows + 2][kCols + 2];
  __shared__ __align__(16) float w_s[kCiStep][9][kCoTile];
  __shared__ float red_s[kThreads][2];

  const int tid = threadIdx.x;
  const int cog = tid / 32;        // this thread's 8 output channels: cog*8 ..
  const int pg = tid % 32;
  const int r = pg / 4;            // output row within the tile
  const int cq = (pg % 4) * 8;     // first of 8 output frames within the tile
  const int tiles_t = ceil_div(T, kCols);
  const int h0 = (blockIdx.x / tiles_t) * kRows;
  const int t0 = (blockIdx.x % tiles_t) * kCols;
  const int co0 = blockIdx.y * kCoTile;
  const int b = blockIdx.z;
  const int len = lengths[b];
  const int Cin = c0 + c1;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int ci0 = 0; ci0 < Cin; ci0 += kCiStep) {
    constexpr int kPlane = (kRows + 2) * (kCols + 2);
    for (int i = tid; i < kCiStep * kPlane; i += kThreads) {
      const int ci = i / kPlane;
      const int rr = (i % kPlane) / (kCols + 2);
      const int cc = (i % kPlane) % (kCols + 2);
      const int gci = ci0 + ci, row = h0 - 1 + rr, t = t0 - 1 + cc;
      float v = 0.f;
      if (gci < Cin && row >= 0 && row < H && t >= 0 && t < T && t < len)
        v = load_chunked(x0, c0, x1, c1, b, gci, row, t, H, T);
      in_s[ci][rr][cc] = v;
    }
    for (int i = tid; i < kCiStep * 9 * kCoTile; i += kThreads) {
      const int co = i % kCoTile;
      const int k = (i / kCoTile) % 9;
      const int ci = i / (kCoTile * 9);
      const int gci = ci0 + ci;
      w_s[ci][k][co] = gci < Cin ? w[((size_t)(co0 + co) * Cin + gci) * 9 + k] : 0.f;
    }
    __syncthreads();
    for (int ci = 0; ci < kCiStep; ++ci) {
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
        float xin[10];
#pragma unroll
        for (int j = 0; j < 10; ++j) xin[j] = in_s[ci][r + kh][cq + j];
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const float4 wa = *reinterpret_cast<const float4*>(&w_s[ci][kh * 3 + kw][cog * 8]);
          const float4 wb = *reinterpret_cast<const float4*>(&w_s[ci][kh * 3 + kw][cog * 8 + 4]);
          const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(wv[i], xin[j + kw], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

  // epilogue: bias, store, and this thread's share of the group statistics
  // (its 8 channels lie in one group: group widths are multiples of 8)
  float s1 = 0.f, s2 = 0.f;
  const int row = h0 + r;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int co = co0 + cog * 8 + i;
    const float bv = bias[co];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int t = t0 + cq + j;
      if (row < H && t < T) {
        const float v = acc[i][j] + bv;
        out[((size_t)(b * Cout + co) * H + row) * T + t] = v;
        if (!masked_stats || t < len) {
          s1 += v;
          s2 += v * v;
        }
      }
    }
  }
  red_s[tid][0] = s1;
  red_s[tid][1] = s2;
  __syncthreads();
  if (pg == 0) {
    float a = 0.f, q = 0.f;
    for (int k = 0; k < 32; ++k) {
      a += red_s[tid + k][0];
      q += red_s[tid + k][1];
    }
    const int slot = blockIdx.y * (kCoTile / 8) + cog;
    float* dst = partial + (((size_t)b * (Cout / 8) + slot) * gridDim.x + blockIdx.x) * 2;
    dst[0] = a;
    dst[1] = q;
  }
}

// Per (group, batch): reduce the conv's partials in a fixed order (double
// precision) into the mean and 1/sqrt(var + eps). Grid: (8, B).
__global__ void __launch_bounds__(kThreads)
gn_stats_kernel(const float* __restrict__ partial, const int* __restrict__ lengths,
                float* __restrict__ stats, int Cout, int n_tiles, int H, int T,
                int masked_stats, float eps) {
  __shared__ double red_s[kThreads][2];
  const int g = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int slots = Cout / 8 / kGroups;  // 8-channel slots per group
  const float* src = partial + ((size_t)b * (Cout / 8) + g * slots) * n_tiles * 2;
  double a = 0.0, q = 0.0;
  for (int i = tid; i < slots * n_tiles; i += kThreads) {
    a += src[2 * i];
    q += src[2 * i + 1];
  }
  red_s[tid][0] = a;
  red_s[tid][1] = q;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s /= 2) {
    if (tid < s) {
      red_s[tid][0] += red_s[tid + s][0];
      red_s[tid][1] += red_s[tid + s][1];
    }
    __syncthreads();
  }
  if (tid == 0) {
    const int frames = masked_stats ? min(lengths[b], T) : T;
    const double count = (double)(Cout / kGroups) * H * frames;
    const double mean = red_s[0][0] / count;
    const double var = fmax(red_s[0][1] / count - mean * mean, 0.0);
    stats[(b * kGroups + g) * 2] = (float)mean;
    stats[(b * kGroups + g) * 2 + 1] = (float)(1.0 / sqrt(var + (double)eps));
  }
}

// out = mish(GroupNorm(h)) [+ temb[b, c]] * m [+ res * (m if res_masked)].
__global__ void __launch_bounds__(kThreads)
gn_act_kernel(const float* __restrict__ h, const float* __restrict__ stats,
              const float* __restrict__ gamma, const float* __restrict__ beta,
              const float* __restrict__ temb, const float* __restrict__ res,
              int res_masked, const int* __restrict__ lengths, float* __restrict__ out,
              int B, int C, int H, int T) {
  const size_t n = (size_t)B * C * H * T;
  for (size_t i = blockIdx.x * (size_t)kThreads + threadIdx.x; i < n;
       i += (size_t)gridDim.x * kThreads) {
    const int t = (int)(i % T);
    const int c = (int)((i / ((size_t)H * T)) % C);
    const int b = (int)(i / ((size_t)C * H * T));
    const int g = c / (C / kGroups);
    const float mean = stats[(b * kGroups + g) * 2];
    const float rstd = stats[(b * kGroups + g) * 2 + 1];
    const float m = t < lengths[b] ? 1.f : 0.f;
    float v = mish((h[i] - mean) * rstd * gamma[c] + beta[c]);
    if (temb != nullptr) v += temb[b * C + c];
    v *= m;
    if (res != nullptr) v += res_masked ? res[i] * m : res[i];
    out[i] = v;
  }
}

// 1x1 convolution as a tiled product over channels, per batch:
//   acc[b, co, p] = sum_ci w[co, ci] * x[b, ci, p]   (x from two chunks,
//   masked to frames t < lengths[b] when `lengths` is given)
//   out = acc + bias                       (resid == nullptr)
//   out = resid + gain[0] * (acc + bias)   (Rezero epilogue)
// Grid: (ceil(P / 128), Cout / 64, B), P = H*T.
constexpr int kPwP = 128;
constexpr int kPwK = 16;

__global__ void __launch_bounds__(kThreads)
pointwise_kernel(const float* __restrict__ x0, int c0, const float* __restrict__ x1, int c1,
                 const int* __restrict__ lengths, const float* __restrict__ w,
                 const float* __restrict__ bias, const float* __restrict__ resid,
                 const float* __restrict__ gain, float* __restrict__ out, int Cout,
                 int P, int T) {
  __shared__ __align__(16) float w_s[kPwK][kCoTile];
  __shared__ __align__(16) float x_s[kPwK][kPwP];
  const int tid = threadIdx.x;
  const int cog = tid / 32;
  const int pq = (tid % 32) * 4;
  const int p0 = blockIdx.x * kPwP;
  const int co0 = blockIdx.y * kCoTile;
  const int b = blockIdx.z;
  const int Cin = c0 + c1;
  const int len = lengths != nullptr ? lengths[b] : T;

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int ci0 = 0; ci0 < Cin; ci0 += kPwK) {
    for (int i = tid; i < kPwK * kCoTile; i += kThreads) {
      const int co = i % kCoTile, k = i / kCoTile;
      const int gci = ci0 + k;
      w_s[k][co] = gci < Cin ? w[(size_t)(co0 + co) * Cin + gci] : 0.f;
    }
    for (int i = tid; i < kPwK * kPwP; i += kThreads) {
      const int p = i % kPwP, k = i / kPwP;
      const int gci = ci0 + k, gp = p0 + p;
      float v = 0.f;
      if (gci < Cin && gp < P && gp % T < len) {
        v = gci < c0 ? x0[((size_t)b * c0 + gci) * P + gp]
                     : x1[((size_t)b * c1 + gci - c0) * P + gp];
      }
      x_s[k][p] = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPwK; ++k) {
      const float4 wa = *reinterpret_cast<const float4*>(&w_s[k][cog * 8]);
      const float4 wb = *reinterpret_cast<const float4*>(&w_s[k][cog * 8 + 4]);
      const float4 xv4 = *reinterpret_cast<const float4*>(&x_s[k][pq]);
      const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
      const float xv[4] = {xv4.x, xv4.y, xv4.z, xv4.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(wv[i], xv[j], acc[i][j]);
    }
    __syncthreads();
  }
  const float g = resid != nullptr ? gain[0] : 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int co = co0 + cog * 8 + i;
    const float bv = bias != nullptr ? bias[co] : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = p0 + pq + j;
      if (p < P) {
        const size_t o = ((size_t)b * Cout + co) * P + p;
        const float v = acc[i][j] + bv;
        out[o] = resid != nullptr ? resid[o] + g * v : v;
      }
    }
  }
}

// ---- Rezero(LinearAttention2d): 4 heads x 32, softmax of k over all H*T ----
// qkv is (B, 384, P): q = channels [0, 128), k = [128, 256), v = [256, 384);
// channel head*32 + d. Positions are split into chunks of kChunk.
constexpr int kHd = 128;
constexpr int kDh = 32;
constexpr int kChunk = 512;

// Per (chunk, k channel, batch): the chunk's max of k and sum of exp(k - max).
__global__ void __launch_bounds__(kThreads)
attn_kstats_kernel(const float* __restrict__ qkv, float* __restrict__ kpart, int P) {
  __shared__ float red_s[kThreads];
  const int c = blockIdx.x, d = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int n_chunks = gridDim.x;
  const float* k = qkv + ((size_t)b * 3 * kHd + kHd + d) * P;
  const int p0 = c * kChunk, p1 = min(p0 + kChunk, P);
  float m = -INFINITY;
  for (int p = p0 + tid; p < p1; p += kThreads) m = fmaxf(m, k[p]);
  red_s[tid] = m;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s /= 2) {
    if (tid < s) red_s[tid] = fmaxf(red_s[tid], red_s[tid + s]);
    __syncthreads();
  }
  m = red_s[0];
  __syncthreads();
  float e = 0.f;
  for (int p = p0 + tid; p < p1; p += kThreads) e += expf(k[p] - m);
  red_s[tid] = e;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s /= 2) {
    if (tid < s) red_s[tid] += red_s[tid + s];
    __syncthreads();
  }
  if (tid == 0) {
    float* dst = kpart + (((size_t)b * kHd + d) * n_chunks + c) * 2;
    dst[0] = m;
    dst[1] = red_s[0];
  }
}

// Per (chunk, head, batch): partial context
//   cpart[d, e] = sum_{p in chunk} exp(k[d, p] - M[d]) * v[e, p]
// with M[d] the global max of k row d (from the chunk maxima).
constexpr int kCtxSub = 64;

__global__ void __launch_bounds__(kThreads)
attn_ctx_partial_kernel(const float* __restrict__ qkv, const float* __restrict__ kpart,
                        float* __restrict__ cpart, int P) {
  __shared__ float m_s[kDh];
  __shared__ float ke_s[kDh][kCtxSub + 1];
  __shared__ float v_s[kDh][kCtxSub + 1];
  const int c = blockIdx.x, hh = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int n_chunks = gridDim.x;
  if (tid < kDh) {
    const float* src = kpart + ((size_t)b * kHd + hh * kDh + tid) * n_chunks * 2;
    float m = -INFINITY;
    for (int i = 0; i < n_chunks; ++i) m = fmaxf(m, src[2 * i]);
    m_s[tid] = m;
  }
  __syncthreads();
  const float* k = qkv + ((size_t)b * 3 * kHd + kHd + hh * kDh) * P;
  const float* v = qkv + ((size_t)b * 3 * kHd + 2 * kHd + hh * kDh) * P;
  const int d = tid / 8, e4 = (tid % 8) * 4;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const int p_end = min((c + 1) * kChunk, P);
  for (int p0 = c * kChunk; p0 < p_end; p0 += kCtxSub) {
    for (int i = tid; i < kDh * kCtxSub; i += kThreads) {
      const int row = i / kCtxSub, p = i % kCtxSub, gp = p0 + p;
      const bool in = gp < p_end;
      ke_s[row][p] = in ? expf(k[(size_t)row * P + gp] - m_s[row]) : 0.f;
      v_s[row][p] = in ? v[(size_t)row * P + gp] : 0.f;
    }
    __syncthreads();
    for (int p = 0; p < kCtxSub; ++p) {
      const float kv = ke_s[d][p];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = fmaf(kv, v_s[e4 + j][p], acc[j]);
    }
    __syncthreads();
  }
  float* dst = cpart + ((((size_t)b * 4 + hh) * n_chunks + c) * kDh + d) * kDh + e4;
#pragma unroll
  for (int j = 0; j < 4; ++j) dst[j] = acc[j];
}

// Per (head, batch): ctx[d, e] = sum over chunks of cpart / S[d], with
// S[d] = sum_c s_c * exp(m_c - M[d]) the softmax denominator.
__global__ void __launch_bounds__(kThreads)
attn_ctx_final_kernel(const float* __restrict__ kpart, const float* __restrict__ cpart,
                      float* __restrict__ ctx, int n_chunks) {
  __shared__ float s_s[kDh];
  const int hh = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  if (tid < kDh) {
    const float* src = kpart + ((size_t)b * kHd + hh * kDh + tid) * n_chunks * 2;
    float m = -INFINITY;
    for (int i = 0; i < n_chunks; ++i) m = fmaxf(m, src[2 * i]);
    float s = 0.f;
    for (int i = 0; i < n_chunks; ++i) s += src[2 * i + 1] * expf(src[2 * i] - m);
    s_s[tid] = s;
  }
  __syncthreads();
  const int d = tid / 8, e4 = (tid % 8) * 4;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = 0; c < n_chunks; ++c) {
    const float* src = cpart + ((((size_t)b * 4 + hh) * n_chunks + c) * kDh + d) * kDh + e4;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] += src[j];
  }
  float* dst = ctx + (((size_t)b * 4 + hh) * kDh + d) * kDh + e4;
#pragma unroll
  for (int j = 0; j < 4; ++j) dst[j] = acc[j] / s_s[d];
}

// out[b, head*32 + e, p] = sum_d ctx[b, head, d, e] * q[b, head*32 + d, p].
// Grid: (ceil(P / 128), 4, B).
constexpr int kQP = 128;

__global__ void __launch_bounds__(kThreads)
attn_qctx_kernel(const float* __restrict__ qkv, const float* __restrict__ ctx,
                 float* __restrict__ out, int P) {
  __shared__ float c_s[kDh][kDh + 1];
  __shared__ float q_s[kDh][kQP];
  const int hh = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int p0 = blockIdx.x * kQP;
  for (int i = tid; i < kDh * kDh; i += kThreads)
    c_s[i / kDh][i % kDh] = ctx[((size_t)b * 4 + hh) * kDh * kDh + i];
  const float* q = qkv + ((size_t)b * 3 * kHd + hh * kDh) * P;
  for (int i = tid; i < kDh * kQP; i += kThreads) {
    const int row = i / kQP, p = i % kQP;
    q_s[row][p] = p0 + p < P ? q[(size_t)row * P + p0 + p] : 0.f;
  }
  __syncthreads();
  const int e = tid / 8, pp = (tid % 8) * 16;
  float acc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j] = 0.f;
  for (int d = 0; d < kDh; ++d) {
    const float cv = c_s[d][e];
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[j] = fmaf(cv, q_s[d][pp + j], acc[j]);
  }
  float* dst = out + ((size_t)b * kHd + hh * kDh + e) * P + p0 + pp;
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (p0 + pp + j < P) dst[j] = acc[j];
}

}  // namespace

// ---------------------------------------------------------------------------
// Launchers (plain C interface; the Python wrapper checks shapes and types)
// ---------------------------------------------------------------------------

extern "C" int conv3x3_stats(const float* x0, int c0, const float* x1, int c1,
                             const int* lengths, const float* w, const float* bias,
                             float* out, float* partial, int B, int H, int T, int Cout,
                             int masked_stats, void* stream) {
  const dim3 grid(ceil_div(H, kRows) * ceil_div(T, kCols), Cout / kCoTile, B);
  conv3x3_stats_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x0, c0, x1, c1, lengths, w, bias, out, partial, H, T, Cout, masked_stats);
  ARTTTS_CHECK_LAUNCH();
  return 0;
}

extern "C" int conv3x3_tiles(int H, int T) {
  return ceil_div(H, kRows) * ceil_div(T, kCols);
}

extern "C" int gn_stats(const float* partial, const int* lengths, float* stats, int B,
                        int Cout, int n_tiles, int H, int T, int masked_stats, float eps,
                        void* stream) {
  gn_stats_kernel<<<dim3(kGroups, B), kThreads, 0, (cudaStream_t)stream>>>(
      partial, lengths, stats, Cout, n_tiles, H, T, masked_stats, eps);
  ARTTTS_CHECK_LAUNCH();
  return 0;
}

extern "C" int gn_act(const float* h, const float* stats, const float* gamma,
                      const float* beta, const float* temb, const float* res,
                      int res_masked, const int* lengths, float* out, int B, int C, int H,
                      int T, void* stream) {
  const size_t n = (size_t)B * C * H * T;
  const int blocks = (int)((n + kThreads - 1) / kThreads < 4096 ? (n + kThreads - 1) / kThreads
                                                                 : 4096);
  gn_act_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      h, stats, gamma, beta, temb, res, res_masked, lengths, out, B, C, H, T);
  ARTTTS_CHECK_LAUNCH();
  return 0;
}

extern "C" int pointwise(const float* x0, int c0, const float* x1, int c1,
                         const int* lengths, const float* w, const float* bias,
                         const float* resid, const float* gain, float* out, int B,
                         int Cout, int H, int T, void* stream) {
  const int P = H * T;
  const dim3 grid(ceil_div(P, kPwP), Cout / kCoTile, B);
  pointwise_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x0, c0, x1, c1, lengths, w, bias, resid, gain, out, Cout, P, T);
  ARTTTS_CHECK_LAUNCH();
  return 0;
}

extern "C" int attn_chunks(int P) { return ceil_div(P, kChunk); }

// qkv (B, 384, P) -> ao (B, 128, P) = q ctx; kpart, cpart, ctx are scratch
// of attn_chunks(P) chunks.
extern "C" int attention_core(const float* qkv, float* kpart, float* cpart, float* ctx,
                              float* ao, int B, int P, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int n_chunks = ceil_div(P, kChunk);
  attn_kstats_kernel<<<dim3(n_chunks, kHd, B), kThreads, 0, s>>>(qkv, kpart, P);
  ARTTTS_CHECK_LAUNCH();
  attn_ctx_partial_kernel<<<dim3(n_chunks, 4, B), kThreads, 0, s>>>(qkv, kpart, cpart, P);
  ARTTTS_CHECK_LAUNCH();
  attn_ctx_final_kernel<<<dim3(4, B), kThreads, 0, s>>>(kpart, cpart, ctx, n_chunks);
  ARTTTS_CHECK_LAUNCH();
  attn_qctx_kernel<<<dim3(ceil_div(P, kQP), 4, B), kThreads, 0, s>>>(qkv, ctx, ao, P);
  ARTTTS_CHECK_LAUNCH();
  return 0;
}
