// K4: one round of a HiFi-GAN multi-receptive-field (MRF) stage.
//
// Replaces the TPU kernel `_mrf_kernel` behind `mrf_stage` in
// arttts_tpu/ops/mrf_pallas.py: the sum over branches (kernel sizes 3, 7,
// 11) of ResBlock(x), divided by the branch count, where each branch runs
// rounds (dilations 1, 3, 5) of
//
//     xt = conv(k, d)(lrelu(xb)) + b1 ; xt *= valid ; xt = lrelu(xt)
//     xt = conv(k, 1)(xt) + b2 ; [FiLM: xt = xt * a + b] ; xb += xt * valid
//
// with SAME zero padding at the tensor's own edges (valid = frame in [0, T)),
// and optional per-utterance, per-channel FiLM (a, b) (the SPARC vocoder).
// One launch computes one (branch, round): both convolutions, the epilogue
// and, in a branch's last round, the branch sum in a fixed order (branch 0
// stores, later branches add, the last one scales by 1 / n_branches), so the
// stage has no float atomics and gives the same bits on every run.
//
// Layout: (B, C, T) float32, C in {32, 64, 128}; weights packed by the
// wrapper as (C_in, k, C_out) per round, so a chunk of input channels is
// one contiguous run.
//
// What bounds it on the H100: the multiply-adds. A stage does
// 252 * C^2 * T FLOP against about 2 * 4 * C * T bytes of input and output,
// far above the card's float32 ridge, on the CUDA cores. The design keeps
// the TPU kernel's point that a round's intermediate never reaches device
// memory: a block loads its input tile with the round's halo
// ((k - 1) / 2 * (d + 1) frames a side, leaky-ReLU'd and zeroed outside
// [0, T) on load) into shared memory, computes conv1 over the tile plus
// conv2's halo into shared memory (over the input tile, which is dead by
// then), then conv2 and the epilogue from registers. The weights do not fit
// (720 KB a conv at C=128, k=11); they stream through shared memory in
// chunks of 512 / C input channels (22.5 KB at k=11), so two blocks fit on
// an SM. Each thread keeps 64 accumulators (C / 8 channels x 512 / C frames
// at C=128, 8 x 8 below), frames 32 apart so a warp's tile reads hit 32
// distinct banks, channels uniform per warp so weights arrive as broadcast
// float4 reads: 64 FMAs per 8-10 shared-memory reads.
#include "common.cuh"

namespace {

using arttts::ceil_div;
using arttts::kThreads;

constexpr float kSlope = 0.1f;
constexpr int kMaxSmem = 232448;  // a block's shared-memory limit on sm_90

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : kSlope * v; }

template <int C>
struct Tile {
  static constexpr int kCoT = C >= 128 ? C / 8 : 8;  // output channels per thread
  static constexpr int kFrT = 64 / kCoT;             // frames per thread, 32 apart
  static constexpr int kWarpsC = C / kCoT;           // warps across channels
  static constexpr int kWarpsF = 8 / kWarpsC;        // warps across frames
  static constexpr int kNF = kWarpsF * 32 * kFrT;    // conv output frames per block
  static constexpr int kCiChunk = 512 / C;           // input channels per weight chunk
  static_assert(kWarpsC * kWarpsF * 32 == kThreads, "tile must cover the block");
};

// acc[i][j] += sum over ci < C, tap < K of
//   w[ci][tap][co0 + i] * src[ci * stride + f0 + 32 j + tap * dil],
// streaming the (C, K, C) weights `wg` through `w_s` chunk by chunk. The
// first barrier also publishes the caller's writes to `src`.
template <int C, int K>
__device__ __forceinline__ void conv_accumulate(float (&acc)[Tile<C>::kCoT][Tile<C>::kFrT],
                                                const float* src, int stride, int dil,
                                                const float* __restrict__ wg, float* w_s,
                                                int co0, int f0) {
  using Tl = Tile<C>;
  constexpr int kChunk4 = Tl::kCiChunk * K * C / 4;
#pragma unroll 1
  for (int ci0 = 0; ci0 < C; ci0 += Tl::kCiChunk) {
    __syncthreads();
    const float4* g4 = reinterpret_cast<const float4*>(wg + (size_t)ci0 * K * C);
    float4* s4 = reinterpret_cast<float4*>(w_s);
    for (int i = threadIdx.x; i < kChunk4; i += kThreads) s4[i] = g4[i];
    __syncthreads();
#pragma unroll 1
    for (int ci = 0; ci < Tl::kCiChunk; ++ci) {
      const float* row = src + (ci0 + ci) * stride + f0;
#pragma unroll
      for (int tap = 0; tap < K; ++tap) {
        float xv[Tl::kFrT];
#pragma unroll
        for (int j = 0; j < Tl::kFrT; ++j) xv[j] = row[32 * j + tap * dil];
        float wv[Tl::kCoT];
        const float4* w4 = reinterpret_cast<const float4*>(w_s + (ci * K + tap) * C + co0);
#pragma unroll
        for (int q = 0; q < Tl::kCoT / 4; ++q) {
          const float4 v = w4[q];
          wv[4 * q] = v.x;
          wv[4 * q + 1] = v.y;
          wv[4 * q + 2] = v.z;
          wv[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < Tl::kCoT; ++i)
#pragma unroll
          for (int j = 0; j < Tl::kFrT; ++j) acc[i][j] = fmaf(wv[i], xv[j], acc[i][j]);
      }
    }
  }
}

// Grid: (ceil(T / (kNF - (K - 1))), B). Block x writes output frames
// [g0, g0 + kNF - (K - 1)) of utterance blockIdx.y.
template <int C, int K>
__global__ void __launch_bounds__(kThreads, 2)
mrf_round_kernel(const float* __restrict__ xin, const float* __restrict__ w1,
                 const float* __restrict__ b1, const float* __restrict__ w2,
                 const float* __restrict__ b2, const float* __restrict__ fa,
                 const float* __restrict__ fb, float* out, int T, int dil, int accumulate,
                 float scale) {
  using Tl = Tile<C>;
  constexpr int NF = Tl::kNF;
  constexpr int P2 = (K - 1) / 2;
  constexpr int TB = NF - (K - 1);
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                          // kCiChunk x K x C weight chunk
  float* tile = smem + Tl::kCiChunk * K * C;  // C x LI input tile, then C x NF conv1 output

  const int LI = NF + (K - 1) * dil;
  const int b = blockIdx.y;
  const int g0 = blockIdx.x * TB;
  const int e0 = g0 - P2;        // frame of conv1's output column 0
  const int i0 = e0 - P2 * dil;  // frame of the input tile's column 0
  const float* xb = xin + (size_t)b * C * T;

  for (int i = threadIdx.x; i < C * LI; i += kThreads) {
    const int ci = i / LI;
    const int g = i0 + (i - ci * LI);
    tile[i] = (g >= 0 && g < T) ? lrelu(xb[(size_t)ci * T + g]) : 0.f;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int co0 = (warp % Tl::kWarpsC) * Tl::kCoT;
  const int f0 = (warp / Tl::kWarpsC) * 32 * Tl::kFrT + lane;
  float acc[Tl::kCoT][Tl::kFrT];
#pragma unroll
  for (int i = 0; i < Tl::kCoT; ++i)
#pragma unroll
    for (int j = 0; j < Tl::kFrT; ++j) acc[i][j] = 0.f;

  conv_accumulate<C, K>(acc, tile, LI, dil, w1, w_s, co0, f0);
  __syncthreads();  // every read of the input tile is done: reuse it for conv1's output
#pragma unroll
  for (int i = 0; i < Tl::kCoT; ++i) {
    const int co = co0 + i;
    const float bv = b1[co];
#pragma unroll
    for (int j = 0; j < Tl::kFrT; ++j) {
      const int f = f0 + 32 * j;
      const int e = e0 + f;
      tile[co * NF + f] = (e >= 0 && e < T) ? lrelu(acc[i][j] + bv) : 0.f;
      acc[i][j] = 0.f;
    }
  }
  // conv2 over output columns f < TB; columns f >= TB read past their row
  // (still inside the tile's allocation) and are never stored
  conv_accumulate<C, K>(acc, tile, NF, 1, w2, w_s, co0, f0);

  float* ob = out + (size_t)b * C * T;
#pragma unroll
  for (int i = 0; i < Tl::kCoT; ++i) {
    const int co = co0 + i;
    const float bv = b2[co];
    const float a = fa != nullptr ? fa[b * C + co] : 1.f;
    const float c = fb != nullptr ? fb[b * C + co] : 0.f;
#pragma unroll
    for (int j = 0; j < Tl::kFrT; ++j) {
      const int f = f0 + 32 * j;
      const int g = g0 + f;
      if (f < TB && g < T) {
        const size_t o = (size_t)co * T + g;
        float v = acc[i][j] + bv;
        if (fa != nullptr) v = v * a + c;
        v += xb[o];
        if (accumulate) v = ob[o] + v;
        ob[o] = v * scale;
      }
    }
  }
}

// One launch's operands, as `mrf_round` below takes them.
struct RoundArgs {
  const float *xin, *w1, *b1, *w2, *b2, *fa, *fb;
  float* out;
  int B, T, dil, accumulate;
  float scale;
};

template <int C, int K>
int launch(const RoundArgs& a, cudaStream_t stream) {
  using Tl = Tile<C>;
  const int LI = Tl::kNF + (K - 1) * a.dil;
  const size_t smem = sizeof(float) * ((size_t)Tl::kCiChunk * K * C + (size_t)C * LI);
  if (a.dil < 1 || smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = mrf_round_kernel<C, K>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(ceil_div(a.T, Tl::kNF - (K - 1)), a.B);
  kernel<<<grid, kThreads, smem, stream>>>(a.xin, a.w1, a.b1, a.w2, a.b2, a.fa, a.fb, a.out,
                                           a.T, a.dil, a.accumulate, a.scale);
  ARTTTS_CHECK_LAUNCH();
  return 0;
}

template <int C>
int launch_k(int K, const RoundArgs& a, cudaStream_t stream) {
  switch (K) {
    case 3: return launch<C, 3>(a, stream);
    case 7: return launch<C, 7>(a, stream);
    case 11: return launch<C, 11>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// One (branch, round) of an MRF stage. `xin` is the branch state before the
// round (the stage input in round 0), `out` receives the state after it, or
// in a branch's last round the branch sum: out = ((accumulate ? out : 0) +
// state) * scale. `fa`/`fb` (B, C) are the round's FiLM vectors, or NULL.
extern "C" int mrf_round(const float* xin, const float* w1, const float* b1,
                         const float* w2, const float* b2, const float* fa, const float* fb,
                         float* out, int B, int C, int K, int T, int dil, int accumulate,
                         float scale, void* stream) {
  const RoundArgs a{xin, w1, b1, w2, b2, fa, fb, out, B, T, dil, accumulate, scale};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 32: return launch_k<32>(K, a, s);
    case 64: return launch_k<64>(K, a, s);
    case 128: return launch_k<128>(K, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
