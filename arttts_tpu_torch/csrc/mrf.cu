// K4: one round of a HiFi-GAN multi-receptive-field (MRF) stage, its two
// dilated 1D convolutions as implicit GEMMs on Hopper's tensor cores in
// 3xTF32.
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
// Layout: (B, C, T) float32, C in {32, 64, 128}; weights in torch's Conv1d
// layout (C_out, C_in, k), read as they are.
//
// What bounds it on the H100: the products. A stage does 252 * C^2 * T FLOP
// against about 2 * 4 * C * T bytes of input and output, far above the
// card's ridge even at three TF32 passes (3xTF32): float32 accuracy at the
// tensor cores' rate, where one TF32 pass misses the port's 1e-4 tolerance
// (tests/test_torch_kernels.py shows both on the CPU). Design:
// 1. Each conv is a GEMM with M = C_out, N = frames, K = C_in * k, on
//    `mma.sync.m16n8k8` with float32 accumulation (tf32_mma.cuh's `mma3`).
//    One k8 step is 8 input channels at one tap: A = W[co][ci][tap],
//    B = window[ci][f + tap * d].
// 2. Only the weights stream. A block stages its input window with conv1's
//    halo once (`cp.async`, zero-filled outside [0, T), then leaky-ReLU'd
//    in place); it is conv1's B for all of K. conv1's output tile, conv2's
//    halo included, is bias-added, masked to [0, T), leaky-ReLU'd and
//    written over the window (dead by then), and is conv2's B. A round's
//    intermediate never leaves the SM; conv2's epilogue adds FiLM, the
//    residual and the branch sum from registers.
// 3. Weights: a chunk is 8 input channels x k taps, 8k contiguous floats per
//    output channel in torch's layout, so 16-byte `cp.async` copies straight
//    from the Conv1d weight; a 2-stage ring keeps chunk i+1 in flight while
//    chunk i's `mma`s run. conv1's chunks and then conv2's are one stream.
// 4. Tiles: a block is 8 warps over all C_out x NF conv1 columns, NF = 128
//    at C = 128 and 64 (warp tiles 32 x 64 and 32 x 32), 256 at C = 32; it
//    writes NF - (k - 1) output frames (conv2's halo is recomputed). A k8
//    step of the C = 128 tile splits 8 weights and 16 window values for 48
//    `mma`s. Shared memory 192 / 96 / 64 KiB at k = 11, so 1 / 2 / 3 blocks
//    an SM; every main-path launch has 391-834 blocks for 132 SMs
//    (`mrf_blocks`). The tap loop is not unrolled: unrolled, the compiler
//    hoists loads across taps to 255 registers with spills for 1-3% less
//    time (scripts/mrf_variants.py times both); the loop keeps headroom.
// 5. The split: hi = x with its low 13 bits cleared, one integer op where
//    `cvt.rna` (tf32_mma.cuh's `split_tf32`) costs more; hi + lo then holds
//    x to 2^-20 instead of 2^-21, far inside the tolerance.
// 6. Bank conflicts: weight rows are padded to 8k + 4 words (g * (8k + 4) +
//    t * k covers 32 banks for k = 3, 7, 11), window rows to 8 mod 32 words,
//    so the A and B fragments' 32 lanes hit 32 banks.
// 7. Halo: the window's pitch is sized for conv1 halos (k - 1) * d of up to
//    kMaxHalo frames (d <= 6 at k = 11; the vocoders use 1, 3, 5), so each
//    kernel has one shared-memory size; the wrapper refuses larger ones.
// bf16 mode (`mrf_round_bf16`; the JAX kernel's opt-in `bf16`,
// mrf_pallas.py:441): the weights and each leaky-ReLU'd input of a conv are
// rounded to bf16 (to nearest, ties to even: `cvt.rn`, not the truncation
// of the split above) as the fragments are built from the same float32
// staging, and each pair of taps is one `mma.sync.m16n8k16` bf16 step with
// float32 accumulation (bf16_mma.cuh); k = 3, 7, 11 leave the last pair
// padded with zeros. Biases, FiLM, the residual and the branch sum stay
// float32. The kernel is templated on the mode: the float32 instantiation
// is the code above.
#include "bf16_mma.cuh"
#include "common.cuh"
#include "tf32_mma.cuh"

namespace {

using arttts::ceil_div;
using arttts::cp_async16;
using arttts::cp_async4;
using arttts::cp_async_commit;
using arttts::cp_async_wait;
using arttts::mma3;
using arttts::mma_bf16;
using arttts::pack_bf16;
using arttts::set_smem;

constexpr float kSlope = 0.1f;
constexpr int kStages = 2;
constexpr int kMaxHalo = 64;  // (k - 1) * dilation, frames; ops/mrf.py's MAX_HALO

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : kSlope * v; }

// x = hi + lo for 3xTF32: hi = x with its low 13 bits cleared (a TF32
// value), lo = x - hi exactly, which the tensor core reads truncated to TF32
__device__ __forceinline__ void split_trunc(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// A block: WM x WN warps; warp (wm, wn) computes output channels
// 32 wm..+31 (2 m16 tiles) and conv1 columns NT * 8 wn..+NT*8-1 (NT n8 tiles).
template <int C, int K>
struct Tile {
  static constexpr int kWarps = 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kWM = C / 32;
  static constexpr int kWN = kWarps / kWM;
  static constexpr int kNT = C == 128 ? 8 : 4;
  static constexpr int kNF = kWN * kNT * 8;       // conv1 columns of a block
  static constexpr int kTB = kNF - (K - 1);       // output frames of a block
  static constexpr int kAPitch = 8 * K + 4;       // a chunk's weights of one output channel
  static constexpr int kAStage = C * kAPitch;
  static constexpr int kTPitch = (kNF + kMaxHalo + 23) / 32 * 32 + 8;  // 8 mod 32
  static constexpr int kSmemFloats = kStages * kAStage + C * kTPitch;
  static constexpr int kChunks = C / 8;           // per conv
  static constexpr int kMinBlocks = C == 128 ? 1 : 2;
  static_assert(kWM * kWN == kWarps, "warps");
  static_assert(kTPitch % 32 == 8 && kTPitch >= kNF + kMaxHalo, "B fragments");
  static_assert(kAStage % 4 == 0, "16-byte aligned stages");
};

// One launch's operands, as `mrf_round` below takes them.
struct RoundArgs {
  const float *xin, *w1, *b1, *w2, *b2, *fa, *fb;
  float* out;
  int B, T, dil, accumulate;
  float scale;
};

// Grid: (ceil(T / kTB), B). Block x writes output frames [g0, g0 + kTB) of
// utterance blockIdx.y.
template <int C, int K, bool BF16>
__global__ void __launch_bounds__(Tile<C, K>::kThreads, Tile<C, K>::kMinBlocks)
mrf_round_kernel(const RoundArgs a) {
  using Tl = Tile<C, K>;
  constexpr int kThreads = Tl::kThreads, kWarps = Tl::kWarps;
  constexpr int P = (K - 1) / 2;
  constexpr int NT = Tl::kNT;
  constexpr int AP = Tl::kAPitch;
  constexpr int TP = Tl::kTPitch;
  constexpr int NCH = Tl::kChunks;
  extern __shared__ __align__(16) float smem[];
  float* tile = smem + kStages * Tl::kAStage;  // C x TP: the input window, then conv1's output

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % Tl::kWM, wn = warp / Tl::kWM;
  const int T = a.T, dil = a.dil;
  const int b = blockIdx.y;
  const int g0 = blockIdx.x * Tl::kTB;
  const int e0 = g0 - P;          // frame of conv1's output column 0
  const int i0 = e0 - P * dil;    // frame of the window's column 0
  const float* xb = a.xin + (size_t)b * C * T;

  // chunk c < NCH: conv1's input channels 8c..8c+7; else conv2's 8(c - NCH)..
  auto load_w = [&](int c, int slot) {
    const float* w = (c < NCH ? a.w1 : a.w2) + (c % NCH) * 8 * K;
    float* As = smem + slot * Tl::kAStage;
    constexpr int kPieces = 2 * K;  // 16-byte pieces of a row's 8k floats
    for (int i = tid; i < C * kPieces; i += kThreads) {
      const int co = i / kPieces, q = i - co * kPieces;
      cp_async16(As + co * AP + 4 * q, w + (size_t)co * C * K + 4 * q);
    }
  };
  // the window, with the first weight chunk: warp w copies rows w, w + 8,
  // ..., lanes along frames, zero-filled outside [0, T); once its copies
  // land, each thread applies the leaky ReLU to the elements it copied
  const int LI = Tl::kNF + (K - 1) * dil;
  for (int ci = warp; ci < C; ci += kWarps) {
    const float* src = xb + (size_t)ci * T;
    float* dst = tile + ci * TP;
    for (int j = lane; j < LI; j += 32) {
      const int gg = i0 + j;
      const bool ok = gg >= 0 && gg < T;
      cp_async4(dst + j, ok ? src + gg : xb, ok);
    }
  }
  load_w(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  for (int ci = warp; ci < C; ci += kWarps) {
    float* dst = tile + ci * TP;
    for (int j = lane; j < LI; j += 32) dst[j] = lrelu(dst[j]);
  }

  float acc[2][NT][4];  // [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

  // this warp's fragments: A rows 32 wm + g (+8, +16, +24), channel t (+4)
  // at tap; B channel t (+4), column 8 NT wn + 8 nt + g + tap * step
  const int col0 = wn * NT * 8;
  const float* Aw0 = smem + (32 * wm + g) * AP + t * K;
  const float* Bw0 = tile + t * TP + col0 + g;
#pragma unroll 1
  for (int c = 0; c < 2 * NCH; ++c) {
    cp_async_wait<0>();
    __syncthreads();  // chunk c (and at c = 0 the window) is in; every warp is done with c-1
    if (c + 1 < 2 * NCH) load_w(c + 1, (c + 1) % kStages);
    cp_async_commit();
    if (c == NCH) {
      // conv1 done in every warp: its output (+ b1, masked, lrelu) over the window
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int co = 32 * wm + 16 * mt + 8 * h + g;
          const float bv = a.b1[co];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int f = col0 + 8 * nt + 2 * t;
            const int e = e0 + f;
            float2 v;
            v.x = (e >= 0 && e < T) ? lrelu(acc[mt][nt][2 * h] + bv) : 0.f;
            v.y = (e + 1 >= 0 && e + 1 < T) ? lrelu(acc[mt][nt][2 * h + 1] + bv) : 0.f;
            *reinterpret_cast<float2*>(tile + co * TP + f) = v;
            acc[mt][nt][2 * h] = 0.f;
            acc[mt][nt][2 * h + 1] = 0.f;
          }
        }
      }
      __syncthreads();
    }
    const int step = c < NCH ? dil : 1;
    const float* Aw = Aw0 + (c % kStages) * Tl::kAStage;
    const float* Bw = Bw0 + (c % NCH) * 8 * TP;
    if constexpr (BF16) {
      // tap pairs (0, 1), (2, 3), ...; k is odd, so the last pair is
      // (k - 1, pad): `two` false there
#pragma unroll 1
      for (int tap = 0; tap < K; tap += 2) {
        const bool two = tap + 1 < K;
        uint32_t af[2][4], bf[NT][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {  // rows g, g+8 x channels t, t+4
            const float* p = Aw + 16 * mt * AP + (r & 1) * 8 * AP + (r >> 1) * 4 * K + tap;
            af[mt][r] = pack_bf16(p[0], two ? p[1] : 0.f);
          }
        }
        const float* q0 = Bw + tap * step;
        const float* q1 = two ? q0 + step : q0;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          bf[nt][0] = pack_bf16(q0[8 * nt], two ? q1[8 * nt] : 0.f);
          bf[nt][1] = pack_bf16(q0[4 * TP + 8 * nt], two ? q1[4 * TP + 8 * nt] : 0.f);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], af[mt], bf[nt]);
      }
      continue;
    }
#pragma unroll 1
    for (int tap = 0; tap < K; ++tap) {
      uint32_t ah[2][4], al[2][4], bh[NT][2], bl[NT][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* p = Aw + 16 * mt * AP + tap;
        split_trunc(p[0], ah[mt][0], al[mt][0]);
        split_trunc(p[8 * AP], ah[mt][1], al[mt][1]);
        split_trunc(p[4 * K], ah[mt][2], al[mt][2]);
        split_trunc(p[8 * AP + 4 * K], ah[mt][3], al[mt][3]);
      }
      const float* q = Bw + tap * step;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        split_trunc(q[8 * nt], bh[nt][0], bl[nt][0]);
        split_trunc(q[4 * TP + 8 * nt], bh[nt][1], bl[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma3(acc[mt], ah[mt], al[mt], bh, bl);
    }
  }

  // conv2's epilogue: + b2, FiLM, + the round's input, the branch sum
  float* ob = a.out + (size_t)b * C * T;
  const bool vec = !(T & 1);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = 32 * wm + 16 * mt + 8 * h + g;
      const float bv = a.b2[co];
      const float fa = a.fa != nullptr ? a.fa[b * C + co] : 1.f;
      const float fc = a.fb != nullptr ? a.fb[b * C + co] : 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int f = col0 + 8 * nt + 2 * t;  // even, as kTB is: f < kTB holds f + 1 too
        const int gg = g0 + f;
        if (f >= Tl::kTB || gg >= T) continue;
        const bool two = gg + 1 < T;
        const size_t o = (size_t)co * T + gg;
        float v0 = acc[mt][nt][2 * h] + bv, v1 = acc[mt][nt][2 * h + 1] + bv;
        if (a.fa != nullptr) {
          v0 = v0 * fa + fc;
          v1 = v1 * fa + fc;
        }
        if (vec) {  // T even: gg even, both frames in range
          const float2 x2 = *reinterpret_cast<const float2*>(xb + o);
          float2 r = make_float2(v0 + x2.x, v1 + x2.y);
          if (a.accumulate) {
            const float2 p2 = *reinterpret_cast<const float2*>(ob + o);
            r = make_float2(p2.x + r.x, p2.y + r.y);
          }
          *reinterpret_cast<float2*>(ob + o) = make_float2(r.x * a.scale, r.y * a.scale);
        } else {
          float r0 = v0 + xb[o];
          if (a.accumulate) r0 = ob[o] + r0;
          ob[o] = r0 * a.scale;
          if (two) {
            float r1 = v1 + xb[o + 1];
            if (a.accumulate) r1 = ob[o + 1] + r1;
            ob[o + 1] = r1 * a.scale;
          }
        }
      }
    }
  }
}

template <int C, int K, bool BF16>
int launch(const RoundArgs& a, cudaStream_t stream) {
  using Tl = Tile<C, K>;
  if (a.dil < 1 || (K - 1) * a.dil > kMaxHalo || a.B < 1 || a.T < 1)
    return (int)cudaErrorInvalidValue;
  auto kernel = mrf_round_kernel<C, K, BF16>;
  const size_t smem = sizeof(float) * Tl::kSmemFloats;
  static const int attr = set_smem(kernel, smem);
  if (attr) return attr;
  const dim3 grid(ceil_div(a.T, Tl::kTB), a.B);
  kernel<<<grid, Tl::kThreads, smem, stream>>>(a);
  ARTTTS_CHECK_LAUNCH();
  return 0;
}

// Output frames of a block, or 0 for an unsupported (C, K).
template <int C>
int frames_k(int K) {
  switch (K) {
    case 3: return Tile<C, 3>::kTB;
    case 7: return Tile<C, 7>::kTB;
    case 11: return Tile<C, 11>::kTB;
    default: return 0;
  }
}

int frames_per_block(int C, int K) {
  switch (C) {
    case 32: return frames_k<32>(K);
    case 64: return frames_k<64>(K);
    case 128: return frames_k<128>(K);
    default: return 0;
  }
}

template <int C, bool BF16>
int launch_k(int K, const RoundArgs& a, cudaStream_t stream) {
  switch (K) {
    case 3: return launch<C, 3, BF16>(a, stream);
    case 7: return launch<C, 7, BF16>(a, stream);
    case 11: return launch<C, 11, BF16>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool BF16>
int round_launch(const RoundArgs& a, int C, int K, cudaStream_t s) {
  switch (C) {
    case 32: return launch_k<32, BF16>(K, a, s);
    case 64: return launch_k<64, BF16>(K, a, s);
    case 128: return launch_k<128, BF16>(K, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// One (branch, round) of an MRF stage. `xin` is the branch state before the
// round (the stage input in round 0), `out` receives the state after it, or
// in a branch's last round the branch sum: out = ((accumulate ? out : 0) +
// state) * scale. `w1`/`w2` are the round's (C, C, K) Conv1d weights, `fa`/
// `fb` (B, C) its FiLM vectors, or NULL.
extern "C" int mrf_round(const float* xin, const float* w1, const float* b1,
                         const float* w2, const float* b2, const float* fa, const float* fb,
                         float* out, int B, int C, int K, int T, int dil, int accumulate,
                         float scale, void* stream) {
  const RoundArgs a{xin, w1, b1, w2, b2, fa, fb, out, B, T, dil, accumulate, scale};
  return round_launch<false>(a, C, K, (cudaStream_t)stream);
}

// The same round in the bf16 mode: weights and conv inputs rounded to bf16,
// float32 sums.
extern "C" int mrf_round_bf16(const float* xin, const float* w1, const float* b1,
                              const float* w2, const float* b2, const float* fa,
                              const float* fb, float* out, int B, int C, int K, int T, int dil,
                              int accumulate, float scale, void* stream) {
  const RoundArgs a{xin, w1, b1, w2, b2, fa, fb, out, B, T, dil, accumulate, scale};
  return round_launch<true>(a, C, K, (cudaStream_t)stream);
}

// Blocks of one `mrf_round` launch at this shape, or -1 if it takes none.
extern "C" int mrf_blocks(int B, int C, int K, int T) {
  const int tb = frames_per_block(C, K);
  return tb > 0 && B > 0 && T > 0 ? ceil_div(T, tb) * B : -1;
}
