// K5: leaky ReLU (0.1) + ConvTranspose1d with kernel 4 and stride 2, torch
// semantics, plus bias: (B, Cin, T) -> (B, Cout, T_out) float32, with
// T_out = (T - 1) * 2 - 2 * pad + 4 + output_padding, as a polyphase
// implicit GEMM on Hopper's tensor cores in 3xTF32.
//
// Replaces the TPU kernel `_ups_kernel` behind `upsample_packed` in
// arttts_tpu/ops/upsample_pallas.py (HiFi-GAN's stride-2 upsamples, 128 ->
// 64 and 64 -> 32 channels), whose body contracts a probed packed matrix
// on the MXU. Here the taps are routed directly: output frame o, with
// u = o + pad, q = u / 2 and r = u % 2, reads two input frames,
//
//     out[co, 2q + r - pad] = bias[co] + sum_ci W[ci, co, r] * X[ci, q]
//                                      + W[ci, co, r + 2] * X[ci, q - 1],
//
// X = lrelu(x), zero outside [0, T). Nothing of the input-dilated form's
// zeros is multiplied.
//
// What bounds it on the H100: 2 * Cin multiply-adds per output against
// 4 bytes written and 4 * Cin / 2 read: 3.22 GFLOP against 50 MB at 128 ->
// 64 and T = 49,152, so operations on the CUDA cores (0.048 ms) and, in three
// TF32 passes on the tensor cores, bytes (0.015 ms) over operations (0.0195
// ms). Design, on K4's machinery (csrc/mrf.cu, tf32_mma.cuh):
// 1. The GEMM stacks both phases in M: rows m = 2 co + r (M = 2 * Cout),
//    K = (input channel, s) with s = 0 for X[q] and 1 for X[q - 1]
//    (K = 2 * Cin), N = input frames q. A[m, (ci, s)] = W[ci, co, r + 2s];
//    B[(ci, s), n] = X[ci, q0 + n - s]: both halves of K read the same
//    staged window, one column apart. One k8 step of `mma.sync.m16n8k8` is
//    4 input channels x both s (k = 2 c' + s), in 3xTF32 (`mma3`) with
//    K4's truncating hi split and float32 accumulation.
// 2. Only the weights stream. A block stages its window X[:, q0-4 ..
//    q0+N-1] once (16-byte `cp.async` where a piece lies inside [0, T) and
//    the rows are aligned, else 4-byte zero-filled copies), leaky-ReLU'd in
//    place by the thread that copied each value; it is B for all of K.
//    The weights come in chunks of 16 input channels, in torch's (Cin,
//    Cout, 4) layout as they are: a chunk is 16 contiguous runs of Cout * 4
//    floats, of which a block copies its CO output channels' CO * 4, by
//    16-byte `cp.async` through a 2-stage ring.
// 3. Tiles: a block is 8 warps over CO output channels (M = 2 CO: 128 or 64)
//    x N = 128 frames q (256 output frames), warp tiles 32 x 64 (CO = 64)
//    or 32 x 32 (CO = 32). CO = 64 where Cout allows, so a k8 step of the
//    Cout = 64 tile splits 8 weights and 16 window values for 48 `mma`s.
//    Shared memory 106 KiB (Cin 128, CO 64) or 54 KiB (Cin 64, CO 32), and
//    the CO = 64 tile held to 128 registers (126, no spills), so 2 blocks
//    an SM (left to itself the compiler takes 130 registers: one block an
//    SM, 16% slower at 128 -> 64; scripts/upsample_variants.py times
//    both); the main path's launches have 385 and 769 blocks for 132 SMs
//    (`upsample1d_blocks`).
// 4. Bank conflicts: A's k = 2 c' + s puts the two s of a channel 2 floats
//    apart and rows m = 2 co + r 1 and 4 apart, so with the ring's rows
//    16 mod 32 floats apart the 32 lanes of an A fragment hit 32 banks; the
//    window's rows are 16 mod 32 apart too, so B's lanes hit distinct banks
//    or share a word.
// 5. Epilogue: the accumulators (+ bias) go through shared memory (over the
//    window, dead by then) into rows of 2N output frames, the two phases
//    interleaved, and each warp stores whole rows, lanes along frames
//    (coalesced), keeping the frames in [0, T_out): every padding and
//    output padding is a shift of the block's first frame 2 q0 - pad.
#include "common.cuh"
#include "tf32_mma.cuh"

namespace {

using arttts::ceil_div;
using arttts::cp_async16;
using arttts::cp_async4;
using arttts::cp_async_commit;
using arttts::cp_async_wait;
using arttts::mma3;
using arttts::set_smem;

constexpr float kSlope = 0.1f;
constexpr int kStages = 2;
constexpr int kCiChunk = 16;  // input channels a weight chunk (4 k8 steps)
constexpr int kN = 128;       // frames q a block
constexpr int kHalo = 4;      // window columns before q0 (one is read: q0 - 1)
constexpr int kMaxCin = 256;  // ops/upsample.py's MAX_C_IN: the window must fit

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : kSlope * v; }

// x = hi + lo for 3xTF32 (as in csrc/mrf.cu): hi = x with its low 13 bits
// cleared, lo = x - hi exactly, which the tensor core reads truncated to TF32
__device__ __forceinline__ void split_trunc(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

template <int CO>
struct Tile {
  static constexpr int kWarps = 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kM = 2 * CO;
  static constexpr int kWM = kM / 32;
  static constexpr int kWN = kWarps / kWM;
  static constexpr int kNT = kN / (8 * kWN);         // n8 tiles a warp
  static constexpr int kAPitch = 4 * CO + 16;        // a weight row: 16 mod 32
  static constexpr int kAStage = kCiChunk * kAPitch;
  static constexpr int kTPitch = 144;                // window row: >= kN + kHalo, 16 mod 32
  static constexpr int kOPitch = 2 * kN + 8;         // output row of the epilogue
  static constexpr int kMinBlocks = CO == 64 ? 2 : 1;  // CO = 64: at most 128 registers
  static_assert(kWM * kWN == kWarps && kNT * 8 * kWN == kN, "warps");
  static_assert(kAPitch % 32 == 16 && kTPitch % 32 == 16 && kTPitch >= kN + kHalo, "banks");
};

template <int CO>
size_t smem_floats(int cin) {
  using Tl = Tile<CO>;
  const size_t k_loop = (size_t)kStages * Tl::kAStage + (size_t)ceil_div(cin, kCiChunk) *
                        kCiChunk * Tl::kTPitch;
  const size_t epilogue = (size_t)CO * Tl::kOPitch;
  return k_loop > epilogue ? k_loop : epilogue;
}

struct Args {
  const float *x, *w, *bias;
  float* out;
  int Cin, Cout, T, pad, T_out, q_lo, vec;
};

// Grid: (ceil((q_hi - q_lo + 1) / kN), Cout / CO, B). Block (i, j, b) covers
// frames q in [q_lo + i kN, +kN) and output channels [j CO, +CO) of b.
template <int CO>
__global__ void __launch_bounds__(Tile<CO>::kThreads, Tile<CO>::kMinBlocks)
upsample_kernel(const Args a) {
  using Tl = Tile<CO>;
  constexpr int kThreads = Tl::kThreads, NT = Tl::kNT;
  constexpr int AP = Tl::kAPitch, TP = Tl::kTPitch;
  extern __shared__ __align__(16) float smem[];
  float* win = smem + kStages * Tl::kAStage;  // ceil16(Cin) x TP: lrelu(x) over the window

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % Tl::kWM, wn = warp / Tl::kWM;
  const int q0 = a.q_lo + blockIdx.x * kN;
  const int co0 = blockIdx.y * CO;
  const int b = blockIdx.z;
  const int Cin = a.Cin, T = a.T;
  const int n_chunks = ceil_div(Cin, kCiChunk);
  const float* xb = a.x + (size_t)b * Cin * T;
  const bool vec = a.vec && (q0 & 3) == 0;  // pieces start 16-byte aligned

  // chunk c: input channels 16c..16c+15, this block's CO channels x 4 taps
  auto load_w = [&](int c, int slot) {
    float* As = smem + slot * Tl::kAStage;
    for (int i = tid; i < kCiChunk * CO; i += kThreads) {
      const int r = i / CO, piece = i - r * CO;
      const int ci = c * kCiChunk + r;
      const bool ok = ci < Cin;
      cp_async16(As + r * AP + 4 * piece,
                 a.w + ((size_t)(ok ? ci : 0) * a.Cout + co0) * 4 + 4 * piece, ok);
    }
  };
  // the window, columns j <-> q = q0 - kHalo + j, with the first weight chunk
  const int rows = n_chunks * kCiChunk;
  constexpr int kPieces = (kN + kHalo) / 4;
  for (int i = tid; i < rows * kPieces; i += kThreads) {
    const int ci = i / kPieces, k = i - ci * kPieces;
    const int q = q0 - kHalo + 4 * k;
    float* dst = win + ci * TP + 4 * k;
    const float* src = xb + (size_t)ci * T + q;
    if (ci >= Cin || q + 3 < 0 || q >= T) {
      cp_async16(dst, xb, false);
    } else if (vec && q >= 0 && q + 3 < T) {
      cp_async16(dst, src);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = q + e >= 0 && q + e < T;
        cp_async4(dst + e, ok ? src + e : xb, ok);
      }
    }
  }
  load_w(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  for (int i = tid; i < rows * kPieces; i += kThreads) {
    float4* p = reinterpret_cast<float4*>(win + (i / kPieces) * TP + 4 * (i % kPieces));
    const float4 v = *p;
    *p = make_float4(lrelu(v.x), lrelu(v.y), lrelu(v.z), lrelu(v.w));
  }

  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

  // A fragment: row m = 32 wm + 16 mt + g (+8) -> co = m / 2, r = g % 2;
  // k = t (+4) -> channel t / 2 (+2), s = t % 2: W at row c' and 4 co + r + 2s
  const float* Aw0 = smem + (t >> 1) * AP + 2 * (t & 1) + 64 * wm + 4 * (g >> 1) + (g & 1);
  // B fragment: k = t (+4) -> channel t / 2 (+2), s = t % 2; column n = col0
  // + 8 nt + g reads q0 + n - s, window column n + kHalo - s
  const int col0 = wn * NT * 8;
  const float* Bw0 = win + (t >> 1) * TP + col0 + g + kHalo - (t & 1);
#pragma unroll 1
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<0>();
    __syncthreads();  // chunk c (and at c = 0 the window) is in; every warp is done with c-1
    if (c + 1 < n_chunks) load_w(c + 1, (c + 1) % kStages);
    cp_async_commit();
    const float* Aw = Aw0 + (c % kStages) * Tl::kAStage;
    const float* Bw = Bw0 + c * kCiChunk * TP;
#pragma unroll
    for (int st = 0; st < kCiChunk / 4; ++st) {
      uint32_t ah[2][4], al[2][4], bh[NT][2], bl[NT][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* p = Aw + 4 * st * AP + 32 * mt;
        split_trunc(p[0], ah[mt][0], al[mt][0]);
        split_trunc(p[16], ah[mt][1], al[mt][1]);
        split_trunc(p[2 * AP], ah[mt][2], al[mt][2]);
        split_trunc(p[2 * AP + 16], ah[mt][3], al[mt][3]);
      }
      const float* q = Bw + 4 * st * TP;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        split_trunc(q[8 * nt], bh[nt][0], bl[nt][0]);
        split_trunc(q[2 * TP + 8 * nt], bh[nt][1], bl[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma3(acc[mt], ah[mt], al[mt], bh, bl);
    }
  }

  // epilogue: + bias into rows of 2 kN output frames, phases interleaved
  __syncthreads();  // every warp is done with the window
  float* ot = smem;
  constexpr int OP = Tl::kOPitch;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 32 * wm + 16 * mt + 8 * h + g;
      const int co = m >> 1, r = m & 1;
      const float bv = a.bias[co0 + co];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = col0 + 8 * nt + 2 * t;
        ot[co * OP + 2 * n + r] = acc[mt][nt][2 * h] + bv;
        ot[co * OP + 2 * n + 2 + r] = acc[mt][nt][2 * h + 1] + bv;
      }
    }
  }
  __syncthreads();
  const int o0 = 2 * q0 - a.pad;  // output frame of row position 0
  float* ob = a.out + ((size_t)b * a.Cout + co0) * a.T_out;
  for (int co = warp; co < CO; co += Tl::kWarps) {
    for (int p = lane; p < 2 * kN; p += 32) {
      const int o = o0 + p;
      if (o >= 0 && o < a.T_out) ob[(size_t)co * a.T_out + o] = ot[co * OP + p];
    }
  }
}

// Output channels a block: 64 where Cout allows, else 32.
int co_tile(int Cout) { return Cout % 64 == 0 ? 64 : 32; }

template <int CO>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<CO>(a.Cin);
  static const int attr = set_smem(upsample_kernel<CO>, sizeof(float) *
                                   smem_floats<CO>(kMaxCin));
  if (attr) return attr;
  const int q_hi = (a.T_out - 1 + a.pad) / 2;
  const dim3 grid(ceil_div(q_hi - a.q_lo + 1, kN), a.Cout / CO, B);
  upsample_kernel<CO><<<grid, Tile<CO>::kThreads, smem, stream>>>(a);
  ARTTTS_CHECK_LAUNCH();
  return 0;
}

}  // namespace

// lrelu + ConvTranspose1d(kernel 4, stride 2, padding, output_padding) +
// bias; w in torch layout (Cin, Cout, 4), 16-byte aligned. Takes stride 2,
// Cout a multiple of 32 and Cin <= 256.
extern "C" int upsample1d(const float* x, const float* w, const float* bias, float* out,
                          int B, int Cin, int Cout, int T, int stride, int pad,
                          int output_padding, void* stream) {
  if (stride != 2 || Cout % 32 != 0 || Cin < 1 || Cin > kMaxCin || pad < 0 || B < 1 || T < 1 ||
      (reinterpret_cast<uintptr_t>(w) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int T_out = (T - 1) * stride - 2 * pad + 2 * stride + output_padding;
  if (T_out <= 0) return (int)cudaErrorInvalidValue;
  // 16-byte window copies need every row to start 16-byte aligned
  const int vec = (T & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const Args a{x, w, bias, out, Cin, Cout, T, pad, T_out, pad / 2, vec};
  const cudaStream_t s = (cudaStream_t)stream;
  return co_tile(Cout) == 64 ? launch<64>(a, B, s) : launch<32>(a, B, s);
}

// Blocks of one `upsample1d` launch at this shape, or -1 if it takes none.
extern "C" int upsample1d_blocks(int B, int Cin, int Cout, int T, int pad, int output_padding) {
  const int T_out = (T - 1) * 2 - 2 * pad + 4 + output_padding;
  if (B < 1 || Cin < 1 || Cin > kMaxCin || Cout % 32 != 0 || pad < 0 || T_out <= 0) return -1;
  const int q_hi = (T_out - 1 + pad) / 2;
  return ceil_div(q_hi - pad / 2 + 1, kN) * (Cout / co_tile(Cout)) * B;
}
