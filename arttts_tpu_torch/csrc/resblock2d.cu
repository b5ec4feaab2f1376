// K1: one whole U-Net ResnetBlock2d, with Rezero(LinearAttention2d) fused
// behind it where the block has one; its 3x3 and 1x1 products as implicit
// GEMMs on Hopper's tensor cores in 3xTF32.
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
// U-Net's up path is never materialised: staging reads each channel through
// its chunk's pointer.
//
// What bounds it on the H100: the products. The two 3x3 convolutions are
// 87% of the block's operations (83.9 of 96.7 GFLOP a score evaluation)
// and the 1x1 products (residual projection, attention qkv and output
// projection) most of the rest; even at 3xTF32 (three TF32 passes at
// 495 TFLOP/s dense) they bind over the block's bytes at every call of the
// U-Net. The GroupNorm and attention-core kernels below them are bytes
// and latency.
//
// The products take one of two routes. Route 1, `igemm_body` (the 1x1
// products, the bf16 mode, and the 3x3 products the caller does not send to
// route 2): an implicit GEMM with M = Cout, N = output pixels of a tile of R
// rows x 32 frames, K = KS*KS*Cin, in 3xTF32 on `mma.sync.m16n8k8` with
// float32 accumulation (tf32_mma.cuh). What its design does about the faults
// of the CUDA-core version it replaced:
// 1. Tensor cores instead of float32 FMAs: each warp computes a 32-channel x
//    32-pixel tile (2 m16 x 4 n8), so one k8 step splits 8 weights and 8
//    window values for 24 `mma`s.
// 2. Staging overlaps the `mma`s: a 2-stage `cp.async` ring over chunks of
//    8*WK input channels; chunk i+1's copies are in flight while chunk i's
//    `mma`s run. Each chunk's input window, (R + 2) x 34 per channel, is
//    staged once and all 9 taps read it from shared memory. Halo, sequence
//    edges, frames t >= lengths[b] and channels past Cin are copies with
//    src-size 0 (zero fill): no per-element branch in the inner loop.
// 3. Weights: torch's (Cout, Cin, 3, 3) (or (Cout, Cin)) is already the
//    row-major M x K operand; a chunk is 72*WK (8*WK) contiguous floats per
//    output channel and goes in 16-byte copies (4-byte ones when Cin is not
//    a multiple of 4: the 2-plane input of the first block).
// 4. Grid fill: the launcher takes, per shape, the first of three tiles that
//    gives every SM a block: 64 channels x 4 x 32 pixels (WK 1), 64 x 2 x 32
//    with the chunk's K split over two warp groups (WK 2), 32 x 2 x 32 split
//    over four (WK 4). The groups' sums meet in shared memory in a fixed
//    order. At the U-Net's bench shapes every 3x3 launch has 240 or 480
//    blocks and every 1x1 launch 180-2880, for 132 SMs (it was 36-240).
// 5. Bank conflicts: weight rows are padded to a pitch of 4 x odd words and
//    window channels to 8 mod 32 words, so the A and B fragments' 32 lanes
//    hit 32 banks.
// Its fault: every warp splits its fragments again at every tap (a window
// value once for each of the 9 taps and each warp row that reads it), and
// the split and the fragment loads, not the tensor cores, set its pace.
//
// Route 2, `wgmma_body` (`conv3x3_wgmma`; the float32 3x3 products whose
// input channels fill 8-channel chunks, at shapes where one of its tiles
// gives every SM a block: ops/resblock2d.py:conv3x3_route): the same GEMM
// on Hopper's warpgroup product `wgmma.m64n64k8` in 3xTF32 with both
// operands read from shared memory, each split exactly once:
// 1. A block is 64 channels x 4 or 2 rows x 64 frames. Two consumer
//    warpgroups issue only `wgmma`s (an m64n64 accumulator a row, 32
//    registers a thread); two producer warpgroups copy and split.
// 2. A chunk (8 input channels, all 9 taps) lands by `cp.async`: the weights
//    in 16-byte pieces as they lie in device memory, the window in 4-byte
//    copies with zero fill as in route 1, as [channel quad][pixel][4
//    channels] so that a tap's shift is a shift of the B descriptor's start.
//    The producers then split it once into TF32 high and low planes in
//    shared memory (truncating split: a window value as landed is its own
//    high part), transposing the weights into the A layout [tap][channel
//    quad][channel][4] on the way with 16-byte stores. Each tap and row is
//    then three `wgmma`s, lo.hi, hi.lo, hi.hi, into one accumulator.
// 3. A ring of 3 or 4 stages with `mbarrier`s (`ready`: split by every
//    producer; `empty`: both consumers' products done): the producers keep
//    copies kStages - 2 chunks ahead of the chunk they split, the consumers
//    two chunks' products in flight; no block-wide barrier in the loop.
// 4. What bounds it: shared memory. A stage holds both planes of both
//    operands (56-64 KB), so one block fits an SM and the smaller tile runs
//    in two waves where it has more blocks than SMs; the `wgmma`s' operand
//    reads (4 KB a product) and the producers' copies and split share the
//    SM's shared-memory bandwidth and add up rather than overlap. A chunk's
//    weights serve only the block's rows, so a one-row tile (the only one
//    that gives every SM a block at 20 x 192, C = 256) spends as long
//    splitting weights as multiplying, and lost to route 1: the caller
//    keeps such shapes on route 1 (scripts/resblock2d_variants.py times
//    both routes and their parts).
// Both routes' kernels are `conv3x3_kernel` templates: a profile files them
// under one name.
//
// GroupNorm needs statistics over the whole image before any element can be
// normalised: the 3x3 epilogue adds the bias, stores the raw output and
// writes one (sum, sum of squares) partial per tile and 8-channel slot, and
// `gn_stats_kernel` reduces the partials in a fixed order in double
// precision. No float atomics and no split K across blocks: a second call
// gives the same bits.
//
// bf16 mode (the `_bf16` launchers; `bf16=True`, the default of the JAX
// kernel's wrappers): the function of `_resblock_kernel` with bf16 dots.
// The products' operands are rounded to bf16 (to nearest, ties to even) as
// the fragments are built from the same float32 staging: x*m (or the
// block's h) and w1/w2, x*m and W_res, y and W_qkv, and the attention's
// output and g*W_o (the Rezero gain folded into the weight and bias before
// rounding, as `pack_attn_params` does; the kernel folds it). Each pair of
// taps is one `mma.sync.m16n8k16` bf16 step with float32 accumulation
// (bf16_mma.cuh), the ninth tap and a 1x1 product's one padded with zeros.
// The attention core rounds where the TPU kernel does: k stays float32
// (its max, exp(k - max) and the sum S too), v = bf16(y Wv), the context
// bf16(v)^T bf16(exp(k - max)) is summed in float32 and rounded after the
// division by S, q = bf16(y Wq), and q ctx is summed in float32; its 32x32
// per-head contractions stay on the CUDA cores. GroupNorm statistics, mish,
// the time embedding and the residual sum are float32 in both modes. The
// kernels are templated on the mode: the float32 instantiations are the
// code above.
#include "bf16_mma.cuh"
#include "common.cuh"
#include "tf32_mma.cuh"

namespace {

using arttts::ceil_div;
using arttts::cp_async16;
using arttts::cp_async4;
using arttts::cp_async_commit;
using arttts::cp_async_wait;
using arttts::fence_acc;
using arttts::fence_proxy_async;
using arttts::kThreads;
using arttts::mbar_arrive;
using arttts::mbar_init;
using arttts::mbar_init_fence;
using arttts::mbar_wait;
using arttts::mish;
using arttts::mma3;
using arttts::mma_bf16;
using arttts::pack_bf16;
using arttts::round_bf16;
using arttts::set_smem;
using arttts::sm_count;
using arttts::split_tf32;
using arttts::wgmma_commit;
using arttts::wgmma_desc;
using arttts::wgmma_fence;
using arttts::wgmma_m64n64k8;
using arttts::wgmma_wait;

constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;
constexpr int kCols = 32;   // output frames of a tile row: a warp's 4 n8 tiles
constexpr int kGroups = 8;  // GroupNorm groups (the U-Net's `groups`)

// One product launch: out = W * x (+ bias), 3x3 with zero padding 1 or 1x1,
// over the input frames t < lengths[b] (all frames when `lengths` is null).
// Epilogue: raw store plus GroupNorm partials (`partial`), or the Rezero
// form out = resid + gain[0] * (W x + bias) (`resid`), or a plain store.
struct ConvArgs {
  const float* x0;
  const float* x1;
  int c0, c1;  // channels of the two input chunks (c1 = 0: one chunk)
  const int* lengths;
  const float* w;
  const float* bias;
  const float* resid;
  const float* gain;
  float* out;
  float* partial;
  int H, T, Cout, masked_stats;
};

// A block: WM x WN x WK warps. Warp (wm, wn, wk) computes output channels
// 32 wm..+31 of the block and row wn of its tile (32 frames, 4 n8 tiles),
// over channel group wk (8 channels) of every staged chunk.
template <int KS, int WM, int WN, int WK>
struct Tile {
  static constexpr int kTaps = KS * KS;
  static constexpr int kBM = 32 * WM;  // output channels of a block
  static constexpr int kRows = WN;     // output rows of a tile
  static constexpr int kCi = 8 * WK;   // input channels of a staged chunk
  static constexpr int kWinRows = kRows + KS - 1;
  static constexpr int kWinCols = kCols + KS - 1;
  static constexpr int kARow = kCi * kTaps;  // a chunk's weights of one output channel
  static constexpr int kAPitch = kARow + 4;  // 4 x odd
  static constexpr int kCiPitch = (kWinRows * kWinCols + 23) / 32 * 32 + 8;  // 8 mod 32
  static constexpr int kAStage = kBM * kAPitch;
  static constexpr int kStage = kAStage + kCi * kCiPitch;
  static constexpr int kPieces = kARow / 4;  // 16-byte pieces of a weight row
  static constexpr int kW16PerThread = (kBM * kPieces + kThreads - 1) / kThreads;
  static constexpr int kW4PerThread = (kBM * kARow + kThreads - 1) / kThreads;
  static constexpr int kRed = (WK - 1) * WM * WN * 32 * 32;  // the groups' sums
  static constexpr int kSmemFloats = kStages * kStage > kRed ? kStages * kStage : kRed;
  static_assert(WM * WN * WK == kWarps, "8 warps");
  static_assert(kAPitch % 8 == 4, "A fragments: 8 rows x 4 columns on 32 banks");
  static_assert(kCiPitch % 32 == 8 && kCiPitch >= kWinRows * kWinCols, "B fragments");
  static_assert(kAStage % 4 == 0 && kStage % 4 == 0, "16-byte aligned stages");
};

template <int KS, int WM, int WN, int WK, bool BF16>
__device__ __forceinline__ void igemm_body(const ConvArgs& a) {
  using Tl = Tile<KS, WM, WN, WK>;
  constexpr int kHalo = KS / 2;
  extern __shared__ __align__(16) float smem[];
  __shared__ float stats_s[WN][4 * WM][2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % WM, wn = (warp / WM) % WN, wk = warp / (WM * WN);
  const int H = a.H, T = a.T;
  const int tiles_t = ceil_div(T, kCols);
  const int h0 = (blockIdx.x / tiles_t) * Tl::kRows;
  const int t0 = (blockIdx.x % tiles_t) * kCols;
  const int co0 = blockIdx.y * Tl::kBM;
  const int b = blockIdx.z;
  const int len = a.lengths != nullptr ? min(a.lengths[b], T) : T;
  const int Cin = a.c0 + a.c1;
  const size_t plane = (size_t)H * T;
  const float* xb0 = a.x0 + (size_t)b * a.c0 * plane;
  const float* xb1 = a.c1 > 0 ? a.x1 + (size_t)b * a.c1 * plane : a.x0;
  const int w_row = Cin * Tl::kTaps;  // weights of one output channel
  const float* wb = a.w + (size_t)co0 * w_row;
  const bool w16 = Cin % 4 == 0;

  // window staging: warp w copies the chunk's channels w, w + 8, ..., all
  // rows; lane l takes window column l (lanes l < KS - 1 also column 32 + l)
  const int col_a = t0 - kHalo + lane, col_b = t0 - kHalo + kCols + lane;
  const bool ok_a = col_a >= 0 && col_a < len;
  const bool ok_b = lane < KS - 1 && col_b < len;

  auto load = [&](int chunk, int slot) {
    float* As = smem + slot * Tl::kStage;
    float* Bs = As + Tl::kAStage;
    const int ci0 = chunk * Tl::kCi;
    const int j0 = ci0 * Tl::kTaps;  // first K index of the chunk
    if (w16) {
#pragma unroll
      for (int k = 0; k < Tl::kW16PerThread; ++k) {
        const int i = tid + k * kThreads;
        if (i < Tl::kBM * Tl::kPieces) {
          const int co = i / Tl::kPieces, q = i % Tl::kPieces;
          const bool ok = j0 + 4 * q < w_row;  // Cin % 4 == 0: a piece is all in or all out
          cp_async16(As + co * Tl::kAPitch + 4 * q,
                     ok ? wb + (size_t)co * w_row + j0 + 4 * q : a.w, ok);
        }
      }
    } else {
      for (int k = 0; k < Tl::kW4PerThread; ++k) {
        const int i = tid + k * kThreads;
        if (i < Tl::kBM * Tl::kARow) {
          const int co = i / Tl::kARow, j = i % Tl::kARow;
          const bool ok = j0 + j < w_row;
          cp_async4(As + co * Tl::kAPitch + j, ok ? wb + (size_t)co * w_row + j0 + j : a.w, ok);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < WK; ++c) {
      const int cl = warp + kWarps * c, ci = ci0 + cl;
      const float* src = ci < a.c0 ? xb0 + (size_t)ci * plane : xb1 + (size_t)(ci - a.c0) * plane;
      float* dst = Bs + cl * Tl::kCiPitch + lane;
#pragma unroll
      for (int rr = 0; rr < Tl::kWinRows; ++rr) {
        const int row = h0 - kHalo + rr;
        const bool rok = ci < Cin && row >= 0 && row < H;
        const float* s = src + (ptrdiff_t)row * T;
        cp_async4(dst + rr * Tl::kWinCols, rok && ok_a ? s + col_a : a.x0, rok && ok_a);
        if (KS > 1 && lane < KS - 1)
          cp_async4(dst + rr * Tl::kWinCols + kCols, rok && ok_b ? s + col_b : a.x0,
                    rok && ok_b);
      }
    }
  };

  float acc[2][4][4];  // [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

  const int n_chunks = ceil_div(Cin, Tl::kCi);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_chunks) load(s, s);
    cp_async_commit();
  }
  // this warp's fragments: A rows 32 wm + g (+8, +16, +24), K columns
  // (8 wk + t) taps + tap (+4 channels); B channel 8 wk + t (+4), window row
  // wn + kh, column 8 nt + g + kw
  const float* Aw0 = smem + (32 * wm + g) * Tl::kAPitch + (8 * wk + t) * Tl::kTaps;
  const float* Bw0 = smem + Tl::kAStage + (8 * wk + t) * Tl::kCiPitch + wn * Tl::kWinCols + g;
  // the Rezero form's gain: the bf16 mode multiplies the weights by it before
  // rounding and the bias in the epilogue, as `pack_attn_params` folds it
  const float gain = a.resid != nullptr ? a.gain[0] : 0.f;
  const float wgain = BF16 && a.resid != nullptr ? gain : 1.f;
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk c has landed, and every warp is done with chunk c-1
    if (c + kStages - 1 < n_chunks) load(c + kStages - 1, (c + kStages - 1) % kStages);
    cp_async_commit();
    const float* Aw = Aw0 + (c % kStages) * Tl::kStage;
    const float* Bw = Bw0 + (c % kStages) * Tl::kStage;
    if constexpr (BF16) {
      // tap pairs (0, 1), (2, 3), ...; an odd tap count pads the last pair
#pragma unroll
      for (int pr = 0; pr < (Tl::kTaps + 1) / 2; ++pr) {
        const int tap0 = 2 * pr, tap1 = 2 * pr + 1;
        const bool two = tap1 < Tl::kTaps;
        uint32_t af[2][4], bf[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float* p = Aw + 16 * mt * Tl::kAPitch;
#pragma unroll
          for (int r = 0; r < 4; ++r) {  // rows g, g+8 x channels t, t+4
            const float* q = p + (r & 1) * 8 * Tl::kAPitch + (r >> 1) * 4 * Tl::kTaps;
            if constexpr (KS == 1)  // the Rezero gain folded in before rounding: bf16(g W_o)
              af[mt][r] = pack_bf16(wgain * q[tap0], two ? wgain * q[tap1] : 0.f);
            else
              af[mt][r] = pack_bf16(q[tap0], two ? q[tap1] : 0.f);
          }
        }
        const int off0 = (tap0 / KS) * Tl::kWinCols + tap0 % KS;
        const int off1 = two ? (tap1 / KS) * Tl::kWinCols + tap1 % KS : off0;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {  // channels t, t+4
            const float* q = Bw + r * 4 * Tl::kCiPitch + 8 * nt;
            bf[nt][r] = pack_bf16(q[off0], two ? q[off1] : 0.f);
          }
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], af[mt], bf[nt]);
      }
      continue;
    }
#pragma unroll
    for (int kh = 0; kh < KS; ++kh) {
#pragma unroll
      for (int kw = 0; kw < KS; ++kw) {
        const int tap = kh * KS + kw;
        uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float* p = Aw + 16 * mt * Tl::kAPitch + tap;
          split_tf32(p[0], ah[mt][0], al[mt][0]);
          split_tf32(p[8 * Tl::kAPitch], ah[mt][1], al[mt][1]);
          split_tf32(p[4 * Tl::kTaps], ah[mt][2], al[mt][2]);
          split_tf32(p[8 * Tl::kAPitch + 4 * Tl::kTaps], ah[mt][3], al[mt][3]);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int off = kh * Tl::kWinCols + kw + 8 * nt;
          split_tf32(Bw[off], bh[nt][0], bl[nt][0]);
          split_tf32(Bw[4 * Tl::kCiPitch + off], bh[nt][1], bl[nt][1]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma3(acc[mt], ah[mt], al[mt], bh, bl);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free

  if (WK > 1) {  // group wk > 0 hands its sums to group 0, added in the order of wk
    const int wmn = warp % (WM * WN);
    if (wk > 0) {
      float* r = smem + ((wk - 1) * WM * WN + wmn) * 1024 + lane;
#pragma unroll
      for (int v = 0; v < 32; ++v) r[32 * v] = acc[v / 16][(v / 4) % 4][v % 4];
    }
    __syncthreads();
    if (wk == 0) {
      for (int kk = 1; kk < WK; ++kk) {
        const float* r = smem + ((kk - 1) * WM * WN + wmn) * 1024 + lane;
#pragma unroll
        for (int v = 0; v < 32; ++v) acc[v / 16][(v / 4) % 4][v % 4] += r[32 * v];
      }
    }
  }

  // epilogue (group 0): bias, the Rezero form or the raw store, and this
  // lane's share of the GroupNorm partials of its four 8-channel slots
  const int row = h0 + wn;
  float s1[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, s2[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  if (wk == 0 && row < H) {
    const float rgain = BF16 ? 1.f : gain;  // the gain still to apply to W x + bias
    const bool vec = !(T & 1);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int co = co0 + 32 * wm + 16 * mt + 8 * h + g;
        const float bv = a.bias != nullptr ? wgain * a.bias[co] : 0.f;
        const size_t o = ((size_t)(b * a.Cout + co) * H + row) * T;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = t0 + 8 * nt + 2 * t;
          if (col >= T) continue;
          const bool two = col + 1 < T;
          float v0 = acc[mt][nt][2 * h] + bv, v1 = acc[mt][nt][2 * h + 1] + bv;
          if (a.resid != nullptr) {
            v0 = a.resid[o + col] + rgain * v0;
            v1 = two ? a.resid[o + col + 1] + rgain * v1 : 0.f;
          }
          float* p = a.out + o + col;
          if (vec && two) {
            *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
          } else {
            p[0] = v0;
            if (two) p[1] = v1;
          }
          if (!a.masked_stats || col < len) {
            s1[mt][h] += v0;
            s2[mt][h] += v0 * v0;
          }
          if (two && (!a.masked_stats || col + 1 < len)) {
            s1[mt][h] += v1;
            s2[mt][h] += v1 * v1;
          }
        }
      }
    }
  }
  if (a.partial == nullptr) return;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) {
        s1[mt][h] += __shfl_xor_sync(0xffffffffu, s1[mt][h], m);
        s2[mt][h] += __shfl_xor_sync(0xffffffffu, s2[mt][h], m);
      }
      if (wk == 0 && lane == 0) {
        stats_s[wn][4 * wm + 2 * mt + h][0] = s1[mt][h];
        stats_s[wn][4 * wm + 2 * mt + h][1] = s2[mt][h];
      }
    }
  }
  __syncthreads();
  if (tid < 4 * WM) {  // one partial per 8-channel slot and tile: the rows in order
    float x = 0.f, q = 0.f;
#pragma unroll
    for (int r = 0; r < WN; ++r) {
      x += stats_s[r][tid][0];
      q += stats_s[r][tid][1];
    }
    const int slot = co0 / 8 + tid;
    float* dst = a.partial + (((size_t)b * (a.Cout / 8) + slot) * gridDim.x + blockIdx.x) * 2;
    dst[0] = x;
    dst[1] = q;
  }
}

template <int WM, int WN, int WK, bool BF16>
__global__ void __launch_bounds__(kThreads, 2) conv3x3_kernel(const ConvArgs a) {
  igemm_body<3, WM, WN, WK, BF16>(a);
}

template <int WM, int WN, int WK, bool BF16>
__global__ void __launch_bounds__(kThreads, 2) conv1x1_kernel(const ConvArgs a) {
  igemm_body<1, WM, WN, WK, BF16>(a);
}

// The three tiles, largest first: (WM, WN, WK).
constexpr int kTileShapes[3][3] = {{2, 4, 1}, {2, 2, 2}, {1, 2, 4}};

int tile_blocks(int cfg, int B, int Cout, int H, int T) {
  const int wm = kTileShapes[cfg][0], wn = kTileShapes[cfg][1];
  return ceil_div(H, wn) * ceil_div(T, kCols) * (Cout / (32 * wm)) * B;
}

// The first tile that gives every SM a block (the last one where none does),
// or minus a CUDA error code.
int pick_tile(int B, int Cout, int H, int T) {
  const int sms = sm_count();
  if (sms < 0) return sms;
  for (int cfg = 0; cfg < 2; ++cfg)
    if (tile_blocks(cfg, B, Cout, H, T) >= sms) return cfg;
  return 2;
}

template <int KS, int WM, int WN, int WK, bool BF16>
int launch_tile(const ConvArgs& a, int B, cudaStream_t stream) {
  using Tl = Tile<KS, WM, WN, WK>;
  void (*kernel)(const ConvArgs) =
      KS == 3 ? conv3x3_kernel<WM, WN, WK, BF16> : conv1x1_kernel<WM, WN, WK, BF16>;
  const size_t smem = sizeof(float) * Tl::kSmemFloats;
  static const int attr = set_smem(kernel, smem);
  if (attr) return attr;
  const dim3 grid(ceil_div(a.H, WN) * ceil_div(a.T, kCols), a.Cout / Tl::kBM, B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  ARTTTS_CHECK_LAUNCH();
  return 0;
}

template <int KS, bool BF16>
int launch_conv(const ConvArgs& a, int B, void* stream) {
  if (a.Cout % 64 || a.c0 < 1 || a.c1 < 0 || a.H < 1 || a.T < 1)
    return (int)cudaErrorInvalidValue;
  const int cfg = pick_tile(B, a.Cout, a.H, a.T);
  if (cfg < 0) return -cfg;
  const cudaStream_t s = (cudaStream_t)stream;
  if (cfg == 0) return launch_tile<KS, 2, 4, 1, BF16>(a, B, s);
  if (cfg == 1) return launch_tile<KS, 2, 2, 2, BF16>(a, B, s);
  return launch_tile<KS, 1, 2, 4, BF16>(a, B, s);
}

// ---- the float32 3x3 product on `wgmma` (route 2 of the note above) -------
// A block: 64 output channels x 2 RPW rows x 64 frames, four warpgroups.
// Warpgroups 0 and 1 compute (consumers): warpgroup wg rows RPW wg..+RPW-1,
// one m64n64 accumulator a row. Warpgroups 2 and 3 (producers) copy and
// split the chunks.
constexpr int kWThreads = 512;
constexpr int kWHalf = kWThreads / 2;  // consumer threads; as many producers
constexpr int kWCols = 64;             // output frames of a tile row: a product's n
constexpr int kWWinCols = kWCols + 2;  // the window's columns
constexpr int kWCi = 8;  // input channels of a staged chunk: one k8 step a tap
// A plane (a chunk's weights, high or low parts): tap-major, each tap
// [channel quad][64 output channels][4 channels] (core matrices 8 channels x
// 16 bytes, 128 bytes apart along m, 1 KB along k). A chunk's weights land
// in the low plane first, as they lie in device memory, 72 floats a channel
// at a pitch of 76 (the split's gathers of one tap and channel quad then hit
// 32 banks).
constexpr int kTapStride = 2 * 64 * 4;
constexpr int kRawPitch = 76;
constexpr int kAPlane = 64 * kRawPitch;
constexpr int kPieces = 64 * kWCi * 9 / 4;  // 16-byte pieces of a chunk's weights
static_assert(9 * kTapStride <= kAPlane, "the taps fit in a plane");
static_assert(kPieces > 4 * kWHalf && kPieces <= 5 * kWHalf, "five rounds of pieces");

// the producers' own barrier (named barrier 1; the consumers never wait on it)
__device__ __forceinline__ void producers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kWHalf) : "memory");
}

template <int RPW>
struct WgmmaTile {
  static constexpr int kRows = 2 * RPW;  // output rows of a tile
  static constexpr int kWinRows = kRows + 2;
  // B plane: [channel quad][window pixel][4 channels] (K-major: a tap's
  // shift is a shift of the start by 16-byte pixels)
  static constexpr int kQuad = 4 * kWinRows * kWWinCols;
  static constexpr int kBPlane = 2 * kQuad;
  static constexpr int kUnits = 2 * kWinRows;  // (channel quad, window row) copy units
  // a stage: A high, A low, B as landed (its high parts), B low
  static constexpr int kStage = 2 * kAPlane + 2 * kBPlane;
  // as many stages as leave room for one block an SM (3 or 4)
  static constexpr int kStages = 4 * 4 * kStage <= 232448 - 1024 ? 4 : 3;
  static constexpr int kSmemBytes = 4 * kStages * kStage;
  static_assert(kAPlane % 4 == 0 && kQuad % 4 == 0 && kStage % 4 == 0, "16-byte starts");
  static_assert(kSmemBytes <= 232448 - 1024, "one block an SM");
  static_assert(kUnits <= 16, "two copy units a producer warp");
};

// The split (the truncating one of csrc/mrf.cu): hi = v with its low 13 bits
// cleared and lo = v - hi exactly, which the tensor core reads truncated to
// TF32. A window value as landed is its own high part: the tensor core reads
// a TF32 operand's top 19 bits.
__device__ __forceinline__ float trunc_tf32(float v) {
  return __uint_as_float(__float_as_uint(v) & 0xFFFFE000u);
}

template <int RPW>
__device__ __forceinline__ void wgmma_body(const ConvArgs& a) {
  using Tl = WgmmaTile<RPW>;
  constexpr int kStages = Tl::kStages;
  extern __shared__ __align__(128) float ring[];
  float* smem = ring;
  __shared__ __align__(8) uint64_t ready[kStages], empty[kStages];
  __shared__ float stats_s[2][8][2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, w4 = warp & 3, g = lane >> 2, t = lane & 3;
  const bool consumer = tid < kWHalf;
  const int pw = warp & 7;  // a producer's warp among the producers
  const int H = a.H, T = a.T;
  const int tiles_t = ceil_div(T, kWCols);
  const int h0 = (blockIdx.x / tiles_t) * Tl::kRows;
  const int t0 = (blockIdx.x % tiles_t) * kWCols;
  const int co0 = blockIdx.y * 64;
  const int b = blockIdx.z;
  const int len = a.lengths != nullptr ? min(a.lengths[b], T) : T;
  const int Cin = a.c0 + a.c1;
  const size_t plane = (size_t)H * T;
  const float* xb0 = a.x0 + (size_t)b * a.c0 * plane;
  const float* xb1 = a.c1 > 0 ? a.x1 + (size_t)b * a.c1 * plane : a.x0;
  const int w_row = Cin * 9;  // weights of one output channel

  // A chunk lands by copies (zero fill for the halo, the sequence edges and
  // frames t >= lengths[b]; the route takes whole chunks of channels).
  // Weights: the chunk's 64 rows of 72 floats (one contiguous run each in
  // device memory) land as 1,152 16-byte pieces, producer p taking pieces
  // p + 256 k. The split then has producer warp w hold output channels
  // 8w..8w+7, lane l channel 8w + l % 8 and the (tap, channel quad) pairs
  // l / 8 + 4 i: it gathers a pair's 4 channels from the landed row and
  // writes their high and low parts as one 16-byte store each.
  const int ptid = tid - kWHalf;
  int a_src[5], a_dst[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int piece = ptid + kWHalf * k, co = piece / 18, m = piece % 18;
    a_src[k] = co * w_row + 4 * m;
    a_dst[k] = co * kRawPitch + 4 * m;
  }
  const float* wb = a.w + (size_t)co0 * w_row;
  const int s_co = 8 * pw + (lane & 7), s_part = lane >> 3;
  // Window: unit u = (channel quad u / kWinRows, window row u % kWinRows);
  // producer warp w takes units w and w + 8, lane l channel l % 4 of the quad at
  // window columns l / 4 + 8 m (m = 0..8, the last for l < 8)
  auto unit_base = [&](int u) {  // this lane's first element of unit u in a B plane
    return (u / Tl::kWinRows) * Tl::kQuad + (u % Tl::kWinRows) * 4 * kWWinCols + lane;
  };
  auto unit_row = [&](int ci0, int u) -> const float* {  // its input row; null: zeros
    const int ci = ci0 + 4 * (u / Tl::kWinRows) + (lane & 3);
    const int row = h0 - 1 + u % Tl::kWinRows;
    if (ci >= Cin || row < 0 || row >= H) return nullptr;
    const float* src = ci < a.c0 ? xb0 + (size_t)ci * plane : xb1 + (size_t)(ci - a.c0) * plane;
    return src + (size_t)row * T;
  };
  const int col0 = t0 - 1 + (lane >> 2);

  auto load = [&](int chunk, int s) {
    float* As = smem + s * Tl::kStage;
    float* Bs = As + 2 * kAPlane;
    const int ci0 = chunk * kWCi;
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      if (k < 4 || ptid < kPieces - 4 * kWHalf)
        cp_async16(As + kAPlane + a_dst[k], wb + ci0 * 9 + a_src[k]);
    }
#pragma unroll
    for (int uu = 0; uu < 2; ++uu) {
      const int u = pw + 8 * uu;
      if (u < Tl::kUnits) {
        const int base = unit_base(u);
        const float* row = unit_row(ci0, u);
#pragma unroll
        for (int m = 0; m < 9; ++m) {
          if (m < 8 || lane < 8) {
            const int col = col0 + 8 * m;
            const bool ok = row != nullptr && col >= 0 && col < len;
            cp_async4(Bs + base + 32 * m, ok ? row + col : a.x0, ok);
          }
        }
      }
    }
  };
  auto split = [&](int s) {
    float* As = smem + s * Tl::kStage;
    float* Bs = As + 2 * kAPlane;
    producers_sync();  // every producer's pieces have landed
    float v[5][4];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const int pair = s_part + 4 * i, tap = pair % 9, q = pair / 9;
      if (pair < 18) {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[i][e] = As[kAPlane + s_co * kRawPitch + (4 * q + e) * 9 + tap];
      }
    }
    producers_sync();  // every piece is read before any is overwritten
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const int pair = s_part + 4 * i, tap = pair % 9, q = pair / 9;
      if (pair < 18) {
        float4 hi, lo;
        hi.x = trunc_tf32(v[i][0]), hi.y = trunc_tf32(v[i][1]);
        hi.z = trunc_tf32(v[i][2]), hi.w = trunc_tf32(v[i][3]);
        lo = make_float4(v[i][0] - hi.x, v[i][1] - hi.y, v[i][2] - hi.z, v[i][3] - hi.w);
        const int o = tap * kTapStride + q * 256 + s_co * 4;
        *reinterpret_cast<float4*>(As + o) = hi;
        *reinterpret_cast<float4*>(As + kAPlane + o) = lo;
      }
    }
#pragma unroll
    for (int uu = 0; uu < 2; ++uu) {
      const int u = pw + 8 * uu;
      if (u < Tl::kUnits) {
        const int base = unit_base(u);
#pragma unroll
        for (int m = 0; m < 9; ++m) {
          if (m < 8 || lane < 8) {
            const float x = Bs[base + 32 * m];
            Bs[Tl::kBPlane + base + 32 * m] = x - trunc_tf32(x);
          }
        }
      }
    }
  };

  float acc[RPW][32];
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int v = 0; v < 32; ++v) acc[r][v] = 0.f;

  // this warpgroup's first output row in the tile
  const int r0 = wg * RPW;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&ready[s], kWHalf);
      mbar_init(&empty[s], kWHalf);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // The ring. `ready[s]`: the chunk in stage s is split (all producers);
  // `empty[s]`: both consumer warpgroups' products on it are done, so it may
  // be refilled. Producers keep kStages - 2 chunks of copies in flight ahead
  // of the one they split; consumers keep two chunks' products in flight.
  const int n_chunks = ceil_div(Cin, kWCi);
  if (!consumer) {
    constexpr int kAhead = kStages - 2;
    for (int c = 0; c < n_chunks + kAhead; ++c) {
      if (c < n_chunks) {
        if (c >= kStages) mbar_wait(&empty[c % kStages], (c / kStages - 1) & 1);
        load(c, c % kStages);
      }
      cp_async_commit();
      const int cs = c - kAhead;  // the chunk to split now
      if (cs >= 0) {
        cp_async_wait<kAhead>();  // this thread's copies of chunk cs have landed
        split(cs % kStages);
        fence_proxy_async();
        mbar_arrive(&ready[cs % kStages]);
      }
    }
    cp_async_wait<0>();
  } else {
    for (int c = 0; c < n_chunks; ++c) {
      const int s = c % kStages;
      mbar_wait(&ready[s], (c / kStages) & 1);
      __syncwarp();  // converged for the warpgroup's `.sync.aligned` instructions
#pragma unroll
      for (int r = 0; r < RPW; ++r) fence_acc(acc[r]);
      wgmma_fence();
      {  // chunk c's products: per tap, A descriptors of the tap (core matrices
         // 128 bytes apart along m, 1 KB along k) and B descriptors of the
         // window shifted to the tap (128 bytes along n, a quad's plane along k)
        const uint32_t As = arttts::smem_addr(smem + s * Tl::kStage);
        const uint32_t Bs = As + 4 * 2 * kAPlane;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const uint32_t ah = As + 4 * tap * kTapStride;
          const uint64_t dah = wgmma_desc(ah, 1024, 128);
          const uint64_t dal = wgmma_desc(ah + 4 * kAPlane, 1024, 128);
#pragma unroll
          for (int r = 0; r < RPW; ++r) {
            const uint32_t bh = Bs + 16 * ((r0 + r + tap / 3) * kWWinCols + tap % 3);
            const uint64_t dbh = wgmma_desc(bh, 4 * Tl::kQuad, 128);
            const uint64_t dbl = wgmma_desc(bh + 4 * Tl::kBPlane, 4 * Tl::kQuad, 128);
            wgmma_m64n64k8(acc[r], dal, dbh);  // the small terms first
            wgmma_m64n64k8(acc[r], dah, dbl);
            wgmma_m64n64k8(acc[r], dah, dbh);
          }
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // this warpgroup's products on chunk c-1 are done
#pragma unroll
      for (int r = 0; r < RPW; ++r) fence_acc(acc[r]);
      if (c > 0) mbar_arrive(&empty[(c - 1) % kStages]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int r = 0; r < RPW; ++r) fence_acc(acc[r]);
  }
  __syncthreads();  // the ring is free

  // epilogue: bias, the raw store, and this lane's share of the GroupNorm
  // partials of its warp's two 8-channel slots
  float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
  if (consumer) {
    const bool vec = !(T & 1);
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = h0 + r0 + r;
      if (row >= H) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int co = co0 + 16 * w4 + 8 * h + g;
        const float bv = a.bias != nullptr ? a.bias[co] : 0.f;
        const size_t o = ((size_t)(b * a.Cout + co) * H + row) * T;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = t0 + 8 * j + 2 * t;
          if (col >= T) continue;
          const bool two = col + 1 < T;
          const float v0 = acc[r][4 * j + 2 * h] + bv, v1 = acc[r][4 * j + 2 * h + 1] + bv;
          float* p = a.out + o + col;
          if (vec && two) {
            *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
          } else {
            p[0] = v0;
            if (two) p[1] = v1;
          }
          if (!a.masked_stats || col < len) {
            s1[h] += v0;
            s2[h] += v0 * v0;
          }
          if (two && (!a.masked_stats || col + 1 < len)) {
            s1[h] += v1;
            s2[h] += v1 * v1;
          }
        }
      }
    }
  }
  if (a.partial == nullptr) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      s1[h] += __shfl_xor_sync(0xffffffffu, s1[h], m);
      s2[h] += __shfl_xor_sync(0xffffffffu, s2[h], m);
    }
    if (consumer && lane == 0) {
      stats_s[wg][2 * w4 + h][0] = s1[h];
      stats_s[wg][2 * w4 + h][1] = s2[h];
    }
  }
  __syncthreads();
  if (tid < 8) {  // one partial per 8-channel slot and tile: the warpgroups in order
    float* dst =
        a.partial + (((size_t)b * (a.Cout / 8) + co0 / 8 + tid) * gridDim.x + blockIdx.x) * 2;
    dst[0] = stats_s[0][tid][0] + stats_s[1][tid][0];
    dst[1] = stats_s[0][tid][1] + stats_s[1][tid][1];
  }
}

// Another template of the same name as the `mma.sync` body's: a profile
// files both under `conv3x3_kernel`.
template <int RPW>
__global__ void __launch_bounds__(kWThreads, 1)
    conv3x3_kernel(const ConvArgs a, WgmmaTile<RPW>) {
  wgmma_body<RPW>(a);
}

// Blocks of the route's launch with tiles of `rows` rows.
int wgmma_tile_blocks(int rows, int B, int Cout, int H, int T) {
  return ceil_div(H, rows) * ceil_div(T, kWCols) * (Cout / 64) * B;
}

template <int RPW>
int wgmma_info(int* out) {
  using Tl = WgmmaTile<RPW>;
  void (*kernel)(const ConvArgs, WgmmaTile<RPW>) = conv3x3_kernel<RPW>;
  static const int attr = set_smem(kernel, Tl::kSmemBytes);
  if (attr) return attr;
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], kernel, kWThreads,
                                                      Tl::kSmemBytes);
  out[0] = e == cudaSuccess ? fa.numRegs : 0;
  out[2] = Tl::kSmemBytes;
  return (int)e;
}

template <int RPW>
int launch_wgmma(const ConvArgs& a, int B, cudaStream_t stream) {
  using Tl = WgmmaTile<RPW>;
  void (*kernel)(const ConvArgs, WgmmaTile<RPW>) = conv3x3_kernel<RPW>;
  static const int attr = set_smem(kernel, Tl::kSmemBytes);
  if (attr) return attr;
  const dim3 grid(ceil_div(a.H, Tl::kRows) * ceil_div(a.T, kWCols), a.Cout / 64, B);
  kernel<<<grid, kWThreads, Tl::kSmemBytes, stream>>>(a, WgmmaTile<RPW>{});
  ARTTTS_CHECK_LAUNCH();
  return 0;
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

// x, or x rounded to bf16 in the bf16 mode
template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (BF16) return round_bf16(x);
  return x;
}

template <bool BF16>
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
      ke_s[row][p] = in ? rnd<BF16>(expf(k[(size_t)row * P + gp] - m_s[row])) : 0.f;
      v_s[row][p] = in ? rnd<BF16>(v[(size_t)row * P + gp]) : 0.f;
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
template <bool BF16>
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
  for (int j = 0; j < 4; ++j) dst[j] = rnd<BF16>(acc[j] / s_s[d]);
}

// out[b, head*32 + e, p] = sum_d ctx[b, head, d, e] * q[b, head*32 + d, p].
// Grid: (ceil(P / 128), 4, B).
constexpr int kQP = 128;

template <bool BF16>
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
    q_s[row][p] = p0 + p < P ? rnd<BF16>(q[(size_t)row * P + p0 + p]) : 0.f;
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

template <bool BF16>
int attention(const float* qkv, float* kpart, float* cpart, float* ctx, float* ao, int B, int P,
              cudaStream_t s) {
  const int n_chunks = ceil_div(P, kChunk);
  attn_kstats_kernel<<<dim3(n_chunks, kHd, B), kThreads, 0, s>>>(qkv, kpart, P);
  ARTTTS_CHECK_LAUNCH();
  attn_ctx_partial_kernel<BF16><<<dim3(n_chunks, 4, B), kThreads, 0, s>>>(qkv, kpart, cpart, P);
  ARTTTS_CHECK_LAUNCH();
  attn_ctx_final_kernel<BF16><<<dim3(4, B), kThreads, 0, s>>>(kpart, cpart, ctx, n_chunks);
  ARTTTS_CHECK_LAUNCH();
  attn_qctx_kernel<BF16><<<dim3(ceil_div(P, kQP), 4, B), kThreads, 0, s>>>(qkv, ctx, ao, P);
  ARTTTS_CHECK_LAUNCH();
  return 0;
}

}  // namespace

// ---------------------------------------------------------------------------
// Launchers (plain C interface; the Python wrapper checks shapes and types)
// ---------------------------------------------------------------------------

// Pixel tiles (grid x) of a product launch at this shape, or minus a CUDA
// error code: the GroupNorm partials hold one entry per tile. `rows`: 0 for
// the `mma.sync` body (`conv3x3`, `conv1x1`: its own pick of tile), else the
// rows of the `wgmma` route's tile (`conv3x3_wgmma`).
extern "C" int conv_tiles(int B, int Cout, int H, int T, int rows) {
  if (rows > 0) return ceil_div(H, rows) * ceil_div(T, kWCols);
  const int cfg = pick_tile(B, Cout, H, T);
  return cfg < 0 ? cfg : ceil_div(H, kTileShapes[cfg][1]) * ceil_div(T, kCols);
}

// Blocks of a product launch at this shape, or minus a CUDA error code.
extern "C" int conv_blocks(int B, int Cout, int H, int T, int rows) {
  if (rows > 0) return wgmma_tile_blocks(rows, B, Cout, H, T);
  const int cfg = pick_tile(B, Cout, H, T);
  return cfg < 0 ? cfg : tile_blocks(cfg, B, Cout, H, T);
}

// 3x3 convolution, stride 1, zero padding 1, on the masked input (frames
// t >= lengths[b] read as zero), plus bias; writes the raw output and the
// GroupNorm partials (B, Cout / 8, conv_tiles, 2).
extern "C" int conv3x3(const float* x0, int c0, const float* x1, int c1, const int* lengths,
                       const float* w, const float* bias, float* out, float* partial, int B,
                       int H, int T, int Cout, int masked_stats, void* stream) {
  const ConvArgs a{x0, x1, c0, c1, lengths, w, bias, nullptr, nullptr, out, partial,
                   H, T, Cout, masked_stats};
  return launch_conv<3, false>(a, B, stream);
}

// The same product on the `wgmma` route, with tiles of `rows` (4 or 2)
// output rows x 64 frames x 64 channels; the partials are (B, Cout / 8,
// conv_tiles(..., rows), 2). The caller picks `rows`
// (ops/resblock2d.py:conv3x3_route).
extern "C" int conv3x3_wgmma(const float* x0, int c0, const float* x1, int c1,
                             const int* lengths, const float* w, const float* bias, float* out,
                             float* partial, int B, int H, int T, int Cout, int masked_stats,
                             int rows, void* stream) {
  if (Cout % 64 || (c0 + c1) % kWCi || c0 < 1 || c1 < 0 || H < 1 || T < 1)
    return (int)cudaErrorInvalidValue;
  const ConvArgs a{x0, x1, c0, c1, lengths, w, bias, nullptr, nullptr, out, partial,
                   H, T, Cout, masked_stats};
  const cudaStream_t s = (cudaStream_t)stream;
  if (rows == 4) return launch_wgmma<2>(a, B, s);
  if (rows == 2) return launch_wgmma<1>(a, B, s);
  return (int)cudaErrorInvalidValue;
}

// What the runtime makes of the `wgmma` route's kernel with tiles of `rows`
// rows: out[0] registers a thread, out[1] blocks an SM, out[2] bytes of
// dynamic shared memory a block. Returns a CUDA error code.
extern "C" int conv_wgmma_info(int rows, int* out) {
  if (rows == 4) return wgmma_info<2>(out);
  if (rows == 2) return wgmma_info<1>(out);
  return (int)cudaErrorInvalidValue;
}

// The same in the bf16 mode: operands rounded to bf16, float32 sums.
extern "C" int conv3x3_bf16(const float* x0, int c0, const float* x1, int c1,
                            const int* lengths, const float* w, const float* bias, float* out,
                            float* partial, int B, int H, int T, int Cout, int masked_stats,
                            void* stream) {
  const ConvArgs a{x0, x1, c0, c1, lengths, w, bias, nullptr, nullptr, out, partial,
                   H, T, Cout, masked_stats};
  return launch_conv<3, true>(a, B, stream);
}

// 1x1 convolution: out = W x + bias (bias may be null), or the Rezero form
// out = resid + gain[0] * (W x + bias) when `resid` is given; x masked to
// frames t < lengths[b] when `lengths` is given.
extern "C" int conv1x1(const float* x0, int c0, const float* x1, int c1, const int* lengths,
                       const float* w, const float* bias, const float* resid, const float* gain,
                       float* out, int B, int Cout, int H, int T, void* stream) {
  const ConvArgs a{x0, x1, c0, c1, lengths, w, bias, resid, gain, out, nullptr,
                   H, T, Cout, 0};
  return launch_conv<1, false>(a, B, stream);
}

// The same in the bf16 mode; the Rezero form rounds g W, not W, and adds
// g bias: out = resid + (bf16(g W) bf16(x) + g bias).
extern "C" int conv1x1_bf16(const float* x0, int c0, const float* x1, int c1,
                            const int* lengths, const float* w, const float* bias,
                            const float* resid, const float* gain, float* out, int B, int Cout,
                            int H, int T, void* stream) {
  const ConvArgs a{x0, x1, c0, c1, lengths, w, bias, resid, gain, out, nullptr,
                   H, T, Cout, 0};
  return launch_conv<1, true>(a, B, stream);
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

extern "C" int attn_chunks(int P) { return ceil_div(P, kChunk); }

// qkv (B, 384, P) -> ao (B, 128, P) = q ctx; kpart, cpart, ctx are scratch
// of attn_chunks(P) chunks.
extern "C" int attention_core(const float* qkv, float* kpart, float* cpart, float* ctx,
                              float* ao, int B, int P, void* stream) {
  return attention<false>(qkv, kpart, cpart, ctx, ao, B, P, (cudaStream_t)stream);
}

// The same with the bf16 mode's rounding points (v, exp(k - max), ctx, q).
extern "C" int attention_core_bf16(const float* qkv, float* kpart, float* cpart, float* ctx,
                                   float* ao, int B, int P, void* stream) {
  return attention<true>(qkv, kpart, cpart, ctx, ao, B, P, (cudaStream_t)stream);
}
