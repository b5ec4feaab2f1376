// K2 and K3: the stride-2 convolutions at the U-Net's resolution boundaries,
// as implicit GEMMs on Hopper's tensor cores in 3xTF32.
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
// zero (lengths at the input's resolution). Cin must be a multiple of 8 and
// Cout of 64 (the wrappers check both).
//
// Arithmetic: float32 accuracy on the tensor cores by the 3xTF32 split
// (CUTLASS's name). Each operand a is split as a_hi = tf32(a) (cvt.rna:
// round to nearest, ties away) and a_lo = a - a_hi (which the tensor core
// reads truncated to TF32), and every product is a_lo*b_hi + a_hi*b_lo +
// a_hi*b_hi in `mma.sync.m16n8k8` TF32 with float32 accumulation; the
// dropped a_lo*b_lo term is about 2^-22 of a*b. A one-pass TF32 product
// (2^-11) would miss the port's 1e-4 tolerance at K = 1,152
// (tests/test_torch_kernels.py shows both on the CPU).
//
// What bounds them on the H100: the tensor cores. K2 is a GEMM of
// M = Cout, N = output pixels, K = 9*Cin; K3 four GEMMs (one per output
// parity class) of M = Cout, N = input pixels, K = 4*Cin. At the U-Net's
// shapes (1.13 and 2.01 GFLOP per call, three TF32 passes each against
// 10-20 MB of input and output) the operations bind over the bytes. On the
// card the copies from L2 (weights re-read by every pixel tile) and the
// `mma.sync` work each take about half the time and overlap little
// (`scripts/updown_variants.py` measures both).
//
// What the design does about the faults of the CUDA-core version it replaced:
// 1. Grid: 256-thread blocks of 64 output channels x 4 x 16 outputs (K2
//    at C=64), 64 x 2 x 16 (K2 at C=128: the larger tile would give 120
//    blocks) and 64 x (2 x 16 inputs = 4 x 32 outputs) (K3): 240 blocks
//    for K2 at both widths and K3 at C=128, 480 for K3 at C=64, for 132
//    SMs (it was 36-240).
// 2. Weight staging is coalesced. K2's torch weight (Cout, Cin, 3, 3) is
//    already the row-major M x K operand: each output channel's 72 floats of
//    a chunk go in 16-byte `cp.async` copies. K3's (Cin, Cout, 4, 4) is
//    contiguous over (co, tap) for each input channel: consecutive threads
//    copy consecutive floats (4-byte `cp.async`) and the destination
//    transposes them to [ci][tap][co] in shared memory, inside the kernel;
//    the wrappers take torch-layout weights and nothing is re-laid out in
//    device memory on any call.
// 3. Loads overlap the tensor cores: a ring of 2 stages over 8-channel
//    chunks of Cin; chunk i+1's copies are in flight while chunk i's `mma`s
//    run (3 stages measured no faster). The input window's halo, the
//    sequence edge and t >= len are 4-byte copies with src-size 0 (zero
//    fill).
// 4. Bank conflicts: each k8 step of the MMA holds one tap fixed and runs
//    over 8 input channels (lane % 4 -> channel). K2 splits the window's
//    even and odd input columns into two planes as it stages them (as the
//    TPU kernel splits them), so the stride-2 taps read unit-stride; the
//    channel pitch of every B operand is 8 (K3) or 24 (K2) mod 32 words (lane % 4 picks a
//    group of 8 banks, lane / 4 a bank in it) and K2's weight row pitch 76
//    spreads the A fragment's 32 lanes over 32 banks; K3's [ci][tap][co]
//    weight layout has a channel pitch of 8 mod 32 for the fragments and a
//    tap pitch of 2 mod 32 so the transposing copies do not conflict.
// 5. Tensor cores: TF32 `mma.sync` at 3 passes replaces float32 FMAs on the
//    CUDA cores. `mma.sync` over `wgmma`: the GEMMs are small (M <= 128,
//    K <= 1,152) and the split needs the operands in registers anyway.
// bf16 mode (`bf16` = 1, the JAX kernels' default `bf16=True`): the masked
// input and the weights are rounded to bf16 (to nearest, ties to even) as
// the fragments are built from the same float32 staging, and each pair of
// taps is one `mma.sync.m16n8k16` bf16 step with float32 accumulation
// (bf16_mma.cuh) where the float32 mode runs three TF32 steps per tap. K2's
// nine taps make five pairs, the last padded with zeros; K3's four taps a
// class make two. The kernels are templated on the mode: the float32
// instantiation is the 3xTF32 code above.
// K3 computes all four parity classes of its outputs from one staged input
// window (two warps per class, 4x reuse), stages the classes' outputs in
// shared memory and writes the interleaved 4 x 32 output patch of each
// channel with 16-byte stores. No atomics and no split K: every output is
// summed in one fixed order, so a call gives the same bits on every run.
#include "common.cuh"
#include "bf16_mma.cuh"
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
using arttts::sm_count;
using arttts::split_tf32;

constexpr int kWarps = 8;
constexpr int kThr = 32 * kWarps;
constexpr int kStages = 2;
constexpr int kCi = 8;  // input channels per pipeline chunk: one k8 MMA step per tap
constexpr int kCoTile = 64;

// ---- K2: 3x3 stride 2 --------------------------------------------------
// Block: 64 output channels x R (4 or 2) output rows x 16 output columns,
// 8 warps: warp w computes channels 16 (w % 4)..+15 over the n8 tiles
// q = R (w / 4)..+R-1 of the block's 2R (tile q: output row q / 2, columns
// 8 (q % 2)..+7). The launcher takes R = 4 where that still gives a block
// to every SM: fewer pixel tiles re-read fewer weights from L2.
// Grid (pixel tiles, Cout / 64, B).
constexpr int kDnCols = 16;
constexpr int kDnPlane = kDnCols + 1;  // even plane E[0..16], odd O[0..15]
constexpr int kDnRowPitch = 2 * kDnPlane;
constexpr int kDnAPitch = 76;  // conflict-free A fragments (8 rows x 4 channels)
constexpr int kDnPieces = 9 * kCi / 4;  // 16-byte pieces of a chunk's weight row

template <int R>
struct DnTile {
  static constexpr int kWinRows = 2 * R + 1;
  // >= kWinRows * kDnRowPitch and 24 mod 32: lane % 4 picks 8 banks
  static constexpr int kCiPitch = (kWinRows * kDnRowPitch + 7) / 32 * 32 + 24;
  static constexpr int kAStage = kCoTile * kDnAPitch;
  static constexpr int kStage = kAStage + kCi * kCiPitch;
  static constexpr int kWPerThread = (kCoTile * kDnPieces + kThr - 1) / kThr;
  static_assert(kCiPitch >= kWinRows * kDnRowPitch && kCiPitch % 32 == 24, "pitch");
  static_assert(kStage % 4 == 0 && kAStage % 4 == 0, "16-byte aligned stages");
};

template <int R, bool BF16>
__global__ void __launch_bounds__(kThr, 2)
downsample_kernel(const float* __restrict__ x, const int* __restrict__ lengths,
                  const float* __restrict__ w, const float* __restrict__ bias,
                  float* __restrict__ out, int Cin, int Cout, int H, int T, int Ho, int To) {
  using Tile = DnTile<R>;
  static_assert(kWarps == 8 && kCoTile == 64, "4 warp rows of 16 channels x 2 warp columns");
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const int tiles_t = ceil_div(To, kDnCols);
  const int oy0 = (blockIdx.x / tiles_t) * R;
  const int ox0 = (blockIdx.x % tiles_t) * kDnCols;
  const int co0 = blockIdx.y * kCoTile;
  const int b = blockIdx.z;
  const int len = min(lengths[b], T);
  const int iy0 = 2 * oy0 - 1, ix0 = 2 * ox0 - 1;
  const size_t plane = (size_t)H * T;
  const float* xb = x + (size_t)b * Cin * plane;

  // window staging: warp w copies input channel w of the chunk, all 2R+1
  // rows; lane l takes window column l (l = 0 also column 32)
  static_assert(kWarps == kCi, "a warp per input channel of a chunk");
  const bool col_a = ix0 + lane >= 0 && ix0 + lane < len, col_b = ix0 + 32 < len;
  const int s_a = (lane & 1) * kDnPlane + (lane >> 1);

  auto load = [&](int chunk, int stage) {
    float* As = smem + stage * Tile::kStage;
    float* Bs = As + Tile::kAStage;
    const int ci0 = chunk * kCi;
#pragma unroll
    for (int k = 0; k < Tile::kWPerThread; ++k) {
      const int i = tid + k * kThr;
      const int co = i / kDnPieces, q = i % kDnPieces;
      if (i < kCoTile * kDnPieces)
        cp_async16(As + co * kDnAPitch + 4 * q,
                   w + ((size_t)(co0 + co) * Cin + ci0) * 9 + 4 * q);
    }
    const float* xc = xb + (size_t)(ci0 + warp) * plane;
#pragma unroll
    for (int rr = 0; rr < Tile::kWinRows; ++rr) {
      const int row = iy0 + rr;
      const bool rok = row >= 0 && row < H;
      const float* src = xc + (ptrdiff_t)row * T + ix0;
      float* dst = Bs + warp * Tile::kCiPitch + rr * kDnRowPitch;
      cp_async4(dst + s_a, rok && col_a ? src + lane : xb, rok && col_a);
      if (lane == 0) cp_async4(dst + kDnCols, rok && col_b ? src + 32 : xb, rok && col_b);
    }
  };

  float acc[R][4];  // this warp's R n8 tiles
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int n_chunks = Cin / kCi;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_chunks) load(s, s);
    cp_async_commit();
  }
  const int q0 = wn * R;  // this warp's first n8 tile of the block
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk c has landed, and every warp is done with chunk c-1
    if (c + kStages - 1 < n_chunks) load(c + kStages - 1, (c + kStages - 1) % kStages);
    cp_async_commit();
    const float* As = smem + (c % kStages) * Tile::kStage;
    const float* Aw = As + (wm * 16 + g) * kDnAPitch + t * 9;
    const float* Bw = As + Tile::kAStage + t * Tile::kCiPitch + g;
    // window offset of tap (kh, kw) for n8 tile q of the block
    auto b_off = [](int q, int tap) {
      const int kh = tap / 3, kw = tap % 3;
      return (2 * (q >> 1) + kh) * kDnRowPitch + (kw & 1) * kDnPlane + (q & 1) * 8 + (kw >> 1);
    };
    if constexpr (BF16) {
#pragma unroll
      for (int pr = 0; pr < 5; ++pr) {  // tap pairs (0, 1) .. (8, pad)
        const int t0 = 2 * pr, t1 = 2 * pr + 1;
        const bool two = t1 < 9;
        uint32_t a[4], bb[R][2];
        a[0] = pack_bf16(Aw[t0], two ? Aw[t1] : 0.f);
        a[1] = pack_bf16(Aw[8 * kDnAPitch + t0], two ? Aw[8 * kDnAPitch + t1] : 0.f);
        a[2] = pack_bf16(Aw[36 + t0], two ? Aw[36 + t1] : 0.f);
        a[3] = pack_bf16(Aw[8 * kDnAPitch + 36 + t0], two ? Aw[8 * kDnAPitch + 36 + t1] : 0.f);
#pragma unroll
        for (int nt = 0; nt < R; ++nt) {
          const int q = q0 + nt;
          const float* p0 = Bw + b_off(q, t0);
          const float* p1 = Bw + b_off(q, two ? t1 : t0);
          bb[nt][0] = pack_bf16(p0[0], two ? p1[0] : 0.f);
          bb[nt][1] = pack_bf16(p0[4 * Tile::kCiPitch], two ? p1[4 * Tile::kCiPitch] : 0.f);
        }
#pragma unroll
        for (int nt = 0; nt < R; ++nt) mma_bf16(acc[nt], a, bb[nt]);
      }
    } else {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        uint32_t ah[4], al[4], bh[R][2], bl[R][2];
        split_tf32(Aw[tap], ah[0], al[0]);
        split_tf32(Aw[8 * kDnAPitch + tap], ah[1], al[1]);
        split_tf32(Aw[36 + tap], ah[2], al[2]);
        split_tf32(Aw[8 * kDnAPitch + 36 + tap], ah[3], al[3]);
#pragma unroll
        for (int nt = 0; nt < R; ++nt) {
          const int off = b_off(q0 + nt, tap);
          split_tf32(Bw[off], bh[nt][0], bl[nt][0]);
          split_tf32(Bw[4 * Tile::kCiPitch + off], bh[nt][1], bl[nt][1]);
        }
        mma3(acc, ah, al, bh, bl);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int co = co0 + wm * 16 + g + 8 * h;
    const float bv = bias[co];
#pragma unroll
    for (int nt = 0; nt < R; ++nt) {
      const int q = q0 + nt;
      const int oy = oy0 + (q >> 1), ox = ox0 + (q & 1) * 8 + 2 * t;
      if (oy >= Ho) continue;
      float* p = out + ((size_t)(b * Cout + co) * Ho + oy) * To + ox;
      const float v0 = acc[nt][2 * h] + bv, v1 = acc[nt][2 * h + 1] + bv;
      if (!(To & 1) && ox + 1 < To) {
        *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
      } else {
        if (ox < To) p[0] = v0;
        if (ox + 1 < To) p[1] = v1;
      }
    }
  }
}

// ---- K3: 4x4 stride 2 transposed --------------------------------------
// Block: 64 output channels x an input tile of 2 rows x 16 columns, which
// owns the outputs oy in [2*iy0, 2*iy0 + 4), ox in [2*ix0, 2*ix0 + 32).
// Output (oy, ox) = (2a + py, 2c + px) is a parity class (py, px); its taps
// are ky = 1 - py + 2*jy, kx = 1 - px + 2*jx (jy, jx in {0, 1}), reading
// input (a + py - jy, c + px - jx). Warp w computes class (py, px) =
// ((w % 4) / 2, w % 2) for channels 32 (w / 4)..+31 (2 m16 tiles) x 32
// positions (4 n8 tiles), K = 4 taps x Cin.
// Grid (tiles, Cout / 64, B).
constexpr int kUpRows = 2, kUpCols = 16;
constexpr int kUpWinRows = kUpRows + 2, kUpWinCols = kUpCols + 2;  // 4 x 18
constexpr int kUpCiPitchB = kUpWinRows * kUpWinCols;               // 72 = 8 mod 32
constexpr int kUpTapPitch = 66;    // 2 mod 32: the transposing copies spread over 32 banks
constexpr int kUpCiPitchA = 1064;  // >= 16 * 66, 8 mod 32
constexpr int kUpAStage = kCi * kUpCiPitchA;
constexpr int kUpStage = kUpAStage + kCi * kUpCiPitchB;
constexpr int kUpWin = kCi * kUpCiPitchB;
constexpr int kUpWinPerThread = (kUpWin + kThr - 1) / kThr;
constexpr int kUpWPerThread = kCi * kCoTile * 16 / kThr;
constexpr int kUpOutRow = 2 * kUpCols + 4;  // 36: a row of 32 outputs, padded
constexpr int kUpOutCo = 2 * kUpRows * kUpOutRow;
static_assert(kUpCiPitchB % 32 == 8 && kUpCiPitchA % 32 == 8 && kUpTapPitch % 32 == 2, "pitch");
static_assert(kUpCiPitchA >= 16 * kUpTapPitch && kUpTapPitch >= kCoTile, "pitch");
static_assert(kCoTile * kUpOutCo <= kStages * kUpStage, "output patch fits the ring");
static_assert((kCoTile * 16) % kThr == 0, "weight copies split evenly");

template <bool BF16>
__global__ void __launch_bounds__(kThr, 2)
convt_kernel(const float* __restrict__ x, const int* __restrict__ lengths,
             const float* __restrict__ w, const float* __restrict__ bias,
             float* __restrict__ out, int Cin, int Cout, int H, int T) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int py = (warp >> 1) & 1, px = warp & 1, m0 = 2 * (warp >> 2);
  const int Ho = 2 * H, To = 2 * T;
  const int tiles_t = ceil_div(T, kUpCols);
  const int iy0 = (blockIdx.x / tiles_t) * kUpRows;
  const int ix0 = (blockIdx.x % tiles_t) * kUpCols;
  const int co0 = blockIdx.y * kCoTile;
  const int b = blockIdx.z;
  const int len = min(lengths[b], T);
  const size_t plane = (size_t)H * T;
  const float* xb = x + (size_t)b * Cin * plane;

  // window rows iy0-1 .. iy0+2, columns ix0-1 .. ix0+16; its place in
  // shared memory is its index
  int win_g[kUpWinPerThread];
#pragma unroll
  for (int k = 0; k < kUpWinPerThread; ++k) {
    const int i = tid + k * kThr;
    const int ci = i / kUpCiPitchB;
    const int row = iy0 - 1 + (i / kUpWinCols) % kUpWinRows;
    const int col = ix0 - 1 + i % kUpWinCols;
    const bool ok = i < kUpWin && row >= 0 && row < H && col >= 0 && col < len;
    win_g[k] = ok ? (int)(ci * plane + (size_t)row * T + col) : -1;
  }
  // weight copies: thread tid takes float (tid + 256 * part) of each input
  // channel's contiguous (co, tap) block: tap = tid % 16, co = 16 * part + tid / 16
  const int w_tap = tid & 15, w_co = tid >> 4;
  const size_t w_ci_stride = (size_t)Cout * 16;
  const float* wb = w + (size_t)co0 * 16 + tid;

  auto load = [&](int chunk, int stage) {
    float* As = smem + stage * kUpStage;
    float* Bs = As + kUpAStage;
    const int ci0 = chunk * kCi;
#pragma unroll
    for (int k = 0; k < kUpWPerThread; ++k) {
      const int ci = k / 4, part = k % 4;
      cp_async4(As + ci * kUpCiPitchA + w_tap * kUpTapPitch + 16 * part + w_co,
                wb + (size_t)(ci0 + ci) * w_ci_stride + kThr * part, true);
    }
    const float* xc = xb + (size_t)ci0 * plane;
#pragma unroll
    for (int k = 0; k < kUpWinPerThread; ++k) {
      const int i = tid + k * kThr;
      if (i < kUpWin) cp_async4(Bs + i, xc + max(win_g[k], 0), win_g[k] >= 0);
    }
  };

  float acc[2][4][4];  // [m tile][n tile][fragment]
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

  const int n_chunks = Cin / kCi;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_chunks) load(s, s);
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (c + kStages - 1 < n_chunks) load(c + kStages - 1, (c + kStages - 1) % kStages);
    cp_async_commit();
    const float* As = smem + (c % kStages) * kUpStage;
    const float* Aw = As + t * kUpCiPitchA + g;
    const float* Bw = As + kUpAStage + t * kUpCiPitchB + g;
    // the class's weights and window offset at tap (jy, jx), n8 tile nt
    auto a_tap = [&](int jy, int jx) {
      return Aw + ((1 - py + 2 * jy) * 4 + (1 - px + 2 * jx)) * kUpTapPitch;
    };
    auto b_off = [&](int jy, int jx, int nt) {
      return ((nt >> 1) + 1 + py - jy) * kUpWinCols + (nt & 1) * 8 + 1 + px - jx;
    };
#pragma unroll
    for (int jy = 0; jy < 2; ++jy) {
      if constexpr (BF16) {  // one k16 step: taps (jy, 0) and (jy, 1)
        uint32_t bb[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float* p0 = Bw + b_off(jy, 0, nt);
          const float* p1 = Bw + b_off(jy, 1, nt);
          bb[nt][0] = pack_bf16(p0[0], p1[0]);
          bb[nt][1] = pack_bf16(p0[4 * kUpCiPitchB], p1[4 * kUpCiPitchB]);
        }
        const float* A0 = a_tap(jy, 0);
        const float* A1 = a_tap(jy, 1);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int m = 16 * (m0 + mt);
          const uint32_t a[4] = {
              pack_bf16(A0[m], A1[m]), pack_bf16(A0[m + 8], A1[m + 8]),
              pack_bf16(A0[4 * kUpCiPitchA + m], A1[4 * kUpCiPitchA + m]),
              pack_bf16(A0[4 * kUpCiPitchA + m + 8], A1[4 * kUpCiPitchA + m + 8])};
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a, bb[nt]);
        }
      } else {
#pragma unroll
        for (int jx = 0; jx < 2; ++jx) {
          const float* Ak = a_tap(jy, jx);
          uint32_t bh[4][2], bl[4][2];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int off = b_off(jy, jx, nt);
            split_tf32(Bw[off], bh[nt][0], bl[nt][0]);
            split_tf32(Bw[4 * kUpCiPitchB + off], bh[nt][1], bl[nt][1]);
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const int m = 16 * (m0 + mt);
            uint32_t ah[4], al[4];
            split_tf32(Ak[m], ah[0], al[0]);
            split_tf32(Ak[m + 8], ah[1], al[1]);
            split_tf32(Ak[4 * kUpCiPitchA + m], ah[2], al[2]);
            split_tf32(Ak[4 * kUpCiPitchA + m + 8], ah[3], al[3]);
            mma3(acc[mt], ah, al, bh, bl);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring becomes the output patch

  // class outputs -> the interleaved patch [co][4 rows][32 columns] + bias
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = (m0 + mt) * 16 + g + 8 * h;
      const float bv = bias[co0 + co];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int orow = 2 * (nt >> 1) + py;
          const int ocol = 2 * ((nt & 1) * 8 + 2 * t + e) + px;
          smem[co * kUpOutCo + orow * kUpOutRow + ocol] = acc[mt][nt][2 * h + e] + bv;
        }
      }
    }
  }
  __syncthreads();
  const int oy0 = 2 * iy0, ox0 = 2 * ix0;
  const bool vec = !(To & 3);
#pragma unroll 4
  for (int i = tid; i < kCoTile * 2 * kUpRows * 8; i += kThr) {
    const int co = i >> 5, orow = (i >> 3) & 3, q = i & 7;
    const int oy = oy0 + orow, ox = ox0 + 4 * q;
    if (oy >= Ho) continue;
    const float* s = smem + co * kUpOutCo + orow * kUpOutRow + 4 * q;
    float* p = out + ((size_t)(b * Cout + co0 + co) * Ho + oy) * To + ox;
    if (vec && ox + 3 < To) {
      *reinterpret_cast<float4*>(p) = *reinterpret_cast<const float4*>(s);
    } else {
      for (int e = 0; e < 4 && ox + e < To; ++e) p[e] = s[e];
    }
  }
}

struct DnArgs {
  const float *x;
  const int* lengths;
  const float *w, *bias;
  float* out;
  int B, Cin, Cout, H, T, Ho, To;
  cudaStream_t stream;
};

template <int R, bool BF16>
int launch_down(const DnArgs& a) {
  const size_t smem = sizeof(float) * kStages * DnTile<R>::kStage;
  static const int attr = set_smem(downsample_kernel<R, BF16>, smem);
  if (attr) return attr;
  const dim3 grid(ceil_div(a.Ho, R) * ceil_div(a.To, kDnCols), a.Cout / kCoTile, a.B);
  downsample_kernel<R, BF16><<<grid, kThr, smem, a.stream>>>(
      a.x, a.lengths, a.w, a.bias, a.out, a.Cin, a.Cout, a.H, a.T, a.Ho, a.To);
  ARTTTS_CHECK_LAUNCH();
  return 0;
}

template <bool BF16>
int launch_convt(const float* x, const int* lengths, const float* w, const float* bias,
                 float* out, int B, int Cin, int Cout, int H, int T, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kStages * kUpStage;
  static const int attr = set_smem(convt_kernel<BF16>, smem);
  if (attr) return attr;
  const dim3 grid(ceil_div(H, kUpRows) * ceil_div(T, kUpCols), Cout / kCoTile, B);
  convt_kernel<BF16><<<grid, kThr, smem, stream>>>(x, lengths, w, bias, out, Cin, Cout, H, T);
  ARTTTS_CHECK_LAUNCH();
  return 0;
}

template <bool BF16>
int downsample(const float* x, const int* lengths, const float* w, const float* bias,
               float* out, int B, int Cin, int Cout, int H, int T, void* stream) {
  if (Cin % kCi || Cout % kCoTile) return (int)cudaErrorInvalidValue;
  const int Ho = (H + 1) / 2, To = (T + 1) / 2;
  const int sms = sm_count();
  if (sms < 0) return -sms;
  const long blocks4 = (long)ceil_div(Ho, 4) * ceil_div(To, kDnCols) * (Cout / kCoTile) * B;
  const DnArgs a{x, lengths, w, bias, out, B, Cin, Cout, H, T, Ho, To, (cudaStream_t)stream};
  return blocks4 >= sms ? launch_down<4, BF16>(a) : launch_down<2, BF16>(a);
}

template <bool BF16>
int convt(const float* x, const int* lengths, const float* w, const float* bias, float* out,
          int B, int Cin, int Cout, int H, int T, void* stream) {
  if (Cin % kCi || Cout % kCoTile) return (int)cudaErrorInvalidValue;
  return launch_convt<BF16>(x, lengths, w, bias, out, B, Cin, Cout, H, T,
                            (cudaStream_t)stream);
}

}  // namespace

// float32 accuracy (3xTF32)
extern "C" int downsample3x3s2(const float* x, const int* lengths, const float* w,
                               const float* bias, float* out, int B, int Cin, int Cout,
                               int H, int T, void* stream) {
  return downsample<false>(x, lengths, w, bias, out, B, Cin, Cout, H, T, stream);
}

// the bf16 mode: bf16 operands, float32 sums
extern "C" int downsample3x3s2_bf16(const float* x, const int* lengths, const float* w,
                                    const float* bias, float* out, int B, int Cin, int Cout,
                                    int H, int T, void* stream) {
  return downsample<true>(x, lengths, w, bias, out, B, Cin, Cout, H, T, stream);
}

extern "C" int convt4x4s2(const float* x, const int* lengths, const float* w,
                          const float* bias, float* out, int B, int Cin, int Cout, int H,
                          int T, void* stream) {
  return convt<false>(x, lengths, w, bias, out, B, Cin, Cout, H, T, stream);
}

extern "C" int convt4x4s2_bf16(const float* x, const int* lengths, const float* w,
                               const float* bias, float* out, int B, int Cin, int Cout, int H,
                               int T, void* stream) {
  return convt<true>(x, lengths, w, bias, out, B, Cin, Cout, H, T, stream);
}
