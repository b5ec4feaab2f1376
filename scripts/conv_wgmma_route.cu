// Measurement only: K1's products (3x3 with the GroupNorm partials, 1x1)
// on Hopper's warpgroup product `wgmma.m64n32k8` in 3xTF32, the route tried
// against K1's `mma.sync` kernels (csrc/resblock2d.cu) and found slower
// over a score evaluation. scripts/resblock2d_variants.py builds it beside
// the port's kernels and times both on the same inputs; the port does not
// use it. Same launchers and arguments as csrc/resblock2d.cu's `conv3x3`,
// `conv1x1`, `conv_tiles` and `conv_blocks`, plus `conv3x3_4rows`, the 3x3
// product with the 4-row tile at every shape (fewer blocks than SMs at
// 20x192 and at 40x384 with 64 channels).
//
// Design: two warpgroups a block, each computing 64 channels x 32 pixels of
// a row per `wgmma`, A (weights) from registers split into TF32 halves
// there, B (the window) from shared memory, staged once per chunk as
// [channel quad][window pixel][4 channels] (K-major, as `wgmma` needs a
// TF32 B: a tap's shift is a shift of the descriptor's start by 16-byte
// pixels) and split once in place into high parts and a buffer of low
// parts. Tiles: 64 x 4 x 32 (two rows a warpgroup), 64 x 2 x 32 (one row
// each), 64 x 1 x 32 with each 16-channel chunk's K split over the two
// warpgroups; the launcher takes the first that gives every SM a block.
// At 182-202 registers a thread (all 9 taps' A fragments stay live while
// the `wgmma`s run) one block fits an SM, so the smaller tiles run in two
// waves: that, and the per-chunk split pass in the 1x1 products, is where
// it loses.
#include "common.cuh"
#include "tf32_mma.cuh"

namespace arttts {

// ---- wgmma (sm_90a): a warpgroup of 4 warps multiplies a 64 x 8 TF32 A
// held in registers (warp w holds rows 16w..16w+15 in m16n8k8's A fragment
// layout) by an 8 x 32 B read from shared memory through a descriptor, into
// a 64 x 32 float32 accumulator (16 registers a thread: register 4j + 2h + e
// holds row 16w + g + 8h, column 8j + 2t + e). TF32 B must be K-major: core
// matrices of 8 rows (n) x 16 bytes (4 k), no swizzle; `lbo` is the byte
// step between the two core matrices along k, `sbo` between those along n.
__device__ __forceinline__ uint64_t wgmma_desc(const float* p, uint32_t lbo, uint32_t sbo) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

// d += a * b; `wgmma_fence` before the first product of a group (after the
// registers it reads were written), then `wgmma_commit` and `wgmma_wait0`
// before d or a are read or written again.
__device__ __forceinline__ void wgmma_m64n32k8(float (&d)[16], const uint32_t (&a)[4],
                                               uint64_t b) {
  // scale-d is a predicate (true: accumulate), then A's and B's signs
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, "
      "{%16,%17,%18,%19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Shared-memory writes of this thread become visible to `wgmma`'s reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keep a register live and unmoved across this point: the compiler does not
// know that an in-flight `wgmma` reads and writes registers.
__device__ __forceinline__ void fence_reg(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_reg(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

}  // namespace arttts

namespace {

using arttts::ceil_div;
using arttts::cp_async16;
using arttts::cp_async4;
using arttts::cp_async_commit;
using arttts::cp_async_wait;
using arttts::fence_proxy_async;
using arttts::fence_reg;
using arttts::kThreads;
using arttts::set_smem;
using arttts::sm_count;
using arttts::split_tf32;
using arttts::to_tf32;
using arttts::wgmma_commit;
using arttts::wgmma_desc;
using arttts::wgmma_fence;
using arttts::wgmma_m64n32k8;
using arttts::wgmma_wait0;

constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;
constexpr int kCols = 32;   // output frames of a tile row: one wgmma's n
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

// A block: 64 output channels x R rows x 32 frames, two warpgroups. With
// WK = 1 warpgroup wg computes rows RPW wg..+RPW-1 over the whole chunk;
// with WK = 2 both compute the same RPW rows, warpgroup wg over channels
// 8 wg..8 wg+7 of each 16-channel chunk, and their sums meet in a fixed
// order.
template <int KS, int RPW, int WK>
struct Tile {
  static constexpr int kTaps = KS * KS;
  static constexpr int kRows = 2 / WK * RPW;  // output rows of a tile
  static constexpr int kCi = 8 * WK;          // input channels of a staged chunk
  static constexpr int kWinRows = kRows + KS - 1;
  static constexpr int kWinCols = kCols + KS - 1;
  static constexpr int kPix = kWinRows * kWinCols;  // window pixels
  static constexpr int kQuad = 4 * kPix;            // floats of 4 channels' window
  static constexpr int kWin = kCi / 4 * kQuad;      // a chunk's window
  static constexpr int kARow = kCi * kTaps;         // a chunk's weights of one channel
  static constexpr int kAPitch = kARow + 4;         // 4 x odd: conflict-free A loads
  static constexpr int kAStage = 64 * kAPitch;
  static constexpr int kStage = kAStage + 2 * kWin;  // weights, window hi, window lo
  static constexpr int kPieces = kARow / 4;          // 16-byte pieces of a weight row
  static constexpr int kSmemFloats = kStages * kStage;
  static_assert(WK == 1 || WK == 2, "one or two K groups");
  static_assert(kAPitch % 8 == 4, "A fragments: 8 rows x 4 columns on 32 banks");
  static_assert(kAStage % 4 == 0 && kQuad % 4 == 0 && kStage % 4 == 0, "16-byte alignment");
  static_assert((WK - 1) * RPW * 16 * 128 <= kSmemFloats, "the K groups' sums fit");
};

template <int KS, int RPW, int WK>
__device__ __forceinline__ void wgmma_body(const ConvArgs& a) {
  using Tl = Tile<KS, RPW, WK>;
  constexpr int kHalo = KS / 2;
  extern __shared__ __align__(128) float smem[];
  __shared__ float stats_s[2][8][2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2, w4 = warp & 3;
  const int wk = WK == 2 ? wg : 0;             // this warpgroup's K group
  const int r0 = WK == 2 ? 0 : wg * RPW;       // its first row in the tile
  const int H = a.H, T = a.T;
  const int tiles_t = ceil_div(T, kCols);
  const int h0 = (blockIdx.x / tiles_t) * Tl::kRows;
  const int t0 = (blockIdx.x % tiles_t) * kCols;
  const int co0 = blockIdx.y * 64;
  const int b = blockIdx.z;
  const int len = a.lengths != nullptr ? min(a.lengths[b], T) : T;
  const int Cin = a.c0 + a.c1;
  const size_t plane = (size_t)H * T;
  const float* xb0 = a.x0 + (size_t)b * a.c0 * plane;
  const float* xb1 = a.c1 > 0 ? a.x1 + (size_t)b * a.c1 * plane : a.x0;
  const int w_row = Cin * Tl::kTaps;  // weights of one output channel
  const float* wb = a.w + (size_t)co0 * w_row;
  const bool w16 = Cin % 4 == 0;

  // window staging: warp w copies the chunk's channels w (and w + 8), all
  // rows, into [channel quad][window pixel][4 channels] (K-major for
  // wgmma); lane l takes window column l (lanes l < KS - 1 also 32 + l)
  const int col_a = t0 - kHalo + lane, col_b = t0 - kHalo + kCols + lane;
  const bool ok_a = col_a >= 0 && col_a < len;
  const bool ok_b = lane < KS - 1 && col_b < len;

  auto load = [&](int chunk, int slot) {
    float* As = smem + slot * Tl::kStage;
    float* Bs = As + Tl::kAStage;
    const int ci0 = chunk * Tl::kCi;
    const int j0 = ci0 * Tl::kTaps;  // first K index of the chunk
    if (w16) {
      for (int i = tid; i < 64 * Tl::kPieces; i += kThreads) {
        const int co = i / Tl::kPieces, q = i % Tl::kPieces;
        const bool ok = j0 + 4 * q < w_row;  // Cin % 4 == 0: a piece is all in or all out
        cp_async16(As + co * Tl::kAPitch + 4 * q,
                   ok ? wb + (size_t)co * w_row + j0 + 4 * q : a.w, ok);
      }
    } else {
      for (int i = tid; i < 64 * Tl::kARow; i += kThreads) {
        const int co = i / Tl::kARow, j = i % Tl::kARow;
        const bool ok = j0 + j < w_row;
        cp_async4(As + co * Tl::kAPitch + j, ok ? wb + (size_t)co * w_row + j0 + j : a.w, ok);
      }
    }
#pragma unroll
    for (int c = 0; c < WK; ++c) {
      const int cl = warp + kWarps * c, ci = ci0 + cl;
      const float* src = ci < a.c0 ? xb0 + (size_t)ci * plane : xb1 + (size_t)(ci - a.c0) * plane;
      float* dst = Bs + (cl >> 2) * Tl::kQuad + (cl & 3) + 4 * lane;
#pragma unroll
      for (int rr = 0; rr < Tl::kWinRows; ++rr) {
        const int row = h0 - kHalo + rr;
        const bool rok = ci < Cin && row >= 0 && row < H;
        const float* s = src + (ptrdiff_t)row * T;
        cp_async4(dst + 4 * rr * Tl::kWinCols, rok && ok_a ? s + col_a : a.x0, rok && ok_a);
        if (KS > 1 && lane < KS - 1)
          cp_async4(dst + 4 * (rr * Tl::kWinCols + kCols), rok && ok_b ? s + col_b : a.x0,
                    rok && ok_b);
      }
    }
  };

  float acc[RPW][16];
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int v = 0; v < 16; ++v) acc[r][v] = 0.f;

  const int n_chunks = ceil_div(Cin, Tl::kCi);
  load(0, 0);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<0>();
    __syncthreads();  // chunk c has landed; every wgmma on chunk c-1 is done
    if (c + 1 < n_chunks) load(c + 1, (c + 1) % kStages);
    cp_async_commit();
    const float* As = smem + (c % kStages) * Tl::kStage;
    float* Bhi = smem + (c % kStages) * Tl::kStage + Tl::kAStage;
    float* Blo = Bhi + Tl::kWin;
    for (int i = tid; i < Tl::kWin; i += kThreads) {  // split the window once, in place
      const float v = Bhi[i];
      const uint32_t hi = to_tf32(v);
      Bhi[i] = __uint_as_float(hi);
      Blo[i] = v - __uint_as_float(hi);
    }
    fence_proxy_async();
    __syncthreads();
    // this warp's A fragments of every tap: rows 16 w4 + g (+8), K columns
    // (8 wk + t) taps + tap (+4 channels)
    uint32_t ah[Tl::kTaps][4], al[Tl::kTaps][4];
    const float* Aw = As + (16 * w4 + g) * Tl::kAPitch + (8 * wk + t) * Tl::kTaps;
#pragma unroll
    for (int tap = 0; tap < Tl::kTaps; ++tap) {
      split_tf32(Aw[tap], ah[tap][0], al[tap][0]);
      split_tf32(Aw[8 * Tl::kAPitch + tap], ah[tap][1], al[tap][1]);
      split_tf32(Aw[4 * Tl::kTaps + tap], ah[tap][2], al[tap][2]);
      split_tf32(Aw[8 * Tl::kAPitch + 4 * Tl::kTaps + tap], ah[tap][3], al[tap][3]);
    }
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
      for (int v = 0; v < 16; ++v) fence_reg(acc[r][v]);
    wgmma_fence();
    // output row r0 + r, tap (kh, kw) reads window row r0 + r + kh from
    // column kw: 32 pixels in one window row, so the operand is one start
    // address; core matrices 8 pixels (128 bytes) apart along n, a channel
    // quad's window apart along k
    const float* Bh = Bhi + 2 * wk * Tl::kQuad;
    const float* Bl = Blo + 2 * wk * Tl::kQuad;
#pragma unroll
    for (int tap = 0; tap < Tl::kTaps; ++tap) {
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const int px = (r0 + r + tap / KS) * Tl::kWinCols + tap % KS;
        const uint64_t dh = wgmma_desc(Bh + 4 * px, 4 * Tl::kQuad, 128);
        const uint64_t dl = wgmma_desc(Bl + 4 * px, 4 * Tl::kQuad, 128);
        wgmma_m64n32k8(acc[r], al[tap], dh);  // the small terms first
        wgmma_m64n32k8(acc[r], ah[tap], dl);
        wgmma_m64n32k8(acc[r], ah[tap], dh);
      }
    }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
      for (int v = 0; v < 16; ++v) fence_reg(acc[r][v]);
#pragma unroll
    for (int tap = 0; tap < Tl::kTaps; ++tap)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        fence_reg(ah[tap][k]);
        fence_reg(al[tap][k]);
      }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free

  if (WK == 2) {  // K group 1 hands its sums to group 0
    float* red = smem + (tid & 127);
    if (wk == 1) {
#pragma unroll
      for (int r = 0; r < RPW; ++r)
#pragma unroll
        for (int v = 0; v < 16; ++v) red[128 * (16 * r + v)] = acc[r][v];
    }
    __syncthreads();
    if (wk == 0) {
#pragma unroll
      for (int r = 0; r < RPW; ++r)
#pragma unroll
        for (int v = 0; v < 16; ++v) acc[r][v] += red[128 * (16 * r + v)];
    }
  }

  // epilogue (K group 0): bias, the Rezero form or the raw store, and this
  // lane's share of the GroupNorm partials of its two 8-channel slots
  float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
  if (wk == 0) {
    const float gain = a.resid != nullptr ? a.gain[0] : 0.f;
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
        for (int j = 0; j < 4; ++j) {
          const int col = t0 + 8 * j + 2 * t;
          if (col >= T) continue;
          const bool two = col + 1 < T;
          float v0 = acc[r][4 * j + 2 * h] + bv, v1 = acc[r][4 * j + 2 * h + 1] + bv;
          if (a.resid != nullptr) {
            v0 = a.resid[o + col] + gain * v0;
            v1 = two ? a.resid[o + col + 1] + gain * v1 : 0.f;
          }
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
    if (lane == 0) {  // K group 1 holds zeros
      stats_s[wg][2 * w4 + h][0] = s1[h];
      stats_s[wg][2 * w4 + h][1] = s2[h];
    }
  }
  __syncthreads();
  if (tid < 8) {  // one partial per 8-channel slot and tile: the warpgroups in order
    const float x = stats_s[0][tid][0] + stats_s[1][tid][0];
    const float q = stats_s[0][tid][1] + stats_s[1][tid][1];
    float* dst =
        a.partial + (((size_t)b * (a.Cout / 8) + co0 / 8 + tid) * gridDim.x + blockIdx.x) * 2;
    dst[0] = x;
    dst[1] = q;
  }
}

template <int RPW, int WK>
__global__ void __launch_bounds__(kThreads, 1) conv3x3_kernel(const ConvArgs a) {
  wgmma_body<3, RPW, WK>(a);
}

template <int RPW, int WK>
__global__ void __launch_bounds__(kThreads, 1) conv1x1_kernel(const ConvArgs a) {
  wgmma_body<1, RPW, WK>(a);
}

// The three tiles, largest first: (rows per warpgroup, K groups), tile rows
// 2 RPW / WK.
constexpr int kTileShapes[3][2] = {{2, 1}, {1, 1}, {1, 2}};

int tile_rows(int cfg) { return 2 / kTileShapes[cfg][1] * kTileShapes[cfg][0]; }

int tile_blocks(int cfg, int B, int Cout, int H, int T) {
  return ceil_div(H, tile_rows(cfg)) * ceil_div(T, kCols) * (Cout / 64) * B;
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

template <int KS, int RPW, int WK>
int launch_tile(const ConvArgs& a, int B, cudaStream_t stream) {
  using Tl = Tile<KS, RPW, WK>;
  void (*kernel)(const ConvArgs) = KS == 3 ? conv3x3_kernel<RPW, WK> : conv1x1_kernel<RPW, WK>;
  const size_t smem = sizeof(float) * Tl::kSmemFloats;
  static const int attr = set_smem(kernel, smem);
  if (attr) return attr;
  const dim3 grid(ceil_div(a.H, Tl::kRows) * ceil_div(a.T, kCols), a.Cout / 64, B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  ARTTTS_CHECK_LAUNCH();
  return 0;
}

template <int KS>
int launch_conv(const ConvArgs& a, int B, void* stream) {
  if (a.Cout % 64 || a.c0 < 1 || a.c1 < 0 || a.H < 1 || a.T < 1)
    return (int)cudaErrorInvalidValue;
  const int cfg = pick_tile(B, a.Cout, a.H, a.T);
  if (cfg < 0) return -cfg;
  const cudaStream_t s = (cudaStream_t)stream;
  if (cfg == 0) return launch_tile<KS, 2, 1>(a, B, s);
  if (cfg == 1) return launch_tile<KS, 1, 1>(a, B, s);
  return launch_tile<KS, 1, 2>(a, B, s);
}

}  // namespace

// Pixel tiles (grid x) of a product launch at this shape, or minus a CUDA
// error code: the GroupNorm partials hold one entry per tile.
extern "C" int conv_tiles(int B, int Cout, int H, int T) {
  const int cfg = pick_tile(B, Cout, H, T);
  return cfg < 0 ? cfg : ceil_div(H, tile_rows(cfg)) * ceil_div(T, kCols);
}

// Blocks of a product launch at this shape, or minus a CUDA error code.
extern "C" int conv_blocks(int B, int Cout, int H, int T) {
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
  return launch_conv<3>(a, B, stream);
}

// 1x1 convolution: out = W x + bias (bias may be null), or the Rezero form
// out = resid + gain[0] * (W x + bias) when `resid` is given; x masked to
// frames t < lengths[b] when `lengths` is given.
extern "C" int conv1x1(const float* x0, int c0, const float* x1, int c1, const int* lengths,
                       const float* w, const float* bias, const float* resid, const float* gain,
                       float* out, int B, int Cout, int H, int T, void* stream) {
  const ConvArgs a{x0, x1, c0, c1, lengths, w, bias, resid, gain, out, nullptr,
                   H, T, Cout, 0};
  return launch_conv<1>(a, B, stream);
}

// The 3x3 product with the 4-row tile whatever the grid it gives.
extern "C" int conv3x3_4rows(const float* x0, int c0, const float* x1, int c1,
                             const int* lengths, const float* w, const float* bias, float* out,
                             float* partial, int B, int H, int T, int Cout, int masked_stats,
                             void* stream) {
  if (Cout % 64 || c0 < 1 || c1 < 0 || H < 1 || T < 1) return (int)cudaErrorInvalidValue;
  const ConvArgs a{x0, x1, c0, c1, lengths, w, bias, nullptr, nullptr, out, partial,
                   H, T, Cout, masked_stats};
  return launch_tile<3, 2, 1>(a, B, (cudaStream_t)stream);
}
