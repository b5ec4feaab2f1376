// K6: Monotonic Alignment Search, (B, T_x, T_y) masked log-prior -> 0/1 path.
//
// Replaces the TPU kernel `_mas_kernel` behind `mas_pallas` in
// arttts_tpu/ops/mas_pallas.py (:41, wrapper :180). The function, for each
// utterance b with t_x text positions and t_y frames:
//
//   forward, y = 0 .. t_y-1, over the column of text positions x:
//     in_band = x >= max(0, t_x + y - t_y) && x < min(t_x, y + 1)
//     v_cur   = x == y ? -1e9 : prev[x]
//     v_prev  = x == 0 ? (y == 0 ? 0 : -1e9) : prev[x - 1]
//     cur[x]  = in_band ? max(v_cur, v_prev) + value[x, y] : value[x, y]
//     dec[y][x] = x != 0 && (x == y || (y > 0 && prev[x] < prev[x - 1]))
//   (prev is column y-1 after its update, zeros before frame 0);
//   backtrace from index = max(t_x - 1, 0), y = t_y-1 .. 0:
//     idx[y] = index; if dec[y][index]: index -= 1;
//   path[x, y] = (idx[y] == x), idx[y] = -1 for y >= t_y.
// Frames y >= t_y and positions x >= t_x never reach the path (column y
// only feeds later frames, position x only larger ones), so the forward
// stops at t_y.
//
// Only max and add in float32, no multiply, so no contraction can change a
// bit: the result equals the plain version and the NumPy transcription of
// the reference's Cython DP bit for bit. No atomics. The lengths are read
// on the card; the host never waits for them.
//
// What bounds it on the H100: it moves 8 bytes per cell (value read once,
// path written once), 0.011 ms at the training bucket (16 x 192 x 1024),
// and both passes are chains of t_y dependent steps (column y needs column
// y-1; the index at frame y needs frame y+1). So the design keeps the
// chains short and moves the bytes off them:
// 1. Forward on one warp per utterance (route A, T_x <= 1024), one
//    utterance a block so its warp has an SM's issue slots. Lane l holds
//    J consecutive positions x = l*J + j in registers (J = ceil(T_x / 32)
//    rounded up to an instantiated 1, 2, 4, 6, 8, 12, 16, 24, 32). Slot j
//    reads prev[x - 1] from its own slot j-1; slot 0 from lane l-1's slot
//    J-1, one `__shfl_up_sync` a frame. Slots update from J-1 down, in
//    place. A frame's chain is a shuffle, a max and an add: no barrier, no
//    shared-memory round trip, no global load. When t_x <= t_y (training
//    utterances: t_y is a few times t_x) the band's tests never change the
//    path, so the frames skip them, and frames y >= t_x the x == y test
//    too (`dp_frame` says why); a frame then costs each slot a max, an
//    add, a compare and a ballot.
// 2. `value` is staged ahead of the chain by a second warp of the block:
//    16-frame chunks of the T_x rows (16-byte `cp.async`, four lanes a row;
//    a ragged T_y, or T_y % 4 != 0, 4-byte zero-filled copies) into rows of
//    32 floats, chunk c in half c % 2 of each row, so chunk c+1 is in
//    flight while chunk c's frames run. The warps hand chunks over through
//    two counters in shared memory (chunks landed, chunks used), read once
//    a chunk, not a frame: the DP warp's issue slots go to the DP alone
//    (copies issued from the DP warp itself cost it a third of its time).
//    A row's 16-byte pieces are XOR-swizzled by the row's DP lane (piece ^
//    (l % 8)), so the lanes' vector reads of slot j (4 frames a read for
//    J <= 8, else 2) hit distinct banks.
// 3. Decision bits: one `__ballot_sync` per slot and frame gives J words,
//    bit l of word j the decision at x = l*J + j; lane j stores word j. The
//    words stay in shared memory while 32*J*128 B of staging plus T_y*J*4 B
//    of words fit in 227 KB (J = 6: T_y up to 8,660; J = 32: T_y up to
//    791), else they go to device memory a chunk at a time from a shared
//    buffer (`mas_dec_words` says how many); the per-frame store is a
//    shared one either way.
// 4. Backtrace: lane 0 walks t_y frames, two a step (frame y's word and
//    both candidates of frame y-1 read together), a bit test and a
//    decrement each (device-memory words come in 32-frame chunks staged by
//    the warp), writing each frame's text index into idx (B, T_y). A second
//    launch, over the whole grid, writes path[b, x, y] = (idx[b, y] == x):
//    every element written (no zero fill), coalesced along y, 12.6 MB at
//    the bucket from every SM rather than one. A second launch rather than
//    more warps in the first: the path needs all of idx, so in one kernel
//    those warps would wait for the walk, holding the SMs the walk needs no
//    more of.
// 5. Route B, T_x > 1024 (up to 16,384): W = ceil(T_x / 1024) warps an
//    utterance, each a slice of 32*J positions (J = 32) as in 1; the value
//    crossing a slice boundary goes through shared memory, one
//    __syncthreads() a frame (double-buffered). Its value reads go straight
//    to device memory one frame ahead (staging T_x rows would not fit), and
//    its words go to device memory unless T_y*W*J*4 B fit.
#include "common.cuh"
#include "tf32_mma.cuh"

#include <type_traits>

namespace {

using arttts::ceil_div;
using arttts::cp_async16;
using arttts::cp_async4;
using arttts::cp_async_commit;
using arttts::cp_async_wait;

constexpr float kNeg = -1e9f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 16;     // frames of value staged a chunk (half a 32-float row)
constexpr int kWalk = 32;      // frames a backtrace chunk (words staged, indices stored)
constexpr int kMaxJ = 32;      // positions a lane; route A covers T_x <= 32 * kMaxJ
constexpr int kSmemMax = 232448;  // dynamic shared memory a block can have (227 KB)
constexpr int kBnd = 2 * 32;      // route B's boundary values, floats
constexpr int kCounters = 16;     // route A's two chunk counters, bytes (16-byte padded)

template <int G>
struct VecOf;
template <>
struct VecOf<4> { using T = float4; };
template <>
struct VecOf<2> { using T = float2; };

template <int G>
__device__ __forceinline__ void unpack(const typename VecOf<G>::T& q, float (&v)[G]) {
  if constexpr (G == 4) {
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    v[0] = q.x; v[1] = q.y;
  }
}

// One frame of the forward DP for the J positions of this lane, in place
// (slot J-1 first, so slot j still sees slot j-1's previous value). `pm0`
// is prev[x - 1] of slot 0 (the neighbouring lane's, or x == 0's constant);
// v[j] the frame's value; lo, hi, dy are the band's ends and y, relative to
// the lane's first position. Returns word j of the frame's decisions in
// lane j. kTests: 2 tests the band and x == y, as the reference does; 1
// only x == y; 0 neither. When t_x <= t_y the band tests never change the
// path: a cell below the band only feeds cells below it, the walk never
// goes below it (from t_x - 1 at t_y - 1, one position a frame at most),
// a cell above the diagonal x = y only meets the walk where x == y forces
// the step, and positions x >= t_x never reach x < t_x. So there 1 serves
// the frames y < t_x and 0 the rest (no x < t_x equals y).
template <int J, int kTests>
__device__ __forceinline__ unsigned dp_frame(float (&col)[J], const float (&v)[J], float pm0,
                                             int lo, int hi, int dy, int lane) {
  unsigned mine = 0;
#pragma unroll
  for (int j = J - 1; j >= 0; --j) {
    const float p = col[j];
    const float pm = j > 0 ? col[j - 1] : pm0;
    const bool diag = kTests >= 1 && j == dy;  // x == y
    const float m = fmaxf(diag ? kNeg : p, pm) + v[j];
    col[j] = kTests < 2 || (j >= lo && j < hi) ? m : v[j];
    // at y == 0 every prev is 0, so p < pm is false there without a test of y
    const unsigned w = __ballot_sync(kFull, diag || p < pm);
    mine = lane == j ? w : mine;
  }
  return mine;
}

// The backtrace over frames y_hi .. y_lo, by one thread. `words` holds
// frame y's WJ words at (y - wy0) * WJ; the text index is t * J + j (t is
// the lane-slice's index, so word (t / 32) * J + j, bit t % 32); writes
// frame y's index to ib[y - y_lo]. Route A (not kWide: t < 32) goes two
// frames a step: frame y-1's index is frame y's or the one below it, so
// the step reads frame y's word and both of frame y-1's candidates at once
// and one shared-memory latency serves two frames; it tracks the bit as a
// mask, so a test is one AND. Route B goes a frame a step.
template <int J, bool kWide>
__device__ __forceinline__ void walk(const unsigned* words, int wy0, int WJ, int y_hi, int y_lo,
                                     int& t, int& j, int* ib) {
  int i = t * J + j;
  int y = y_hi;
  if constexpr (kWide) {
    for (; y >= y_lo; --y) {
      ib[y - y_lo] = i;
      if ((words[(y - wy0) * WJ + (t >> 5) * J + j] >> (t & 31)) & 1u) {
        --i;
        t = i / J;
        j = i - t * J;
      }
    }
    return;
  }
  const unsigned* row = words + (y - wy0) * WJ;  // frame y's words
  unsigned m = 1u << t;
  // (j, m) one index down; at index 0 the mask empties, and bit 0 of word 0
  // is never set, so the walk never steps below 0
  auto below = [&](int& jj, unsigned& mm) {
    const bool wrap = jj == 0;
    jj = wrap ? J - 1 : jj - 1;
    mm = wrap ? mm >> 1 : mm;
  };
  for (; y > y_lo; y -= 2, row -= 2 * WJ) {
    int j1 = j;
    unsigned m1 = m;
    below(j1, m1);
    const bool here = row[j] & m;
    const bool stay = row[j - WJ] & m;
    const bool down = row[j1 - WJ] & m1;
    ib[y - y_lo] = i;
    if (here) {
      j = j1;
      m = m1;
      --i;
    }
    ib[y - 1 - y_lo] = i;
    if (here ? down : stay) {
      below(j, m);
      --i;
    }
  }
  for (; y >= y_lo; --y, row -= WJ) {  // an odd frame left (the state goes on)
    ib[y - y_lo] = i;
    if (row[j] & m) {
      below(j, m);
      --i;
    }
  }
  t = i / J;
}

// Backtrace of one utterance from its decision words: in shared memory
// (`words_in_smem`), or in device memory at gdec, staged kWalk frames at a
// time into `stage` (kWalk x WJ words, then kWalk ints of indices). Threads
// 0 .. nt-1 (one warp, or the block: kBlock) call it; thread 0 walks kWalk
// frames at a time into shared memory, and the threads store them to idx:
// the walk's chain holds no device-memory access. Writes idx for all T_y
// frames.
template <int J, bool kBlock>
__device__ __forceinline__ void backtrace(const unsigned* sdec, const unsigned* gdec,
                                          bool words_in_smem, unsigned* stage, int WJ, int t_x,
                                          int t_y, int T_y, int* ib, int tid, int nt) {
  auto sync = [] {
    if constexpr (kBlock) __syncthreads(); else __syncwarp();
  };
  int* sidx = reinterpret_cast<int*>(stage + kWalk * WJ);
  for (int y = t_y + tid; y < T_y; y += nt) ib[y] = -1;
  const int i0 = max(t_x - 1, 0);
  int t = i0 / J, j = i0 % J;  // meaningful in thread 0
  for (int y_hi = t_y - 1; y_hi >= 0; y_hi -= kWalk) {
    const int y_lo = max(y_hi - kWalk + 1, 0);
    if (!words_in_smem) {
      for (int i = tid; i < (y_hi - y_lo + 1) * WJ; i += nt)
        stage[i] = gdec[(size_t)y_lo * WJ + i];
      sync();
    }
    if (tid == 0) {
      if (words_in_smem) walk<J, kBlock>(sdec, 0, WJ, y_hi, y_lo, t, j, sidx);
      else walk<J, kBlock>(stage, y_lo, WJ, y_hi, y_lo, t, j, sidx);
    }
    sync();
    for (int i = tid; i <= y_hi - y_lo; i += nt) ib[y_lo + i] = sidx[i];
    sync();
  }
}

// Route A: one DP warp per utterance (grid B, 64 threads: warp 0 runs the
// DP and the backtrace, warp 1 stages `value`), T_x <= 32 * J. Shared
// memory: 32*J rows x 32 floats of staged value, then T_y x J decision
// words (words_in_smem), or a chunk's kChunk x J of them on their way to
// device memory, then the two chunk counters of the hand-over.
template <int J>
__global__ void __launch_bounds__(64)
mas_dp_kernel(const float* __restrict__ value, const int* __restrict__ t_xs,
              const int* __restrict__ t_ys, unsigned* __restrict__ gdec, int* __restrict__ idx,
              int T_x, int T_y, int words_in_smem, int vec) {
  constexpr int G = J <= 8 ? 4 : 2;  // frames a vector read of a slot
  using Vec = typename VecOf<G>::T;
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;
  unsigned* sdec = reinterpret_cast<unsigned*>(smem + 32 * J * 32);
  const size_t n_words = words_in_smem ? (size_t)T_y * J : (size_t)kChunk * J;
  volatile int* landed = reinterpret_cast<volatile int*>(sdec + n_words);  // chunks staged
  volatile int* used = landed + 1;                                       // chunks consumed

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, b = blockIdx.x;
  // the wrapper derives the lengths from the mask, so they lie in range;
  // the clamp only keeps a wrong length from reaching outside the buffers
  const int t_x = min(max(t_xs[b], 0), T_x);
  const int t_y = min(max(t_ys[b], 0), T_y);
  const float* vb = value + (size_t)b * T_x * T_y;
  const int n_chunks = ceil_div(t_y, kChunk);
  if (threadIdx.x == 0) {
    *landed = 0;
    *used = 0;
  }
  __syncthreads();  // the only block barrier: the counters are set

  if (warp == 1) {
    // ---- the staging warp: chunk c (16 frames of the T_x rows) into half
    // c % 2 of each row, 16-byte pieces swizzled by the row's DP lane; rows
    // x >= T_x (their positions never reach x < T_x) and frames y >= T_y
    // zero-filled. Four lanes a row, so a copy instruction covers 8 rows.
    const int k = lane & 3;
    for (int c = 0; c < n_chunks; ++c) {
      while (*used < c - 1) {  // chunk c-2, in this half before, is consumed
      }
      const int y = c * kChunk + 4 * k;
      const int half = (c & 1) * 4;
      for (int x = lane >> 2; x < 32 * J; x += 8) {
        float* d = stage + x * 32 + 4 * ((half + k) ^ ((x / J) & 7));
        const float* src = vb + (size_t)(x < T_x ? x : 0) * T_y + y;
        if (vec) {
          const bool ok = x < T_x && y < T_y;
          cp_async16(d, ok ? src : vb, ok);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = x < T_x && y + e < T_y;
            cp_async4(d + e, ok ? src + e : vb, ok);
          }
        }
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncwarp();
      if (lane == 0) {
        __threadfence_block();
        *landed = c + 1;
      }
    }
    return;
  }

  // ---- the DP warp -----------------------------------------------------
  unsigned* dec = words_in_smem ? sdec : gdec + (size_t)b * T_y * J;
  unsigned* wc = sdec;  // the words of the chunk at hand, in shared memory
  const int base = lane * J;
  const int swz = lane & 7;
  float col[J];  // the DP column: x = base + j
#pragma unroll
  for (int j = 0; j < J; ++j) col[j] = 0.f;
  // G frames from one vector read of each slot; `checked` stops at t_y,
  // `tests` is dp_frame's kTests
  auto frames = [&](int y0, int pos, auto checked, auto tests) {
    float v[J][G];
#pragma unroll
    for (int j = 0; j < J; ++j)
      unpack<G>(*reinterpret_cast<const Vec*>(stage + (base + j) * 32 + pos), v[j]);
#pragma unroll
    for (int f = 0; f < G; ++f) {
      const int y = y0 + f;
      if (decltype(checked)::value && y >= t_y) break;
      float vf[J];
#pragma unroll
      for (int j = 0; j < J; ++j) vf[j] = v[j][f];
      float pm0 = __shfl_up_sync(kFull, col[J - 1], 1);
      if (lane == 0) pm0 = y == 0 ? 0.f : kNeg;
      unsigned mine = dp_frame<J, decltype(tests)::value>(
          col, vf, pm0, max(0, t_x + y - t_y) - base, min(t_x, y + 1) - base, y - base, lane);
      if (lane == 0) mine &= ~1u;  // x == 0 never steps back
      if (lane < J) wc[(y % kChunk) * J + lane] = mine;
    }
  };

  for (int c = 0; c < n_chunks; ++c) {
    while (*landed <= c) {  // the staging warp's chunk c
    }
    __threadfence_block();
    if (words_in_smem) wc = sdec + c * kChunk * J;
#pragma unroll 1
    for (int piece = 0; piece < 4; ++piece) {
      const int y0 = c * kChunk + 4 * piece;
      const int pos = 4 * (((c & 1) * 4 + piece) ^ swz);
      using T0 = std::integral_constant<int, 0>;
      using T1 = std::integral_constant<int, 1>;
      using T2 = std::integral_constant<int, 2>;
      if (y0 + 4 > t_y) {  // the last, partial piece
        for (int sub = 0; sub < 4 / G && y0 + G * sub < t_y; ++sub)
          frames(y0 + G * sub, pos + G * sub, std::true_type{}, T2{});
      } else if (t_x > t_y) {
#pragma unroll
        for (int sub = 0; sub < 4 / G; ++sub)
          frames(y0 + G * sub, pos + G * sub, std::false_type{}, T2{});
      } else if (y0 < t_x) {
#pragma unroll
        for (int sub = 0; sub < 4 / G; ++sub)
          frames(y0 + G * sub, pos + G * sub, std::false_type{}, T1{});
      } else {
#pragma unroll
        for (int sub = 0; sub < 4 / G; ++sub)
          frames(y0 + G * sub, pos + G * sub, std::false_type{}, T0{});
      }
    }
    __syncwarp();  // every lane is done with chunk c's half and its words
    if (lane == 0) *used = c + 1;
    if (!words_in_smem) {  // the chunk's words on to device memory
      const int n = min(kChunk, t_y - c * kChunk) * J;
      for (int i = lane; i < n; i += 32) dec[c * kChunk * J + i] = wc[i];
      __syncwarp();
    }
  }

  // ---- backtrace -----------------------------------------------------------
  backtrace<J, false>(sdec, dec, words_in_smem, reinterpret_cast<unsigned*>(stage), J, t_x,
                      t_y, T_y, idx + (size_t)b * T_y, lane, 32);
}

// Route B: W = blockDim / 32 warps per utterance, T_x <= 32 * J * W; the
// boundary value between warps' slices through shared memory. Shared
// memory: the boundary values, then the words (T_y x W*J) when
// words_in_smem, then kWalk x (W*J + 1) of backtrace staging.
template <int J>
__global__ void __launch_bounds__(512)
mas_dp_wide_kernel(const float* __restrict__ value, const int* __restrict__ t_xs,
                   const int* __restrict__ t_ys, unsigned* __restrict__ gdec,
                   int* __restrict__ idx, int T_x, int T_y, int words_in_smem) {
  extern __shared__ __align__(16) float smem[];
  float(*bnd)[32] = reinterpret_cast<float(*)[32]>(smem);  // [2][32]: slot J-1 of each
                                                          // warp's lane 31, by frame parity
  unsigned* sw = reinterpret_cast<unsigned*>(smem + kBnd);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int W = blockDim.x >> 5, WJ = W * J;
  const int b = blockIdx.x;
  const int t_x = min(max(t_xs[b], 0), T_x);
  const int t_y = min(max(t_ys[b], 0), T_y);
  const float* vb = value + (size_t)b * T_x * T_y;
  unsigned* dec = words_in_smem ? sw : gdec + (size_t)b * T_y * WJ;
  const int base = (warp * 32 + lane) * J;

  if (tid < 32) bnd[1][tid] = 0.f;  // column -1 is zeros
  float col[J], nv[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    col[j] = 0.f;
    nv[j] = base + j < T_x && t_y > 0 ? vb[(size_t)(base + j) * T_y] : 0.f;
  }
  __syncthreads();
  for (int y = 0; y < t_y; ++y) {
    float v[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      v[j] = nv[j];
      if (y + 1 < t_y && base + j < T_x) nv[j] = vb[(size_t)(base + j) * T_y + y + 1];
    }
    float pm0 = __shfl_up_sync(kFull, col[J - 1], 1);
    if (lane == 0) pm0 = warp > 0 ? bnd[(y + 1) & 1][warp - 1] : (y == 0 ? 0.f : kNeg);
    unsigned mine = dp_frame<J, 2>(col, v, pm0, max(0, t_x + y - t_y) - base,
                                min(t_x, y + 1) - base, y - base, lane);
    if (tid == 0) mine &= ~1u;  // x == 0 never steps back
    if (lane < J) dec[(size_t)y * WJ + warp * J + lane] = mine;
    if (lane == 31) bnd[y & 1][warp] = col[J - 1];
    __syncthreads();  // frame y's boundaries are in; frame y-1's are read
  }
  __syncthreads();
  unsigned* bstage = sw + (words_in_smem ? (size_t)T_y * WJ : 0);  // kWalk x (WJ + 1)
  backtrace<J, true>(sw, dec, words_in_smem, bstage, WJ, t_x, t_y, T_y, idx + (size_t)b * T_y,
                     tid, blockDim.x);
}

// path[b, x, y] = (idx[b, y] == x), one block per row (b, x), threads along y.
__global__ void mas_path_kernel(const int* __restrict__ idx, float* __restrict__ path, int T_x,
                                int T_y) {
  const int row = blockIdx.x;  // b * T_x + x
  const int b = row / T_x, x = row - b * T_x;
  const int* ib = idx + (size_t)b * T_y;
  float* pr = path + (size_t)row * T_y;
  if ((T_y & 3) == 0) {
    for (int q = threadIdx.x; q < T_y / 4; q += blockDim.x) {
      const int4 k = reinterpret_cast<const int4*>(ib)[q];
      reinterpret_cast<float4*>(pr)[q] =
          make_float4(k.x == x, k.y == x, k.z == x, k.w == x);
    }
  } else {
    for (int y = threadIdx.x; y < T_y; y += blockDim.x) pr[y] = ib[y] == x ? 1.f : 0.f;
  }
}

// Positions a lane for route A: the smallest instantiated J >= n.
int lane_positions(int n) {
  static const int kJ[] = {1, 2, 4, 6, 8, 12, 16, 24, 32};
  for (int j : kJ)
    if (j >= n) return j;
  return -1;
}

struct Plan {
  int J, warps;
  size_t words;    // decision words per utterance and frame x T_y
  bool in_smem;
  size_t smem;     // dynamic shared memory, bytes
};

Plan plan(int T_x, int T_y) {
  Plan p{};
  if (T_x <= 32 * kMaxJ) {
    p.J = lane_positions(ceil_div(T_x, 32));
    p.warps = 1;
    const size_t stage = sizeof(float) * 32 * p.J * 32;
    p.words = (size_t)T_y * p.J;
    p.in_smem = stage + 4 * p.words + kCounters <= kSmemMax;
    p.smem = stage + 4 * (p.in_smem ? p.words : (size_t)kChunk * p.J) + kCounters;
  } else {
    p.J = kMaxJ;
    p.warps = ceil_div(T_x, 32 * kMaxJ);
    p.words = (size_t)T_y * p.warps * p.J;
    p.in_smem = 4 * (kBnd + p.words + kWalk * (p.warps * p.J + 1)) <= kSmemMax;
    p.smem = 4 * (kBnd + (p.in_smem ? p.words : 0) + kWalk * (p.warps * p.J + 1));
  }
  return p;
}

template <int J>
int launch_a(const float* value, const int* t_xs, const int* t_ys, unsigned* dec, int* idx,
             int B, int T_x, int T_y, const Plan& p, cudaStream_t s) {
  static const int attr = arttts::set_smem(mas_dp_kernel<J>, kSmemMax);
  if (attr) return attr;
  // 16-byte copies need every row to start 16-byte aligned
  const int vec = (T_y & 3) == 0 && (reinterpret_cast<uintptr_t>(value) & 15) == 0;
  mas_dp_kernel<J><<<B, 64, p.smem, s>>>(value, t_xs, t_ys, dec, idx, T_x, T_y, p.in_smem, vec);
  return (int)cudaGetLastError();
}

// The forward and backtrace launch of the plan's route.
int launch_dp(const float* value, const int* t_xs, const int* t_ys, unsigned* dec, int* idx,
              int B, int T_x, int T_y, const Plan& p, cudaStream_t s) {
  if (p.warps > 1) {
    static const int attr = arttts::set_smem(mas_dp_wide_kernel<kMaxJ>, kSmemMax);
    if (attr) return attr;
    mas_dp_wide_kernel<kMaxJ><<<B, 32 * p.warps, p.smem, s>>>(value, t_xs, t_ys, dec, idx,
                                                              T_x, T_y, p.in_smem);
    return (int)cudaGetLastError();
  }
  switch (p.J) {
    case 1: return launch_a<1>(value, t_xs, t_ys, dec, idx, B, T_x, T_y, p, s);
    case 2: return launch_a<2>(value, t_xs, t_ys, dec, idx, B, T_x, T_y, p, s);
    case 4: return launch_a<4>(value, t_xs, t_ys, dec, idx, B, T_x, T_y, p, s);
    case 6: return launch_a<6>(value, t_xs, t_ys, dec, idx, B, T_x, T_y, p, s);
    case 8: return launch_a<8>(value, t_xs, t_ys, dec, idx, B, T_x, T_y, p, s);
    case 12: return launch_a<12>(value, t_xs, t_ys, dec, idx, B, T_x, T_y, p, s);
    case 16: return launch_a<16>(value, t_xs, t_ys, dec, idx, B, T_x, T_y, p, s);
    case 24: return launch_a<24>(value, t_xs, t_ys, dec, idx, B, T_x, T_y, p, s);
    case 32: return launch_a<32>(value, t_xs, t_ys, dec, idx, B, T_x, T_y, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Decision words the call keeps in device memory (the `dec` scratch of
// `mas_path`), 0 when they stay in shared memory; -1 for a bad shape or
// more words than an int counts.
extern "C" int mas_dec_words(int B, int T_x, int T_y) {
  if (B < 1 || T_x < 1 || T_y < 1 || T_x > 16 * 32 * kMaxJ) return -1;
  const Plan p = plan(T_x, T_y);
  const size_t n = p.in_smem ? 0 : (size_t)B * p.words;
  return n > 0x7fffffff ? -1 : (int)n;
}

// value (B, T_x, T_y) float32, masked; t_xs, t_ys (B,) int32 on the card;
// dec: mas_dec_words(B, T_x, T_y) uint32 scratch; idx (B, T_y) int32
// scratch; path (B, T_x, T_y) float32, every element written. T_x <= 16,384.
extern "C" int mas_path(const float* value, const int* t_xs, const int* t_ys, unsigned* dec,
                        int* idx, float* path, int B, int T_x, int T_y, void* stream) {
  if (mas_dec_words(B, T_x, T_y) < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const Plan p = plan(T_x, T_y);
  const int rc = launch_dp(value, t_xs, t_ys, dec, idx, B, T_x, T_y, p, s);
  if (rc) return rc;
  mas_path_kernel<<<B * T_x, 256, 0, s>>>(idx, path, T_x, T_y);
  ARTTTS_CHECK_LAUNCH();
  return 0;
}
