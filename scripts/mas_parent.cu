// K6 as it was before its redesign (arttts_tpu_torch/csrc/mas.cu up to
// commit 8c824d0), kept for measurement only: scripts/mas_variants.py builds
// it beside the current kernel and times both whole and by part. The port
// never calls it.
//
// K6: Monotonic Alignment Search, (B, T_x, T_y) masked log-prior -> 0/1 path.
//
// Replaces the TPU kernel `_mas_kernel` behind `mas_pallas` in
// arttts_tpu/ops/mas_pallas.py (:41, wrapper :180). The function, for each
// utterance b with t_x text positions and t_y frames:
//
//   forward, y = 0 .. T_y-1, over the column of text positions x:
//     in_band = x >= max(0, t_x + y - t_y) && x < min(t_x, y + 1)
//     v_cur   = x == y ? -1e9 : prev[x]
//     v_prev  = x == 0 ? (y == 0 ? 0 : -1e9) : prev[x - 1]
//     cur[x]  = in_band ? max(v_cur, v_prev) + value[x, y] : value[x, y]
//     dec[y][x] = x != 0 && (x == y || (y > 0 && prev[x] < prev[x - 1]))
//   (prev is column y-1 after its update, zeros before frame 0);
//   backtrace from index = max(t_x - 1, 0), y = T_y-1 .. 0:
//     path[index, y] = (y < t_y); if y < t_y && dec[y][index]: index -= 1.
//
// Only max and add in float32, no multiply, so no contraction can change a
// bit: the result equals the plain version and the NumPy transcription of
// the reference's Cython DP bit for bit. No atomics.
//
// What bounds it on the H100: it moves 8 bytes per cell (value read once,
// path written once) and does a few operations per cell, so by bytes and
// operations it is a few microseconds at the training bucket (16 x 192 x
// 1024). But both passes are chains of T_y dependent steps (the column of
// frame y needs frame y-1; the index at frame y needs frame y+1), and that
// latency floor is about as long. The design is the simple one that is
// right; it does not yet chase either floor:
//   - one block per utterance, threads over text positions (looping when
//     T_x > 1024); the DP column lives in shared memory, double-buffered,
//     one __syncthreads() per frame; value is read along x with stride T_y
//     (each thread walks its own row, so a row's cache line serves 32
//     frames);
//   - the decisions are packed with __ballot_sync into a (B, T_y, W)
//     uint32 scratch in device memory, W = ceil(T_x / 32);
//   - the backtrace goes down in chunks of 32 frames: the block stages the
//     chunk's decision words in shared memory, one thread walks the 32
//     frames, then the block writes the chunk's (T_x, 32) slab of the path,
//     each warp one row's 32 frames. Every element of the path is written
//     (0 or 1), so the output needs no zero fill.
// The lengths are read on the card; the host never waits for them.
#include "common.cuh"

namespace {

constexpr float kNeg = -1e9f;
constexpr int kYChunk = 32;  // frames per backtrace chunk (one warp writes one row's chunk)

__global__ void mas_kernel(const float* __restrict__ value, const int* __restrict__ t_xs,
                           const int* __restrict__ t_ys, unsigned* dec,
                           float* __restrict__ path, int T_x, int T_y) {
  extern __shared__ float smem[];
  const int W = arttts::ceil_div(T_x, 32);
  float* col_a = smem;                                 // DP columns, double-buffered
  float* col_b = smem + T_x;
  unsigned* dchunk = reinterpret_cast<unsigned*>(smem + 2 * T_x);  // kYChunk * W
  int* sidx = reinterpret_cast<int*>(dchunk + kYChunk * W);          // kYChunk

  const int b = blockIdx.x;
  const int nt = blockDim.x, tid = threadIdx.x, lane = tid & 31;
  // the wrapper derives the lengths from the mask, so they lie in range;
  // the clamp only keeps a wrong length from reaching outside the buffers
  const int t_x = min(max(t_xs[b], 0), T_x);
  const int t_y = min(max(t_ys[b], 0), T_y);
  const float* vb = value + (size_t)b * T_x * T_y;
  unsigned* db = dec + (size_t)b * T_y * W;
  float* pb = path + (size_t)b * T_x * T_y;
  const int n_pass = arttts::ceil_div(T_x, nt);

  // ---- forward DP and decision bits ------------------------------------
  for (int x = tid; x < T_x; x += nt) col_b[x] = 0.f;  // the column before frame 0
  __syncthreads();
  for (int y = 0; y < T_y; ++y) {
    const float* prev = (y & 1) ? col_a : col_b;
    float* cur = (y & 1) ? col_b : col_a;
    const int lo = max(0, t_x + y - t_y), hi = min(t_x, y + 1);
    for (int k = 0; k < n_pass; ++k) {
      const int x = tid + k * nt;  // nt is a multiple of 32: a warp holds one word's x
      bool d = false;
      if (x < T_x) {
        const float v_in = vb[(size_t)x * T_y + y];
        const float p = prev[x];
        const float pm = x > 0 ? prev[x - 1] : 0.f;
        const float v_cur = x == y ? kNeg : p;
        const float v_prev = x == 0 ? (y == 0 ? 0.f : kNeg) : pm;
        cur[x] = (x >= lo && x < hi) ? fmaxf(v_cur, v_prev) + v_in : v_in;
        d = x != 0 && (x == y || (y > 0 && p < pm));
      }
      const unsigned bits = __ballot_sync(0xffffffffu, d);
      if (lane == 0 && x < T_x) db[(size_t)y * W + (x >> 5)] = bits;
    }
    __syncthreads();
  }

  // ---- backtrace, 32 frames at a time, top down --------------------------
  int index = max(t_x - 1, 0);  // walked by thread 0 only
  for (int y_hi = T_y - 1; y_hi >= 0; y_hi -= kYChunk) {
    const int y_lo = max(y_hi - kYChunk + 1, 0);
    const int n = y_hi - y_lo + 1;
    // this block wrote these words above; __syncthreads() made them visible
    for (int i = tid; i < n * W; i += nt) dchunk[i] = db[(size_t)y_lo * W + i];
    __syncthreads();
    if (tid == 0) {
      for (int y = y_hi; y >= y_lo; --y) {
        const bool active = y < t_y;
        sidx[y - y_lo] = active ? index : -1;
        const unsigned word = dchunk[(y - y_lo) * W + (index >> 5)];
        if (active && ((word >> (index & 31)) & 1u)) --index;
      }
    }
    __syncthreads();
    for (int i = tid; i < T_x * kYChunk; i += nt) {
      const int x = i / kYChunk, j = i % kYChunk;
      if (j < n) pb[(size_t)x * T_y + y_lo + j] = sidx[j] == x ? 1.f : 0.f;
    }
  }
}

}  // namespace

// value (B, T_x, T_y) float32, masked; t_xs, t_ys (B,) int32 on the card;
// dec: (B, T_y, ceil(T_x / 32)) uint32 scratch; path (B, T_x, T_y) float32,
// every element written.
extern "C" int mas_path(const float* value, const int* t_xs, const int* t_ys, unsigned* dec,
                        float* path, int B, int T_x, int T_y, void* stream) {
  if (B < 1 || T_x < 1 || T_y < 1) return (int)cudaErrorInvalidValue;
  const int W = arttts::ceil_div(T_x, 32);
  const int threads = T_x >= 1024 ? 1024 : W * 32;
  const size_t smem = sizeof(float) * (2 * (size_t)T_x + (size_t)kYChunk * W + kYChunk);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mas_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  mas_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(value, t_xs, t_ys, dec, path, T_x,
                                                         T_y);
  ARTTTS_CHECK_LAUNCH();
  return 0;
}
