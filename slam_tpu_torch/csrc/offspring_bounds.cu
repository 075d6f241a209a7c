// R1, the offspring bounds of a fired stratified resample in one launch.
//
// Replaces no TPU kernel: the JAX package leaves offspring_bounds to XLA
// (slam_tpu/ops/resampling.py, its blocked _cummax_2d on the TPU). The
// port's eager form, ops/resampling.py:offspring_bounds_plain, ran some
// eleven launches, one of them torch.cummax, which scans a 1-D tensor in
// a single block: at P = 2^20 it took ~2.5 ms.
//
// What it computes, for csum [P] (an inclusive prefix sum of weights),
// n_out and the dither table U [n_out], each step rounded as the twin's:
//   t = csum * n_out (float32 product), k = clamp(trunc(t), 0, n_out - 1),
//   S = min(k + (U[k] < t - k), n_out) (a float32 difference),
//   S = the inclusive running max of S, then S[P - 1] = n_out.
// The products and differences are written with the _rn intrinsics, so
// no build setting can contract them into a fused multiply-add. The max
// is exact, so any order of the scan gives the twin's S bit for bit.
//
// Bound: memory. csum read, U read at k, S written: 12 P bytes, 12.6 MB
// and 3.76 us at 3.35 TB/s at P = 2^20; at small P the launch.
//
// Design: a single-pass block-parallel scan with decoupled look-back.
// A block takes the next tile of kTile entries by a ticket (so every
// tile before it belongs to a block already running), loads them
// coalesced, computes the unscanned bounds into shared memory, and scans
// them: each thread its kItems consecutive entries, the threads' maxima
// by warp shuffles, the warps' through shared memory. It publishes its
// tile's maximum at once, then its warp 0 reads the status words of the
// tiles before it, 32 at a time, until it meets one that holds the
// running max of every tile up to it, and publishes its own running max
// in turn. A status word holds its flag and its value in one 64-bit
// store. The last block to finish zeroes the status words and the two
// counters, so the workspace (owned by the wrapper, one per device and
// stream, zeroed when allocated) is clean for the next launch on its
// stream. A single tile (P <= kTile) skips the look-back.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;                    // consecutive entries a thread
constexpr int kTile = kThreads * kItems;     // entries a block
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// The workspace: the ticket counter, the finished-block counter, then a
// status word a tile. A status word is its flag << 32 | its value.
constexpr int kCounters = 2;
constexpr unsigned long long kEmpty = 0;      // not published yet
constexpr unsigned kAggregate = 1;           // the tile's own max
constexpr unsigned kPrefix = 2;              // the max of tiles [0, t]

// Shared memory holds a tile with a word of padding every 32 entries, so
// that neither the coalesced nor the per-thread accesses share a bank.
__device__ __forceinline__ int padded(int i) { return i + i / 32; }
constexpr int kPaddedTile = kTile + kTile / 32;

__device__ __forceinline__ unsigned long long status_word(unsigned flag,
                                                          int value) {
  return (unsigned long long)flag << 32 | (unsigned)value;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = max(v, __shfl_xor_sync(kFull, v, d));
  return v;
}

// The running max of the tiles before ``tile`` (INT_MIN for tile 0), by
// the 32 lanes of warp 0; publishes the tile's own running max.
__device__ int look_back(unsigned long long* status, int tile, int agg,
                         int lane) {
  if (tile == 0) {
    if (lane == 0) atomicExch(&status[0], status_word(kPrefix, agg));
    return INT_MIN;
  }
  if (lane == 0) atomicExch(&status[tile], status_word(kAggregate, agg));
  int before = INT_MIN;
  for (int last = tile - 1;; last -= 32) {
    const int t = last - lane;   // lane 0 the nearest tile
    unsigned long long w;
    do {
      w = t >= 0 ? *(volatile unsigned long long*)&status[t]
                 : status_word(kPrefix, INT_MIN);
    } while (__any_sync(kFull, w == kEmpty));
    const unsigned prefix =
        __ballot_sync(kFull, (unsigned)(w >> 32) == kPrefix);
    const int stop = prefix ? __ffs(prefix) - 1 : 31;
    before = max(before, warp_max(lane <= stop ? (int)(unsigned)w : INT_MIN));
    if (prefix) break;
  }
  if (lane == 0)
    atomicExch(&status[tile], status_word(kPrefix, max(before, agg)));
  return before;
}

__global__ void __launch_bounds__(kThreads) offspring_bounds_kernel(
    const float* __restrict__ csum, const float* __restrict__ U,
    int* __restrict__ S, int P, int n_out, unsigned long long* ws) {
  __shared__ int vals[kPaddedTile];
  __shared__ int warp_maxes[kWarps];
  __shared__ int tile_s, before_s, last_s;
  unsigned long long* status = ws + kCounters;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid == 0) tile_s = (int)atomicAdd(&ws[0], 1ull);
  __syncthreads();
  const int tile = tile_s;
  if (tile >= (int)gridDim.x) __trap();  // the workspace was not clean
  const long base = (long)tile * kTile;

  // The unscanned bounds, loaded and stored coalesced.
  const float n = __int2float_rn(n_out);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = j * kThreads + tid;
    const long e = base + i;
    int s = INT_MIN;
    if (e < P) {
      const float t = __fmul_rn(csum[e], n);
      const int k = min(max(__float2int_rz(t), 0), n_out - 1);
      s = min(k + (U[k] < __fsub_rn(t, __int2float_rn(k)) ? 1 : 0), n_out);
    }
    vals[padded(i)] = s;
  }
  __syncthreads();

  // The tile's scan: a thread's kItems entries, then across the threads.
  int v[kItems];
  int run = INT_MIN;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    run = max(run, vals[padded(tid * kItems + j)]);
    v[j] = run;
  }
  int inc = run;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc = max(inc, o);
  }
  int carry = __shfl_up_sync(kFull, inc, 1);
  if (lane == 0) carry = INT_MIN;
  if (lane == 31) warp_maxes[warp] = inc;
  __syncthreads();
  int agg = INT_MIN;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w == warp) carry = max(carry, agg);
    agg = max(agg, warp_maxes[w]);
  }

  // The tiles before this one.
  if (warp == 0) {
    const int before = gridDim.x > 1 ? look_back(status, tile, agg, lane)
                                     : INT_MIN;
    if (lane == 0) before_s = before;
  }
  __syncthreads();
  carry = max(carry, before_s);
#pragma unroll
  for (int j = 0; j < kItems; ++j)
    vals[padded(tid * kItems + j)] = max(v[j], carry);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = j * kThreads + tid;
    const long e = base + i;
    if (e < P) S[e] = e == P - 1 ? n_out : vals[padded(i)];
  }

  // The last block to finish leaves the workspace zeroed.
  if (gridDim.x == 1) {
    if (tid == 0) ws[0] = 0;
    return;
  }
  if (tid == 0) {
    __threadfence();
    last_s = atomicAdd(&ws[1], 1ull) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  for (int t = tid; t < (int)gridDim.x; t += kThreads) status[t] = kEmpty;
  if (tid == 0) ws[0] = ws[1] = 0;
}

}  // namespace

// The workspace's 64-bit words for a launch over P entries.
extern "C" int slam_offspring_bounds_workspace(int P) {
  return kCounters + (P + kTile - 1) / kTile;
}

extern "C" int slam_offspring_bounds(const float* csum, const float* U,
                                     int* S, int P, int n_out,
                                     unsigned long long* ws,
                                     cudaStream_t stream) {
  if (P <= 0) return 0;
  const int tiles = (P + kTile - 1) / kTile;
  offspring_bounds_kernel<<<tiles, kThreads, 0, stream>>>(csum, U, S, P,
                                                          n_out, ws);
  return (int)cudaGetLastError();
}
