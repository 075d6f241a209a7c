// G1 and G2, the resample gathers of the particle state.
//
// G1 replaces slam_tpu/ops/pallas/gather.py:_multi_gather_kernel (entry
// point sorted_gather_multi): out_i[c, j] = a_i[c, idx[j]] for a list of
// [C_i, P] planes in one launch.
// G2 replaces slam_tpu/ops/pallas/gather.py:_bounds_gather_kernel (entry
// point bounds_gather_multi): the same gather, with the ancestor of
// output column j decoded in the kernel from the offspring bounds S as
// the first g with S[g] > j, so the ancestor vector is never written to
// device memory.
//
// Bound: memory. The least traffic reads each distinct ancestor's
// column of the 10 + 5L rows once and writes every output row once:
// at most 1.06 GB at 1010 rows and P = 2^17 (0.32 ms at 3.35 TB/s). At
// the reference's P = 100 the work is a few hundred kilobytes, and the
// time is the launch and the depth of each thread's chain of loads.
//
// Design. Both kernels share one copy stage. A block owns a tile of
// kTile consecutive output columns and a chunk of rows, sized on the
// host so that even P = 100 spreads over some 64 blocks:
//   - the tile's ancestors are decoded once into shared memory: G1
//     reads them from idx; G2 finds the ends of the tile's ancestor run
//     with two warp-wide 32-way searches of S (stratified ancestors are
//     non-decreasing) and the block walks S between them;
//   - each thread owns 4 adjacent output columns and writes each row as
//     one 16-byte store; the 32 threads of a warp cover a tile row, so
//     their loads fall on the few lines the tile's ancestors span, and
//     each thread loads kBatch rows before it stores them, to keep loads
//     in flight.
// The copies are plain loads and stores: bit-exact, with none of the
// TPU kernel's one-hot matmuls, bf16 splits or byte planes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bounds.cuh"

namespace {

constexpr int kMaxArrays = 8;
constexpr int kThreads = 128;
constexpr int kCols = 4;                       // adjacent columns/thread
constexpr int kQuads = 32;                     // threads across a tile row
constexpr int kTile = kQuads * kCols;          // output columns per block
constexpr int kRowLanes = kThreads / kQuads;   // rows copied side by side
constexpr int kBatch = 4;                      // rows loaded before stores
constexpr int kRowStep = kRowLanes * kBatch;
constexpr int kTargetBlocks = 2048;

}  // namespace

// Passed by value: the planes to gather, as base pointers and row
// counts. Each array is [rows[a], P] in, [rows[a], N] out, row-major.
struct SlamGatherArrays {
  const float* src[kMaxArrays];
  float* dst[kMaxArrays];
  int rows[kMaxArrays];
  int n_arrays;
};

namespace {

// The ancestors of output columns [j0, j0 + jn) into anc: from idx
// (G1, clamped into [0, P)) or decoded from the bounds S (G2).
__device__ void decode_tile(const int* __restrict__ idx,
                            const int* __restrict__ S, int P, int j0,
                            int jn, int* anc, int* ends) {
  if (idx != nullptr) {
    for (int j = threadIdx.x; j < jn; j += kThreads)
      anc[j] = min(max(idx[j0 + j], 0), P - 1);
    __syncthreads();
    return;
  }
  slam::decode_bounds(S, P, j0, jn, anc, ends, kThreads);
}

// The copy stage both gathers share: rows [r0, r1) of the stacked
// arrays at this block's tile of output columns.
__global__ void __launch_bounds__(kThreads) gather_kernel(
    SlamGatherArrays a, const int* __restrict__ idx,
    const int* __restrict__ S, int P, int N, int rows_per_block,
    int vec_ok) {
  __shared__ int anc[kTile];
  __shared__ int ends[2];
  const int j0 = blockIdx.x * kTile;
  const int jn = min(kTile, N - j0);
  decode_tile(idx, S, P, j0, jn, anc, ends);

  const int quad = threadIdx.x % kQuads, lane_row = threadIdx.x / kQuads;
  const int jt = j0 + quad * kCols;  // this thread's first column
  const int n = max(0, min(kCols, jn - quad * kCols));
  if (n == 0) return;
  const bool vec = vec_ok && n == kCols;
  int g[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) g[c] = anc[quad * kCols + min(c, n - 1)];

  const int r0 = blockIdx.y * rows_per_block;
  const int r1 = r0 + rows_per_block;
  int off = 0;
  for (int q = 0; q < a.n_arrays; ++q) {
    const int lo = max(r0, off), hi = min(r1, off + a.rows[q]);
    const float* __restrict__ src = a.src[q];
    float* __restrict__ dst = a.dst[q];
    for (int r = lo + lane_row; r < hi; r += kRowStep) {
      float v[kBatch][kCols];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const long row = r + b * kRowLanes - off;
        if (row + off < hi) {
#pragma unroll
          for (int c = 0; c < kCols; ++c) v[b][c] = __ldg(src + row * P + g[c]);
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const long row = r + b * kRowLanes - off;
        if (row + off >= hi) continue;
        float* out = dst + row * N + jt;
        if (vec) {
          *reinterpret_cast<float4*>(out) =
              make_float4(v[b][0], v[b][1], v[b][2], v[b][3]);
        } else {
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            if (c < n) out[c] = v[b][c];
        }
      }
    }
    off += a.rows[q];
  }
}

int total_rows(const SlamGatherArrays& a) {
  int r = 0;
  for (int q = 0; q < a.n_arrays; ++q) r += a.rows[q];
  return r;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

int launch(const SlamGatherArrays& a, const int* idx, const int* S, int P,
           int N, cudaStream_t stream) {
  const int rows = total_rows(a);
  if (N <= 0 || rows <= 0) return 0;
  const int tiles = (N + kTile - 1) / kTile;
  // Enough row chunks to give the card some kTargetBlocks blocks, none
  // smaller than one kRowStep of rows.
  int chunks = (kTargetBlocks + tiles - 1) / tiles;
  chunks = max(1, min(chunks, (rows + kRowStep - 1) / kRowStep));
  int rows_per_block = (rows + chunks - 1) / chunks;
  rows_per_block = (rows_per_block + kRowStep - 1) / kRowStep * kRowStep;
  chunks = (rows + rows_per_block - 1) / rows_per_block;
  bool vec = N % kCols == 0;
  for (int q = 0; q < a.n_arrays; ++q) vec = vec && aligned16(a.dst[q]);
  const dim3 grid(tiles, chunks);
  gather_kernel<<<grid, kThreads, 0, stream>>>(a, idx, S, P, N,
                                               rows_per_block, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int slam_sorted_gather(SlamGatherArrays arrays, const int* idx,
                                  int P, int N, cudaStream_t stream) {
  return launch(arrays, idx, nullptr, P, N, stream);
}

extern "C" int slam_bounds_gather(SlamGatherArrays arrays, const int* S,
                                  int P, cudaStream_t stream) {
  return launch(arrays, nullptr, S, P, P, stream);
}

extern "C" int slam_gather_max_arrays() { return kMaxArrays; }
