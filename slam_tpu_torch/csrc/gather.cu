// G1 and G2, the resample gathers of the particle state.
//
// G1 replaces slam_tpu/ops/pallas/gather.py:_multi_gather_kernel (entry
// point sorted_gather_multi): out_i[c, j] = a_i[c, idx[j]] for a list of
// [C_i, P] planes in one launch.
// G2 replaces slam_tpu/ops/pallas/gather.py:_bounds_gather_kernel (entry
// point bounds_gather_multi): the same gather, with the ancestor of
// output column j decoded in the kernel from the offspring bounds S as
// the first g with S[g] > j (a binary search over S), so the ancestor
// vector is never written to device memory.
//
// Bound: memory. The main path gathers 10 + 5L rows of P floats, and
// every byte is read once and written once. One thread owns one output
// column and copies a chunk of rows, so each store of a warp is one
// coalesced line; stratified ancestors are non-decreasing, so a warp's
// loads fall on few lines too. The grid spans (column block x row
// chunk) to give the card enough blocks at small P. The copies are
// plain loads and stores: bit-exact, with none of the TPU kernel's
// one-hot matmuls, bf16 splits or byte planes.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxArrays = 8;
constexpr int kThreads = 128;
constexpr int kRowsPerBlock = 32;

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

// Copies rows [r0, r0 + kRowsPerBlock) of the stacked arrays for output
// column j from source column g.
__device__ __forceinline__ void copy_rows(const SlamGatherArrays& a, int r0,
                                          int j, int g, int P, int N) {
  const int r1 = r0 + kRowsPerBlock;
  int off = 0;
  for (int q = 0; q < a.n_arrays; ++q) {
    const int lo = max(r0, off);
    const int hi = min(r1, off + a.rows[q]);
    for (int r = lo; r < hi; ++r) {
      const long row = r - off;
      a.dst[q][row * N + j] = a.src[q][row * P + g];
    }
    off += a.rows[q];
  }
}

__global__ void sorted_gather_kernel(SlamGatherArrays a,
                                     const int* __restrict__ idx, int P,
                                     int N) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= N) return;
  const int g = min(max(idx[j], 0), P - 1);
  copy_rows(a, blockIdx.y * kRowsPerBlock, j, g, P, N);
}

__global__ void bounds_gather_kernel(SlamGatherArrays a,
                                     const int* __restrict__ S, int P) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= P) return;
  // First g with S[g] > j; S is non-decreasing with S[P - 1] == P.
  int lo = 0, hi = P - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (S[mid] > j) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  copy_rows(a, blockIdx.y * kRowsPerBlock, j, lo, P, P);
}

int total_rows(const SlamGatherArrays& a) {
  int r = 0;
  for (int q = 0; q < a.n_arrays; ++q) r += a.rows[q];
  return r;
}

}  // namespace

extern "C" int slam_sorted_gather(SlamGatherArrays arrays, const int* idx,
                                  int P, int N, cudaStream_t stream) {
  const int rows = total_rows(arrays);
  if (N <= 0 || rows <= 0) return 0;
  const dim3 grid((N + kThreads - 1) / kThreads,
                  (rows + kRowsPerBlock - 1) / kRowsPerBlock);
  sorted_gather_kernel<<<grid, kThreads, 0, stream>>>(arrays, idx, P, N);
  return (int)cudaGetLastError();
}

extern "C" int slam_bounds_gather(SlamGatherArrays arrays, const int* S,
                                  int P, cudaStream_t stream) {
  const int rows = total_rows(arrays);
  if (P <= 0 || rows <= 0) return 0;
  const dim3 grid((P + kThreads - 1) / kThreads,
                  (rows + kRowsPerBlock - 1) / kRowsPerBlock);
  bounds_gather_kernel<<<grid, kThreads, 0, stream>>>(arrays, S, P);
  return (int)cudaGetLastError();
}

extern "C" int slam_gather_max_arrays() { return kMaxArrays; }
