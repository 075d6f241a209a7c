// K5, the fused resample + FastSLAM 1 update of the deferred-resample
// path.
//
// Replaces slam_tpu/ops/pallas/kernels.py:_deferred_kernel (entry point
// fs1_resample_update_tpu; update math _fused_update_math). The landmark
// planes lm [2, L, P] and lmP [3, L, P] still hold the particles as they
// were before the previous superstep's resample, whose ancestors are
// pending as offspring bounds S (ancestor g owns output columns
// [S[g-1], S[g]), S[P-1] == P). Semantics: K4 applied after gathering by
// S. One thread owns output column j:
//
//   1. g = the first index with S[g] > j (a binary search over S, as
//      G2 in gather.cu decodes it; no ancestor vector is written);
//   2. all 5 L rows of column g of the old planes are copied to column
//      j of the fresh output planes;
//   3. K4's body (planes.cuh:fs1_update_column) runs on column j of the
//      output, with the pose xv[:, j] (already permuted by the caller),
//      and logw[j] gains the summed log-likelihood.
//
// Bound: memory. Every launch reads the old state and writes the new
// one once: 2 x 20 L bytes per particle, 8.05 GB at L = 192 and
// P = 2^20. The TPU kernel's DMA windows, int8 one-hot selection and
// per-block window metadata (lo, nch, ident) exist to gather columns on
// a machine with no per-lane loads; here each thread loads its
// ancestor's column directly. Stratified ancestors are non-decreasing
// in j, so a warp's loads fall on one or two lines of each row and its
// stores on one. Each output column has one writer, so no atomics. It
// cannot run in place (column j may be the ancestor of column j + 1), so
// the caller holds the old and the new state while it runs.
#include <cuda_runtime.h>

#include "planes.cuh"

namespace {

__global__ void fs1_resample_update_kernel(
    const float* __restrict__ xv, float* __restrict__ logw,
    const float* __restrict__ lm, const float* __restrict__ lmP,
    float* __restrict__ lm_out, float* __restrict__ lmP_out,
    const int* __restrict__ S, const float* __restrict__ z,
    const int* __restrict__ slot, const unsigned char* __restrict__ matched,
    const int* __restrict__ slot_new,
    const unsigned char* __restrict__ ok_new, float r00, float r01,
    float r11, int K, int L, int P) {
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
  const long g = lo;
  const long n2 = 2L * L, n3 = 3L * L;
#pragma unroll 8
  for (long r = 0; r < n2; ++r) lm_out[r * P + j] = lm[r * P + g];
#pragma unroll 8
  for (long r = 0; r < n3; ++r) lmP_out[r * P + j] = lmP[r * P + g];
  const float d = slam::fs1_update_column(
      xv[j], xv[P + j], xv[2 * P + j], lm_out, lmP_out, j, P, z, slot,
      matched, slot_new, ok_new, r00, r01, r11, K, L);
  logw[j] = logw[j] + d;
}

}  // namespace

extern "C" int slam_fs1_resample_update(
    const float* xv, float* logw, const float* lm, const float* lmP,
    float* lm_out, float* lmP_out, const int* S, const float* z,
    const int* slot, const unsigned char* matched, const int* slot_new,
    const unsigned char* ok_new, float r00, float r01, float r11, int K,
    int L, int P, cudaStream_t stream) {
  if (P <= 0) return 0;
  const int threads = 128;
  const int blocks = (P + threads - 1) / threads;
  fs1_resample_update_kernel<<<blocks, threads, 0, stream>>>(
      xv, logw, lm, lmP, lm_out, lmP_out, S, z, slot, matched, slot_new,
      ok_new, r00, r01, r11, K, L, P);
  return (int)cudaGetLastError();
}
