// K4, the fused in-place FastSLAM 1 update on the landmark state.
//
// Replaces slam_tpu/ops/pallas/kernels.py:_fused_update_kernel and
// _fused_update_math (entry point fs1_update_tpu). Per particle p: for
// each matched observation k, read the landmark at slot[k] straight
// from lm [2, L, P] and lm_P [3, L, P], compute the Jacobians and the
// log-likelihood, accumulate dlogw, and write the 2x2 EKF update back to
// the same slot; for each ok_new k, write the new feature at
// slot_new[k]; finally logw[p] += dlogw.
//
// Bound: memory, and only the touched slots move. The TPU kernel
// streams all L slots of a particle block through VMEM and gathers and
// scatters them with one-hot matmuls; on this card a thread loads the
// at most 2K slots it touches directly, so a superstep moves
// 3 + (5 + 5) K_matched + 5 K_new floats per particle instead of
// 2 x 5L. Untouched slots keep their values, as under the TPU kernel's
// input/output aliasing. Neighbouring threads own neighbouring p, so
// each (slot, plane) access of a warp is one coalesced line.
//
// Race freedom: under known association a slot is used at most once
// per observation batch, matched slots are < n and new slots >= n, so
// each (slot, p) cell has exactly one writer and it is the thread that
// reads it. Slots outside [0, L) are dropped, as the JAX package's
// mode="drop" writes are.
#include <cuda_runtime.h>

#include "planes.cuh"

namespace {

__global__ void fs1_fused_update_kernel(
    const float* __restrict__ xv, float* __restrict__ logw,
    float* __restrict__ lm, float* __restrict__ lmP,
    const float* __restrict__ z, const int* __restrict__ slot,
    const unsigned char* __restrict__ matched,
    const int* __restrict__ slot_new,
    const unsigned char* __restrict__ ok_new, float r00, float r01,
    float r11, int K, int L, int P) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const float d = slam::fs1_update_column(
      xv[p], xv[P + p], xv[2 * P + p], lm, lmP, p, P, z, slot, matched,
      slot_new, ok_new, r00, r01, r11, K, L);
  logw[p] = logw[p] + d;
}

}  // namespace

extern "C" int slam_fs1_fused_update(
    const float* xv, float* logw, float* lm, float* lmP, const float* z,
    const int* slot, const unsigned char* matched, const int* slot_new,
    const unsigned char* ok_new, float r00, float r01, float r11, int K,
    int L, int P, cudaStream_t stream) {
  if (P <= 0) return 0;
  const int threads = 128;
  const int blocks = (P + threads - 1) / threads;
  fs1_fused_update_kernel<<<blocks, threads, 0, stream>>>(
      xv, logw, lm, lmP, z, slot, matched, slot_new, ok_new, r00, r01, r11,
      K, L, P);
  return (int)cudaGetLastError();
}
