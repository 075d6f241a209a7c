// K2, the fused FastSLAM observe on pre-gathered landmark planes.
//
// Replaces slam_tpu/ops/pallas/kernels.py:_observe_kernel (entry point
// fs1_observe_tpu -> _observe_call). Per particle p and observation k:
// Jacobians at the particle's pose, innovation with the bearing wrapped,
// the 2-D Gaussian log-likelihood summed over matched k into dlogw[p],
// and the 2x2 EKF update of matched landmarks; unmatched landmarks pass
// through unchanged.
//
// Bound: memory. Each particle reads 3 + 5K floats and writes 1 + 5K,
// against some 100 flops per (k, p) pair. One thread owns one particle
// column and walks k in a register loop, so dlogw needs no reduction
// across threads; neighbouring threads take neighbouring p, so every
// plane load and store of a warp is one coalesced 128-byte line. The
// TPU kernel's VMEM blocking and lane padding have no counterpart here:
// the ragged last block is masked.
#include <cuda_runtime.h>

#include "planes.cuh"

namespace {

__global__ void fs1_observe_kernel(
    const float* __restrict__ xv, const float* __restrict__ lmx,
    const float* __restrict__ lmy, const float* __restrict__ p00,
    const float* __restrict__ p01, const float* __restrict__ p11,
    const float* __restrict__ z, const unsigned char* __restrict__ matched,
    float r00, float r01, float r11, int K, int P,
    float* __restrict__ dlogw, float* __restrict__ nx,
    float* __restrict__ ny, float* __restrict__ np00,
    float* __restrict__ np01, float* __restrict__ np11) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const float x = xv[p];
  const float y = xv[P + p];
  const float t = xv[2 * P + p];
  float d = 0.0f;
  for (int k = 0; k < K; ++k) {
    const long i = (long)k * P + p;
    const float lx = lmx[i], ly = lmy[i];
    const float a00 = p00[i], a01 = p01[i], a11 = p11[i];
    if (matched[k]) {
      const slam::Jacobians J = slam::jacobians_planes(
          x, y, t, lx, ly, a00, a01, a11, r00, r01, r11);
      const float v0 = z[2 * k] - J.zr;
      const float v1 = slam::wrap_angle(z[2 * k + 1] - J.zb);
      d += slam::log_gauss2_planes(v0, v1, J.s00, J.s01, J.s11);
      const slam::Feature f =
          slam::feature_update_planes(lx, ly, a00, a01, a11, v0, v1, J);
      nx[i] = f.x;
      ny[i] = f.y;
      np00[i] = f.p00;
      np01[i] = f.p01;
      np11[i] = f.p11;
    } else {
      nx[i] = lx;
      ny[i] = ly;
      np00[i] = a00;
      np01[i] = a01;
      np11[i] = a11;
    }
  }
  dlogw[p] = d;
}

}  // namespace

extern "C" int slam_fs1_observe(
    const float* xv, const float* lmx, const float* lmy, const float* p00,
    const float* p01, const float* p11, const float* z,
    const unsigned char* matched, float r00, float r01, float r11, int K,
    int P, float* dlogw, float* nx, float* ny, float* np00, float* np01,
    float* np11, cudaStream_t stream) {
  if (P <= 0) return 0;
  const int threads = 128;
  const int blocks = (P + threads - 1) / threads;
  fs1_observe_kernel<<<blocks, threads, 0, stream>>>(
      xv, lmx, lmy, p00, p01, p11, z, matched, r00, r01, r11, K, P, dlogw,
      nx, ny, np00, np01, np11);
  return (int)cudaGetLastError();
}
