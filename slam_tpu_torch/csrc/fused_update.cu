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
  const float x = xv[p];
  const float y = xv[P + p];
  const float t = xv[2 * P + p];
  const long plane = (long)L * P;  // stride between component planes
  float d = 0.0f;
  for (int k = 0; k < K; ++k) {
    const float z0 = z[2 * k];
    const float z1 = z[2 * k + 1];
    const int s = slot[k];
    if (matched[k] && s >= 0 && s < L) {
      const long i = (long)s * P + p;
      const float lx = lm[i], ly = lm[plane + i];
      const float a00 = lmP[i], a01 = lmP[plane + i],
                  a11 = lmP[2 * plane + i];
      const slam::Jacobians J = slam::jacobians_planes(
          x, y, t, lx, ly, a00, a01, a11, r00, r01, r11);
      const float v0 = z0 - J.zr;
      const float v1 = slam::wrap_angle(z1 - J.zb);
      d += slam::log_gauss2_planes(v0, v1, J.s00, J.s01, J.s11);
      const slam::Feature f =
          slam::feature_update_planes(lx, ly, a00, a01, a11, v0, v1, J);
      lm[i] = f.x;
      lm[plane + i] = f.y;
      lmP[i] = f.p00;
      lmP[plane + i] = f.p01;
      lmP[2 * plane + i] = f.p11;
    }
    const int sn = slot_new[k];
    if (ok_new[k] && sn >= 0 && sn < L) {
      const long i = (long)sn * P + p;
      const slam::Feature f =
          slam::feature_init_planes(x, y, t, z0, z1, r00, r01, r11);
      lm[i] = f.x;
      lm[plane + i] = f.y;
      lmP[i] = f.p00;
      lmP[plane + i] = f.p01;
      lmP[2 * plane + i] = f.p11;
    }
  }
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
