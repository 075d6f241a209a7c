// K3, the FastSLAM 2 sequential proposal refinement.
//
// Replaces slam_tpu/ops/pallas/kernels.py:_refine_kernel (entry point
// fs2_refine_tpu). One thread per particle p keeps its pose (x, y,
// theta) and packed pose covariance Pv (6 floats) in registers through
// the K observations, in order. For each matched k: the Jacobians at the
// current pose against the gathered landmark planes, the innovation with
// the bearing wrapped, and one covariance-form refinement step
// (planes.cuh:refine_pose_planes); the pose moves by K v and the heading
// is wrapped. An unmatched k leaves the state untouched: the branch is
// taken on matched[k], which is the same for every thread, so a warp
// never diverges, and the slot-0 planes an unmatched k was gathered
// from (possibly a zero-distance landmark) are never read. xv_r and
// Pv_r are written once.
//
// Bound: memory, barely. Each particle reads 9 + 5K floats and writes
// 9, against some 150 flops per matched (k, p); the chain over k is
// sequential per particle, so the parallelism is across particles only,
// and P = 2^20 gives 8,192 blocks of 128 threads. Neighbouring threads
// take neighbouring p, so every plane load is one coalesced line.
#include <cuda_runtime.h>

#include "planes.cuh"

namespace {

__global__ void fs2_refine_kernel(
    const float* __restrict__ xv, const float* __restrict__ Pv,
    const float* __restrict__ lmx, const float* __restrict__ lmy,
    const float* __restrict__ p00, const float* __restrict__ p01,
    const float* __restrict__ p11, const float* __restrict__ z,
    const unsigned char* __restrict__ matched, float r00, float r01,
    float r11, int K, int P, float* __restrict__ xv_r,
    float* __restrict__ Pv_r) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  float x = xv[p];
  float y = xv[P + p];
  float t = xv[2 * P + p];
  slam::Sym3 S;
  S.a = Pv[p];
  S.b = Pv[P + p];
  S.c = Pv[2 * P + p];
  S.d = Pv[3 * P + p];
  S.e = Pv[4 * P + p];
  S.f = Pv[5 * P + p];
  for (int k = 0; k < K; ++k) {
    if (!matched[k]) continue;
    const long i = (long)k * P + p;
    const slam::Jacobians J = slam::jacobians_planes(
        x, y, t, lmx[i], lmy[i], p00[i], p01[i], p11[i], r00, r01, r11);
    const float v0 = z[2 * k] - J.zr;
    const float v1 = slam::wrap_angle(z[2 * k + 1] - J.zb);
    float dx0, dx1, dx2;
    slam::refine_pose_planes(J, S, v0, v1, dx0, dx1, dx2);
    x = x + dx0;
    y = y + dx1;
    t = slam::wrap_angle(t + dx2);
  }
  xv_r[p] = x;
  xv_r[P + p] = y;
  xv_r[2 * P + p] = t;
  Pv_r[p] = S.a;
  Pv_r[P + p] = S.b;
  Pv_r[2 * P + p] = S.c;
  Pv_r[3 * P + p] = S.d;
  Pv_r[4 * P + p] = S.e;
  Pv_r[5 * P + p] = S.f;
}

}  // namespace

extern "C" int slam_fs2_refine(const float* xv, const float* Pv,
                               const float* lmx, const float* lmy,
                               const float* p00, const float* p01,
                               const float* p11, const float* z,
                               const unsigned char* matched, float r00,
                               float r01, float r11, int K, int P,
                               float* xv_r, float* Pv_r,
                               cudaStream_t stream) {
  if (P <= 0) return 0;
  const int threads = 128;
  const int blocks = (P + threads - 1) / threads;
  fs2_refine_kernel<<<blocks, threads, 0, stream>>>(
      xv, Pv, lmx, lmy, p00, p01, p11, z, matched, r00, r01, r11, K, P,
      xv_r, Pv_r);
  return (int)cudaGetLastError();
}
