// K1, the batched range-bearing Jacobians.
//
// Replaces slam_tpu/ops/pallas/kernels.py:_jacobian_kernel (entry point
// jacobians_tpu), the TPU analogue of the FPGA accelerator's
// computeJacobians block. One thread per (observation k, particle p):
// planes.cuh:jacobians_planes at the particle's pose against the
// gathered landmark planes, and its 13 outputs written to the planes of
// out [13, K, P] in the order of ops/planes.py:JacobianPlanes (zr, zb,
// hv00, hv01, hv10, hv11, a, b, c, e, s00, s01, s11), hv = -(a, b, c, e).
//
// Bound: memory. Each (k, p) reads 8 floats and writes 13 against some
// 40 flops. The grid's y axis is k and its x axis p, so neighbouring
// threads take neighbouring p and every load and store of a warp is one
// coalesced line; no thread divides to find its (k, p).
#include <cuda_runtime.h>

#include "planes.cuh"

namespace {

__global__ void jacobians_kernel(
    const float* __restrict__ xv, const float* __restrict__ lmx,
    const float* __restrict__ lmy, const float* __restrict__ p00,
    const float* __restrict__ p01, const float* __restrict__ p11,
    float r00, float r01, float r11, int K, int P, float* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int k = blockIdx.y;
  if (p >= P) return;
  const long i = (long)k * P + p;
  const slam::Jacobians J =
      slam::jacobians_planes(xv[p], xv[P + p], xv[2 * P + p], lmx[i],
                             lmy[i], p00[i], p01[i], p11[i], r00, r01, r11);
  const long plane = (long)K * P;
  out[i] = J.zr;
  out[plane + i] = J.zb;
  out[2 * plane + i] = -J.a;
  out[3 * plane + i] = -J.b;
  out[4 * plane + i] = -J.c;
  out[5 * plane + i] = -J.e;
  out[6 * plane + i] = J.a;
  out[7 * plane + i] = J.b;
  out[8 * plane + i] = J.c;
  out[9 * plane + i] = J.e;
  out[10 * plane + i] = J.s00;
  out[11 * plane + i] = J.s01;
  out[12 * plane + i] = J.s11;
}

}  // namespace

extern "C" int slam_jacobians(const float* xv, const float* lmx,
                              const float* lmy, const float* p00,
                              const float* p01, const float* p11, float r00,
                              float r01, float r11, int K, int P, float* out,
                              cudaStream_t stream) {
  if (P <= 0 || K <= 0) return 0;
  const int threads = 256;
  const dim3 grid((P + threads - 1) / threads, K);
  jacobians_kernel<<<grid, threads, 0, stream>>>(
      xv, lmx, lmy, p00, p01, p11, r00, r01, r11, K, P, out);
  return (int)cudaGetLastError();
}
