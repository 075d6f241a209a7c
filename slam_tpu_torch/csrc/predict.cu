// K6, the multi-tick FastSLAM 1 predict with the random draws made in
// the kernel.
//
// Replaces slam_tpu/ops/pallas/kernels.py:_predict_kernel and
// _sample_vg (entry point fs1_predict_multi_tpu). One thread per
// particle p keeps its pose (x, y, theta) in registers through all T
// control ticks of a superstep and writes it back once, in place, as
// the TPU kernel aliases its pose input to its output. Per tick t:
//
//   b0, b1 = words 0, 1 of Philox4x32-10 at counter (p, t, 0, 0) under
//            the key (seed[0], seed[1]);
//   u1 = ((b0 >> 8) + 1) 2^-24 in (0, 1], u2 = (b1 >> 8) 2^-24 in [0, 1);
//   e0, e1 = Box-Muller normals of (u1, u2);
//   V = vn + l00 e0, G = gn + l10 e0 + l11 e1   (chol(Q) = [[l00, 0],
//                                                [l10, l11]]);
//   then the bicycle step in the operation order of
//   slam_tpu_torch/models/rbpf.py:propagate_poses.
//
// With add_noise == 0 every particle takes the nominal controls.
//
// Bound: arithmetic. The pose crosses device memory once per superstep
// (24 bytes per particle in and out); per tick a thread spends two
// 32-bit multiply-highs per Philox round and five transcendentals.
// Against the per-tick torch path this replaces some 25 launches per
// tick, and 8 ticks per superstep, with one launch. The seed words are
// read through a pointer, so the host never waits for the generator
// that drew them.
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"
#include "planes.cuh"

namespace {

constexpr float kInv24 = 5.9604644775390625e-08f;  // 2^-24

__global__ void fs1_predict_multi_kernel(
    float* __restrict__ xv, const int* __restrict__ seed,
    const float* __restrict__ ctl, float l00, float l10, float l11,
    float wheelbase, float dt, int add_noise, int T, int P) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  float x = xv[p];
  float y = xv[P + p];
  float th = xv[2 * P + p];
  const uint32_t k0 = (uint32_t)seed[0];
  const uint32_t k1 = (uint32_t)seed[1];
  for (int t = 0; t < T; ++t) {
    const float vn = ctl[2 * t];
    const float gn = ctl[2 * t + 1];
    float V = vn;
    float G = gn;
    if (add_noise) {
      const slam::Philox4 b =
          slam::philox4x32_10((uint32_t)p, (uint32_t)t, 0u, 0u, k0, k1);
      const float u1 = (float)((b.w[0] >> 8) + 1u) * kInv24;
      const float u2 = (float)(b.w[1] >> 8) * kInv24;
      const float r = sqrtf(-2.0f * logf(u1));
      const float e0 = r * cosf(slam::kTwoPi * u2);
      const float e1 = r * sinf(slam::kTwoPi * u2);
      V = vn + l00 * e0;
      G = gn + l10 * e0 + l11 * e1;
    }
    x = x + V * dt * cosf(G + th);
    y = y + V * dt * sinf(G + th);
    th = slam::wrap_angle(th + V * dt * sinf(G) / wheelbase);
  }
  xv[p] = x;
  xv[P + p] = y;
  xv[2 * P + p] = th;
}

}  // namespace

extern "C" int slam_fs1_predict_multi(float* xv, const int* seed,
                                      const float* controls, float l00,
                                      float l10, float l11, float wheelbase,
                                      float dt, int add_noise, int T, int P,
                                      cudaStream_t stream) {
  if (P <= 0 || T <= 0) return 0;
  const int threads = 256;
  const int blocks = (P + threads - 1) / threads;
  fs1_predict_multi_kernel<<<blocks, threads, 0, stream>>>(
      xv, seed, controls, l00, l10, l11, wheelbase, dt, add_noise, T, P);
  return (int)cudaGetLastError();
}
