// K6 and K6b, the multi-tick predicts of FastSLAM 1 and FastSLAM 2
// with the random draws made in the kernel.
//
// K6 replaces slam_tpu/ops/pallas/kernels.py:_predict_kernel and
// _sample_vg (entry point fs1_predict_multi_tpu); K6b replaces
// _predict_kernel_fs2 (entry point fs2_predict_multi_tpu). One thread
// per particle p keeps its pose (x, y, theta), and for K6b its packed
// pose covariance (6 floats), in registers through all T control ticks
// of a superstep and writes them back once, in place, as the TPU
// kernels alias their inputs to their outputs. Per tick t:
//
//   b0, b1 = words 0, 1 of Philox4x32-10 at counter (p, t, 0, 0) under
//            the key (seed[0], seed[1]);
//   u1 = ((b0 >> 8) + 1) 2^-24 in (0, 1], u2 = (b1 >> 8) 2^-24 in [0, 1);
//   e0, e1 = Box-Muller normals of (u1, u2);
//   V = vn + l00 e0, G = gn + l10 e0 + l11 e1   (chol(Q) = [[l00, 0],
//                                                [l10, l11]]);
//   K6b: Pv <- Gv Pv Gv' + Gu Q Gu' in the operation order of
//        slam_tpu_torch/models/fastslam2.py:propagate_pose_covariance;
//   then the bicycle step in the operation order of
//   slam_tpu_torch/models/rbpf.py:propagate_poses.
//
// With add_noise == 0 every particle takes the nominal controls.
//
// Bound: arithmetic. The state crosses device memory once per superstep
// (24 bytes per particle in and out, 72 for K6b); per tick a thread
// spends two 32-bit multiply-highs per Philox round and five (K6b: seven)
// transcendentals. Against the per-tick torch path this replaces some
// 25 launches per tick (K6b: some 60), and 8 ticks per superstep, with
// one launch. The seed words are read through a pointer, so the host
// never waits for the generator that drew them.
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"
#include "planes.cuh"

namespace {

constexpr float kInv24 = 5.9604644775390625e-08f;  // 2^-24

// (V, G) of particle p at tick t: the nominal controls, or with
// add_noise their Philox / Box-Muller sample.
__device__ __forceinline__ void sample_vg(int p, int t, uint32_t k0,
                                          uint32_t k1, float vn, float gn,
                                          float l00, float l10, float l11,
                                          int add_noise, float& V, float& G) {
  V = vn;
  G = gn;
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
}

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
    float V, G;
    sample_vg(p, t, k0, k1, ctl[2 * t], ctl[2 * t + 1], l00, l10, l11,
              add_noise, V, G);
    x = x + V * dt * cosf(G + th);
    y = y + V * dt * sinf(G + th);
    th = slam::wrap_angle(th + V * dt * sinf(G) / wheelbase);
  }
  xv[p] = x;
  xv[P + p] = y;
  xv[2 * P + p] = th;
}

// Gi Q Gj' for rows gi = (gi0, gi1), gj = (gj0, gj1) of Gu.
__device__ __forceinline__ float gq(float gi0, float gi1, float gj0,
                                    float gj1, float q00, float q01,
                                    float q11) {
  return gi0 * (q00 * gj0 + q01 * gj1) + gi1 * (q01 * gj0 + q11 * gj1);
}

__global__ void fs2_predict_multi_kernel(
    float* __restrict__ xv, float* __restrict__ Pv,
    const int* __restrict__ seed, const float* __restrict__ ctl, float l00,
    float l10, float l11, float q00, float q01, float q11, float wheelbase,
    float dt, int add_noise, int T, int P) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  float x = xv[p];
  float y = xv[P + p];
  float th = xv[2 * P + p];
  float a = Pv[p], b = Pv[P + p], c = Pv[2 * P + p];
  float d = Pv[3 * P + p], e = Pv[4 * P + p], f = Pv[5 * P + p];
  const uint32_t k0 = (uint32_t)seed[0];
  const uint32_t k1 = (uint32_t)seed[1];
  for (int t = 0; t < T; ++t) {
    float V, G;
    sample_vg(p, t, k0, k1, ctl[2 * t], ctl[2 * t + 1], l00, l10, l11,
              add_noise, V, G);
    const float cgt = cosf(G + th);
    const float sgt = sinf(G + th);
    const float sg = sinf(G);
    // Gv = I + al e0 e2' + be e1 e2'.
    const float al = -V * dt * sgt;
    const float be = V * dt * cgt;
    const float n00 = a + 2.0f * al * c + al * al * f;
    const float n01 = b + al * e + be * c + al * be * f;
    const float n02 = c + al * f;
    const float n11 = d + 2.0f * be * e + be * be * f;
    const float n12 = e + be * f;
    // Gu rows g0 = (dt cgt, al), g1 = (dt sgt, be),
    // g2 = (dt sin G / WB, V dt cos G / WB).
    const float g00 = dt * cgt, g01 = al;
    const float g10 = dt * sgt, g11 = be;
    const float g20 = dt * sg / wheelbase;
    const float g21 = V * dt * cosf(G) / wheelbase;
    a = n00 + gq(g00, g01, g00, g01, q00, q01, q11);
    b = n01 + gq(g00, g01, g10, g11, q00, q01, q11);
    c = n02 + gq(g00, g01, g20, g21, q00, q01, q11);
    d = n11 + gq(g10, g11, g10, g11, q00, q01, q11);
    e = n12 + gq(g10, g11, g20, g21, q00, q01, q11);
    f = f + gq(g20, g21, g20, g21, q00, q01, q11);
    x = x + V * dt * cgt;
    y = y + V * dt * sgt;
    th = slam::wrap_angle(th + V * dt * sg / wheelbase);
  }
  xv[p] = x;
  xv[P + p] = y;
  xv[2 * P + p] = th;
  Pv[p] = a;
  Pv[P + p] = b;
  Pv[2 * P + p] = c;
  Pv[3 * P + p] = d;
  Pv[4 * P + p] = e;
  Pv[5 * P + p] = f;
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

extern "C" int slam_fs2_predict_multi(float* xv, float* Pv, const int* seed,
                                      const float* controls, float l00,
                                      float l10, float l11, float q00,
                                      float q01, float q11, float wheelbase,
                                      float dt, int add_noise, int T, int P,
                                      cudaStream_t stream) {
  if (P <= 0 || T <= 0) return 0;
  const int threads = 256;
  const int blocks = (P + threads - 1) / threads;
  fs2_predict_multi_kernel<<<blocks, threads, 0, stream>>>(
      xv, Pv, seed, controls, l00, l10, l11, q00, q01, q11, wheelbase, dt,
      add_noise, T, P);
  return (int)cudaGetLastError();
}
