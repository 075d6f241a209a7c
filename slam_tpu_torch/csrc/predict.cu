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
// Bound: instruction issue, not bytes. The state crosses device memory
// once per superstep (24 bytes per particle in and out, 72 for K6b:
// 25 MB and 75 MB at 2^20 particles, 8 and 22 microseconds), while a
// thread issues a few hundred instructions per tick: the Philox rounds,
// the libm calls (log, sin, cos; none is the fast-math kind, and the
// file is built without fused multiply-adds, so that every value
// rounds as in the plain twins), an IEEE divide and the wrap. There is
// no matrix product here, so the tensor cores (wgmma) have nothing to
// do, and the 24 to 72 bytes a thread moves are coalesced loads and
// stores that bulk copies (TMA) would not improve. What the card
// offers these kernels is issue slots, its separate float32 and
// integer pipes, and registers. The design spends fewer instructions
// per tick and leaves every value's operation order as it was, so the
// kernels stay bit-equal to their twins:
//
// - The kernels are templates on add_noise, so the noise branch is
//   taken at compile time. The tick loop is one runtime loop for every
//   T, unrolled by four: the Philox blocks and Box-Muller pairs of the
//   four ticks depend on (p, t) only and can be scheduled beside the
//   serial chain through theta, and the loop's own instructions are
//   spread over four ticks.
// - What a tick computes from its controls alone (fs1_terms,
//   fs2_terms: V dt, sin G, the turn V dt sin G / WB, and for K6b the
//   third row of Gu with its products with Q) is the same for every
//   particle when the noise is off. Thread t of each block then
//   computes tick t's terms once into shared memory, and a particle's
//   tick is one sincosf and the covariance algebra: K6b's seven libm
//   calls and two divides per tick become one sincosf. A launch takes
//   at most kMaxTicks ticks (one per thread of a block); the launchers
//   below cut a longer T into several launches, which carry the state
//   through device memory unchanged. With the noise on each particle
//   has its own (V, G) and runs the same functions itself.
// - sin and cos of one argument (G + theta; 2 pi u2 in Box-Muller; G in
//   fs2_terms) come from one sincosf, which reduces the argument once.
//   It returns the bits of sinf and cosf for every float32 argument;
//   fast_math_sweep_kernel below checks all 2^32 on the card.
// - The heading is wrapped by planes.cuh:wrap_angle_fast, which skips
//   fmodf for an argument within two periods and is checked by the same
//   sweep.
// - Philox: see philox.cuh (one wide multiply per product, the round
//   keys computed once per thread, the zero counter words folded).
//
// Against the per-tick torch path each kernel replaces some 25 launches
// per tick (K6b: some 60), and 8 ticks per superstep, with one launch.
// The seed words are read through a pointer, so the host never waits
// for the generator that drew them.
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"
#include "planes.cuh"

namespace {

constexpr float kInv24 = 5.9604644775390625e-08f;  // 2^-24
constexpr int kThreads = 256;
constexpr int kMaxTicks = kThreads;  // ticks per launch
constexpr int kTickUnroll = 4;       // copies of a tick in the loop body

// sin and cos of one argument.
__device__ __forceinline__ void sin_cos(float a, float& s, float& c) {
  sincosf(a, &s, &c);
}

// (V, G) of particle p at tick t: the Philox / Box-Muller sample around
// the nominal controls (vn, gn).
__device__ __forceinline__ void sample_vg(uint32_t p, uint32_t t,
                                          const slam::PhiloxKeys& ks,
                                          float vn, float gn, float l00,
                                          float l10, float l11, float& V,
                                          float& G) {
  uint32_t b0, b1;
  slam::philox4x32_10_w01(p, t, ks, b0, b1);
  const float u1 = (float)((b0 >> 8) + 1u) * kInv24;
  const float u2 = (float)(b1 >> 8) * kInv24;
  const float r = sqrtf(-2.0f * logf(u1));
  float s, c;
  sin_cos(slam::kTwoPi * u2, s, c);
  const float e0 = r * c;
  const float e1 = r * s;
  V = vn + l00 * e0;
  G = gn + l10 * e0 + l11 * e1;
}

// What a FastSLAM 1 tick needs of its controls: V dt, G and the turn
// V dt sin G / WB.
struct Fs1Terms {
  float vdt, G, dth;
};

__device__ __forceinline__ Fs1Terms fs1_terms(float V, float G,
                                              float wheelbase, float dt) {
  Fs1Terms u;
  u.vdt = V * dt;
  u.G = G;
  u.dth = u.vdt * sinf(G) / wheelbase;
  return u;
}

__device__ __forceinline__ void fs1_tick(const Fs1Terms& u, float& x,
                                         float& y, float& th) {
  float s, c;
  sin_cos(u.G + th, s, c);
  x = x + u.vdt * c;
  y = y + u.vdt * s;
  th = slam::wrap_angle_fast(th + u.dth);
}

// Ticks t0 .. t0 + T - 1 (T <= kMaxTicks) of controls ctl [T, 2].
template <bool kNoise>
__global__ void __launch_bounds__(kThreads) fs1_predict_multi_kernel(
    float* __restrict__ xv, const int* __restrict__ seed,
    const float* __restrict__ ctl, float l00, float l10, float l11,
    float wheelbase, float dt, int t0, int T, int P) {
  __shared__ float4 terms[kNoise ? 1 : kMaxTicks];
  if constexpr (!kNoise) {
    if (threadIdx.x < T) {
      const Fs1Terms u = fs1_terms(ctl[2 * threadIdx.x],
                                   ctl[2 * threadIdx.x + 1], wheelbase, dt);
      terms[threadIdx.x] = make_float4(u.vdt, u.G, u.dth, 0.0f);
    }
    __syncthreads();
  }
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  float x = xv[p];
  float y = xv[P + p];
  float th = xv[2 * P + p];
  slam::PhiloxKeys ks;
  if constexpr (kNoise) {
    ks = slam::philox_key_schedule((uint32_t)seed[0], (uint32_t)seed[1]);
  }
#pragma unroll(kTickUnroll)
  for (int t = 0; t < T; ++t) {
    Fs1Terms u;
    if constexpr (kNoise) {
      float V, G;
      sample_vg((uint32_t)p, (uint32_t)(t0 + t), ks, ctl[2 * t],
                ctl[2 * t + 1], l00, l10, l11, V, G);
      u = fs1_terms(V, G, wheelbase, dt);
    } else {
      const float4 v = terms[t];
      u.vdt = v.x;
      u.G = v.y;
      u.dth = v.z;
    }
    fs1_tick(u, x, y, th);
  }
  xv[p] = x;
  xv[P + p] = y;
  xv[2 * P + p] = th;
}

// What a FastSLAM 2 tick needs of its controls: V dt, G, the turn, the
// third row g2 = (dt sin G / WB, V dt cos G / WB) of Gu, Q g2' as
// (u0, u1), and g2 Q g2'.
struct Fs2Terms {
  float vdt, G, dth, ff, g20, g21, u0, u1;
};

__device__ __forceinline__ Fs2Terms fs2_terms(float V, float G, float q00,
                                              float q01, float q11,
                                              float wheelbase, float dt) {
  Fs2Terms u;
  float sg, cg;
  sin_cos(G, sg, cg);
  u.vdt = V * dt;
  u.G = G;
  u.g20 = dt * sg / wheelbase;
  u.g21 = u.vdt * cg / wheelbase;
  u.u0 = q00 * u.g20 + q01 * u.g21;
  u.u1 = q01 * u.g20 + q11 * u.g21;
  u.ff = u.g20 * u.u0 + u.g21 * u.u1;
  u.dth = u.vdt * sg / wheelbase;
  return u;
}

// Gi Q Gj' for rows gi = (gi0, gi1), gj = (gj0, gj1) of Gu.
__device__ __forceinline__ float gq(float gi0, float gi1, float gj0,
                                    float gj1, float q00, float q01,
                                    float q11) {
  return gi0 * (q00 * gj0 + q01 * gj1) + gi1 * (q01 * gj0 + q11 * gj1);
}

__device__ __forceinline__ void fs2_tick(const Fs2Terms& u, float q00,
                                         float q01, float q11, float dt,
                                         float& x, float& y, float& th,
                                         slam::Sym3& S) {
  float sgt, cgt;
  sin_cos(u.G + th, sgt, cgt);
  // Gv = I + al e0 e2' + be e1 e2'.
  const float al = -u.vdt * sgt;
  const float be = u.vdt * cgt;
  const float n00 = S.a + 2.0f * al * S.c + al * al * S.f;
  const float n01 = S.b + al * S.e + be * S.c + al * be * S.f;
  const float n02 = S.c + al * S.f;
  const float n11 = S.d + 2.0f * be * S.e + be * be * S.f;
  const float n12 = S.e + be * S.f;
  // Gu rows g0 = (dt cgt, al), g1 = (dt sgt, be), g2 as in fs2_terms.
  const float g00 = dt * cgt, g01 = al;
  const float g10 = dt * sgt, g11 = be;
  S.a = n00 + gq(g00, g01, g00, g01, q00, q01, q11);
  S.b = n01 + gq(g00, g01, g10, g11, q00, q01, q11);
  S.c = n02 + (g00 * u.u0 + g01 * u.u1);
  S.d = n11 + gq(g10, g11, g10, g11, q00, q01, q11);
  S.e = n12 + (g10 * u.u0 + g11 * u.u1);
  S.f = S.f + u.ff;
  x = x + be;
  y = y + u.vdt * sgt;
  th = slam::wrap_angle_fast(th + u.dth);
}

template <bool kNoise>
__global__ void __launch_bounds__(kThreads) fs2_predict_multi_kernel(
    float* __restrict__ xv, float* __restrict__ Pv,
    const int* __restrict__ seed, const float* __restrict__ ctl, float l00,
    float l10, float l11, float q00, float q01, float q11, float wheelbase,
    float dt, int t0, int T, int P) {
  __shared__ float4 terms[kNoise ? 1 : 2 * kMaxTicks];
  if constexpr (!kNoise) {
    if (threadIdx.x < T) {
      const Fs2Terms u =
          fs2_terms(ctl[2 * threadIdx.x], ctl[2 * threadIdx.x + 1], q00, q01,
                    q11, wheelbase, dt);
      terms[2 * threadIdx.x] = make_float4(u.vdt, u.G, u.dth, u.ff);
      terms[2 * threadIdx.x + 1] = make_float4(u.g20, u.g21, u.u0, u.u1);
    }
    __syncthreads();
  }
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  float x = xv[p];
  float y = xv[P + p];
  float th = xv[2 * P + p];
  slam::Sym3 S{Pv[p],         Pv[P + p],     Pv[2 * P + p],
               Pv[3 * P + p], Pv[4 * P + p], Pv[5 * P + p]};
  slam::PhiloxKeys ks;
  if constexpr (kNoise) {
    ks = slam::philox_key_schedule((uint32_t)seed[0], (uint32_t)seed[1]);
  }
#pragma unroll(kTickUnroll)
  for (int t = 0; t < T; ++t) {
    Fs2Terms u;
    if constexpr (kNoise) {
      float V, G;
      sample_vg((uint32_t)p, (uint32_t)(t0 + t), ks, ctl[2 * t],
                ctl[2 * t + 1], l00, l10, l11, V, G);
      u = fs2_terms(V, G, q00, q01, q11, wheelbase, dt);
    } else {
      const float4 v = terms[2 * t];
      const float4 w = terms[2 * t + 1];
      u.vdt = v.x;
      u.G = v.y;
      u.dth = v.z;
      u.ff = v.w;
      u.g20 = w.x;
      u.g21 = w.y;
      u.u0 = w.z;
      u.u1 = w.w;
    }
    fs2_tick(u, q00, q01, q11, dt, x, y, th, S);
  }
  xv[p] = x;
  xv[P + p] = y;
  xv[2 * P + p] = th;
  Pv[p] = S.a;
  Pv[P + p] = S.b;
  Pv[2 * P + p] = S.c;
  Pv[3 * P + p] = S.d;
  Pv[4 * P + p] = S.e;
  Pv[5 * P + p] = S.f;
}

// Bit patterns match, or both are NaN.
__device__ __forceinline__ bool same_float(float a, float b) {
  return __float_as_uint(a) == __float_as_uint(b) || (a != a && b != b);
}

// The two substitutions above, held to what they replace on every
// float32 bit pattern: out[0], out[1] count the arguments whose sincosf
// sine, cosine is not sinf's, cosf's; out[2] those that wrap_angle_fast
// wraps otherwise than wrap_angle; out[3], out[4] are the least bit
// pattern of a trig and of a wrap mismatch (the caller sets them to
// 2^32, which stands for none).
__global__ void __launch_bounds__(kThreads) fast_math_sweep_kernel(
    unsigned long long* __restrict__ out) {
  constexpr unsigned long long kPatterns = 1ull << 32;
  unsigned long long bad_sin = 0, bad_cos = 0, bad_wrap = 0;
  unsigned long long first_trig = kPatterns, first_wrap = kPatterns;
  const unsigned long long stride =
      (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long i = (unsigned long long)blockIdx.x * blockDim.x +
                              threadIdx.x;
       i < kPatterns; i += stride) {
    const float a = __uint_as_float((uint32_t)i);
    float s, c;
    sin_cos(a, s, c);
    const bool ok_sin = same_float(s, sinf(a));
    const bool ok_cos = same_float(c, cosf(a));
    const bool ok_wrap =
        same_float(slam::wrap_angle_fast(a), slam::wrap_angle(a));
    bad_sin += !ok_sin;
    bad_cos += !ok_cos;
    bad_wrap += !ok_wrap;
    if (!(ok_sin && ok_cos) && i < first_trig) first_trig = i;
    if (!ok_wrap && i < first_wrap) first_wrap = i;
  }
  if (bad_sin) atomicAdd(out, bad_sin);
  if (bad_cos) atomicAdd(out + 1, bad_cos);
  if (bad_wrap) atomicAdd(out + 2, bad_wrap);
  if (first_trig < kPatterns) atomicMin(out + 3, first_trig);
  if (first_wrap < kPatterns) atomicMin(out + 4, first_wrap);
}

}  // namespace

extern "C" int slam_fs1_predict_multi(float* xv, const int* seed,
                                      const float* controls, float l00,
                                      float l10, float l11, float wheelbase,
                                      float dt, int add_noise, int T, int P,
                                      cudaStream_t stream) {
  if (P <= 0) return 0;
  const int blocks = (P + kThreads - 1) / kThreads;
  const auto kernel = add_noise ? fs1_predict_multi_kernel<true>
                                : fs1_predict_multi_kernel<false>;
  for (int t0 = 0; t0 < T; t0 += kMaxTicks) {
    kernel<<<blocks, kThreads, 0, stream>>>(
        xv, seed, controls + 2 * t0, l00, l10, l11, wheelbase, dt, t0,
        min(kMaxTicks, T - t0), P);
  }
  return (int)cudaGetLastError();
}

extern "C" int slam_fs2_predict_multi(float* xv, float* Pv, const int* seed,
                                      const float* controls, float l00,
                                      float l10, float l11, float q00,
                                      float q01, float q11, float wheelbase,
                                      float dt, int add_noise, int T, int P,
                                      cudaStream_t stream) {
  if (P <= 0) return 0;
  const int blocks = (P + kThreads - 1) / kThreads;
  const auto kernel = add_noise ? fs2_predict_multi_kernel<true>
                                : fs2_predict_multi_kernel<false>;
  for (int t0 = 0; t0 < T; t0 += kMaxTicks) {
    kernel<<<blocks, kThreads, 0, stream>>>(
        xv, Pv, seed, controls + 2 * t0, l00, l10, l11, q00, q01, q11,
        wheelbase, dt, t0, min(kMaxTicks, T - t0), P);
  }
  return (int)cudaGetLastError();
}

// Runs fast_math_sweep_kernel over all 2^32 float32 bit patterns; out
// holds five 64-bit words, the last two preset to 2^32.
extern "C" int slam_predict_fast_math_sweep(unsigned long long* out,
                                            cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  fast_math_sweep_kernel<<<8 * sms, kThreads, 0, stream>>>(out);
  return (int)cudaGetLastError();
}
