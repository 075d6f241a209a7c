// Device versions of the plane algebra in slam_tpu_torch/ops/planes.py
// (itself the port of slam_tpu/ops/planes.py), for one (particle,
// observation) pair at a time.
//
// Every expression keeps the operation order of the Python twin, and
// the library is built without --use_fast_math and with --fmad=false,
// so a kernel and its plain twin differ only where the device's libm
// (sinf, cosf, logf) rounds differently from the host's. sqrtf and the
// divisions are IEEE-rounded.
#pragma once

#include <math.h>

namespace slam {

constexpr float kPi = (float)3.14159265358979323846;
constexpr float kTwoPi = (float)(2.0 * 3.14159265358979323846);
constexpr float kHalfPi = (float)(0.5 * 3.14159265358979323846);
constexpr float kLog2Pi = (float)1.8378770664093453;  // log(2 pi)

// Floored modulo into [-pi, pi): fmodf truncates toward zero, so a
// negative remainder is lifted by 2 pi, as jnp.mod and torch.remainder
// do.
__device__ __forceinline__ float wrap_angle(float a) {
  float r = fmodf(a + kPi, kTwoPi);
  if (r != 0.0f && r < 0.0f) r += kTwoPi;
  return r - kPi;
}

// wrap_angle, bit for bit, without fmodf where the argument lies within
// two periods of the result's range, as a heading plus one tick's turn
// always does. With s = a + pi and m = 2 pi (both as rounded to
// float32): for s in [0, m) fmodf(s, m) is s; for s in [m, 2 m) it is
// s - m, which float32 holds exactly (Sterbenz: m <= s <= 2 m), so the
// subtraction rounds nothing; for s in (-m, 0) it is s, which
// wrap_angle then lifts by m with one rounded addition, as here.
// Everything else (|s| >= 2 m, NaN) goes through fmodf. fmodf is an
// exact iterative remainder of some 30 instructions; the three ranges
// cost a few compares and selects. chip_smoke.py and the card tests
// compare the two functions on every float32 bit pattern
// (predict.cu:fast_math_sweep_kernel).
__device__ __forceinline__ float wrap_angle_fast(float a) {
  const float s = a + kPi;
  float r;
  if (s >= 0.0f && s < kTwoPi) {
    r = s;
  } else if (s >= kTwoPi && s < 2.0f * kTwoPi) {
    r = s - kTwoPi;
  } else if (s < 0.0f && s > -kTwoPi) {
    r = s + kTwoPi;
  } else {
    r = fmodf(s, kTwoPi);
    if (r != 0.0f && r < 0.0f) r += kTwoPi;
  }
  return r - kPi;
}

// The JAX package's atan2: odd minimax polynomial for atan on [0, 1]
// and quadrant reconstruction (slam_tpu/ops/planes.py:atan2_poly).
__device__ __forceinline__ float atan2_poly(float y, float x) {
  float ax = fabsf(x);
  float ay = fabsf(y);
  float mx = fmaxf(ax, ay);
  float mn = fminf(ax, ay);
  float z = mn / fmaxf(mx, 1e-30f);
  float s = z * z;
  float p = (((((-0.0117212f * s + 0.05265332f) * s - 0.11643287f) * s
               + 0.19354346f) * s - 0.33262348f) * s + 0.99997726f) * z;
  float r = (ay > ax) ? kHalfPi - p : p;
  r = (x < 0.0f) ? kPi - r : r;
  return (y < 0.0f) ? -r : r;
}

struct Jacobians {
  float zr, zb;          // predicted range and bearing
  float a, b, c, e;      // Hf = [[a, b], [c, e]]
  float s00, s01, s11;   // Sf = Hf Pf Hf^T + R, packed symmetric
};

__device__ __forceinline__ Jacobians jacobians_planes(
    float xvx, float xvy, float xvt, float lmx, float lmy, float p00,
    float p01, float p11, float r00, float r01, float r11) {
  Jacobians J;
  float dx = lmx - xvx;
  float dy = lmy - xvy;
  float d2 = fmaxf(dx * dx + dy * dy, 1e-12f);
  float d = sqrtf(d2);
  float inv_d = 1.0f / d;
  float inv_d2 = 1.0f / d2;
  J.zr = d;
  J.zb = wrap_angle(atan2_poly(dy, dx) - xvt);
  J.a = dx * inv_d;
  J.b = dy * inv_d;
  J.c = -dy * inv_d2;
  J.e = dx * inv_d2;
  float t0 = p00 * J.a + p01 * J.b;
  float t1 = p01 * J.a + p11 * J.b;
  float t2 = p00 * J.c + p01 * J.e;
  float t3 = p01 * J.c + p11 * J.e;
  J.s00 = J.a * t0 + J.b * t1 + r00;
  J.s01 = J.c * t0 + J.e * t1 + r01;
  J.s11 = J.c * t2 + J.e * t3 + r11;
  return J;
}

__device__ __forceinline__ float log_gauss2_planes(float v0, float v1,
                                                   float s00, float s01,
                                                   float s11) {
  float det = fmaxf(s00 * s11 - s01 * s01, 1e-30f);
  float quad = (s11 * v0 * v0 - 2.0f * s01 * v0 * v1 + s00 * v1 * v1) / det;
  return -0.5f * quad - kLog2Pi - 0.5f * logf(det);
}

struct Feature {
  float x, y, p00, p01, p11;
};

// 2x2 EKF update of one landmark: W = Pf Hf' S^-1; xf += W v;
// Pf -= W (Pf Hf')'.
__device__ __forceinline__ Feature feature_update_planes(
    float lmx, float lmy, float p00, float p01, float p11, float v0,
    float v1, const Jacobians& J) {
  float det = fmaxf(J.s00 * J.s11 - J.s01 * J.s01, 1e-30f);
  float i00 = J.s11 / det;
  float i01 = -J.s01 / det;
  float i11 = J.s00 / det;

  float pht00 = p00 * J.a + p01 * J.b;
  float pht01 = p00 * J.c + p01 * J.e;
  float pht10 = p01 * J.a + p11 * J.b;
  float pht11 = p01 * J.c + p11 * J.e;

  float w00 = pht00 * i00 + pht01 * i01;
  float w01 = pht00 * i01 + pht01 * i11;
  float w10 = pht10 * i00 + pht11 * i01;
  float w11 = pht10 * i01 + pht11 * i11;

  Feature f;
  f.x = lmx + w00 * v0 + w01 * v1;
  f.y = lmy + w10 * v0 + w11 * v1;
  f.p00 = p00 - (w00 * pht00 + w01 * pht01);
  f.p01 = p01 - 0.5f * ((w00 * pht10 + w01 * pht11)
                        + (w10 * pht00 + w11 * pht01));
  f.p11 = p11 - (w10 * pht10 + w11 * pht11);
  return f;
}

// New landmark from the pose and one (range, bearing): mean, and
// Pf = Gz R Gz^T.
__device__ __forceinline__ Feature feature_init_planes(
    float xvx, float xvy, float xvt, float zr, float zb, float r00,
    float r01, float r11) {
  float s = sinf(xvt + zb);
  float c = cosf(xvt + zb);
  float g00 = c, g01 = -zr * s;
  float g10 = s, g11 = zr * c;
  float t0 = g00 * r00 + g01 * r01;
  float t1 = g00 * r01 + g01 * r11;
  float t2 = g10 * r00 + g11 * r01;
  float t3 = g10 * r01 + g11 * r11;
  Feature f;
  f.x = xvx + zr * c;
  f.y = xvy + zr * s;
  f.p00 = t0 * g00 + t1 * g01;
  f.p01 = t0 * g10 + t1 * g11;
  f.p11 = t2 * g10 + t3 * g11;
  return f;
}

// Packed symmetric 3x3, the FastSLAM 2 pose covariance: (00, 01, 02,
// 11, 12, 22).
struct Sym3 {
  float a, b, c, d, e, f;
};

__device__ __forceinline__ void sym3_mul_vec(const Sym3& P, float v0,
                                             float v1, float v2, float& o0,
                                             float& o1, float& o2) {
  o0 = P.a * v0 + P.b * v1 + P.c * v2;
  o1 = P.b * v0 + P.d * v1 + P.e * v2;
  o2 = P.c * v0 + P.e * v1 + P.f * v2;
}

// One FastSLAM 2 proposal-refinement step in covariance form
// (ops/planes.py:refine_pose_planes): K = Pv Hv' (Sf + Hv Pv Hv')^-1,
// dx = K v, Pv <- Pv - K (Hv Pv)'. Hv = [[hv00, hv01, 0], [hv10, hv11,
// -1]] with hv = -(a, b, c, e) of the feature Jacobian. Updates Pv in
// place and returns the pose step in dx0..dx2.
__device__ __forceinline__ void refine_pose_planes(const Jacobians& J,
                                                   Sym3& Pv, float v0,
                                                   float v1, float& dx0,
                                                   float& dx1, float& dx2) {
  const float hv00 = -J.a, hv01 = -J.b, hv10 = -J.c, hv11 = -J.e;
  float ua0, ua1, ua2, ub0, ub1, ub2;
  sym3_mul_vec(Pv, hv00, hv01, 0.0f, ua0, ua1, ua2);
  sym3_mul_vec(Pv, hv10, hv11, -1.0f, ub0, ub1, ub2);
  const float t00 = hv00 * ua0 + hv01 * ua1;
  const float t01 = hv00 * ub0 + hv01 * ub1;
  const float t11 = hv10 * ub0 + hv11 * ub1 - ub2;
  const float s00 = J.s00 + t00;
  const float s01 = J.s01 + t01;
  const float s11 = J.s11 + t11;
  const float det = fmaxf(s00 * s11 - s01 * s01, 1e-30f);
  const float i00 = s11 / det, i01 = -s01 / det, i11 = s00 / det;
  const float k00 = ua0 * i00 + ub0 * i01;
  const float k01 = ua0 * i01 + ub0 * i11;
  const float k10 = ua1 * i00 + ub1 * i01;
  const float k11 = ua1 * i01 + ub1 * i11;
  const float k20 = ua2 * i00 + ub2 * i01;
  const float k21 = ua2 * i01 + ub2 * i11;
  dx0 = k00 * v0 + k01 * v1;
  dx1 = k10 * v0 + k11 * v1;
  dx2 = k20 * v0 + k21 * v1;
  Pv.a = Pv.a - (k00 * ua0 + k01 * ub0);
  Pv.b = Pv.b - (k00 * ua1 + k01 * ub1);
  Pv.c = Pv.c - (k00 * ua2 + k01 * ub2);
  Pv.d = Pv.d - (k10 * ua1 + k11 * ub1);
  Pv.e = Pv.e - (k10 * ua2 + k11 * ub2);
  Pv.f = Pv.f - (k20 * ua2 + k21 * ub2);
}

// One matched observation (z0, z1) of feature f, seen from the pose
// (x, y, t): its log-likelihood is added to d, and f's 2x2 EKF update
// is returned. K4 (fused_update.cu), K2 (observe.cu) and K5
// (resample_update.cu) all run it, so their updates and sums are
// bit-equal.
__device__ __forceinline__ Feature fs1_match(float x, float y, float t,
                                             const Feature& f, float z0,
                                             float z1, float r00, float r01,
                                             float r11, float& d) {
  const Jacobians J = jacobians_planes(x, y, t, f.x, f.y, f.p00, f.p01,
                                       f.p11, r00, r01, r11);
  const float v0 = z0 - J.zr;
  const float v1 = wrap_angle(z1 - J.zb);
  d += log_gauss2_planes(v0, v1, J.s00, J.s01, J.s11);
  return feature_update_planes(f.x, f.y, f.p00, f.p01, f.p11, v0, v1, J);
}

}  // namespace slam
