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

}  // namespace slam
