// E1, the block EKF's predict tick in one launch.
//
// No TPU kernel stands behind this one: the JAX package leaves this
// predict (slam_tpu/parallel/ekf.py) to XLA, which fuses it into its
// superstep, while the port ran each tick as 97 ATen calls, ~77 of them
// device launches of a few nanoseconds of work each, 12-15 microseconds
// of host dispatch apiece. A tick is parallel/ekf.py:_predict_local_plain,
// the plain twin:
//
//   predict:  the bicycle step of the pose (x, y, th) with controls
//             (v, g): Gv, Gu and the new pose (models/ekf.py:
//             motion_jacobians); P00 = Gv P00 Gv' + Gu Q Gu';
//             P0m = Gv P0m; the map's means and Pmm untouched;
//   heading:  (with heading_known) the scalar Joseph update by the IMU
//             heading phi: s = P00[2, 2] + sigma_phi^2, c = P[:, 2],
//             W = c / s, x += W wrap(phi - th), P' = P - W c' - c W'
//             + s W W' on the pose block and the cross rows, and the
//             landmark block's term -(1/s) c_m c_m' deferred as the
//             column u = c_m / sqrt(s), written into hk[:, hk_n] (or,
//             with no column free, into a buffer that the caller folds
//             into Pmm).
//
// Numbers. The eager code's 3x3 products go to cuBLAS, which may fuse
// multiply-adds, so no operation order is the twin's on the card. The
// kernel computes the tick in double from the float32 state and rounds
// each output to float32 once: against the twin run in float64 its error
// is the output's own rounding, no more than the eager float32 code's.
// The configuration's numbers (wheelbase, dt, sigma_phi) come as
// doubles, as the float64 twin takes them. A heading that rounds to
// float32's pi, outside the eager wrap's [-pi, pi), is stored as -pi.
//
// Bound: latency. The work is the 3x3 chain (pose, Gv, Gu, P00, s, the
// gain's pose rows and the innovation, four sines and cosines among
// them) and one pass over the map's 2L columns, each of which evolves
// alone given the chain: 3 reads and 3 writes of P0m, one of x and one
// write of hk's column, ~0.7 MB at L = 10,000 (~1.3 MB counted in the
// 32-byte sectors of hk's strided column), a fraction of a microsecond
// at 3.35 TB/s. So one launch per tick does it all: thread 0 of every
// block computes the chain into shared memory, redundantly (no block
// waits on another), while the block's threads load their columns; then
// each thread applies the chain to its column. Block 0 writes the new
// pose and P00. x, P00 and P0m go to fresh outputs (block 0 writes the
// pose while other blocks read the old one); hk's column is written in
// place, as the eager code writes it.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr double kPi = 3.14159265358979323846;
constexpr double kTwoPi = 2.0 * kPi;
// float32's nearest to pi, above it: the eager float32 wrap's
// (r + pi) mod 2 pi - pi never returns it.
constexpr float kPiF = 3.14159265358979323846f;

// geometry.py:wrap_angle in double: torch.remainder's floored modulo.
__device__ __forceinline__ double wrap(double a) {
  double r = fmod(a + kPi, kTwoPi);
  if (r != 0.0 && r < 0.0) r += kTwoPi;
  return r - kPi;
}

__device__ __forceinline__ float heading_f32(double h) {
  const float f = static_cast<float>(h);
  return f >= kPiF ? -kPiF : f;
}

// What every column needs of the tick's 3x3 chain.
struct Chain {
  double vts, vtc;  // Gv's cross terms: Gv = [1 0 -vts; 0 1 vtc; 0 0 1]
  double cp[3];     // the predicted P00's third column
  double Wp[3];     // the heading gain's pose rows, cp / s
  double s;         // the heading innovation's variance
  double sqrt_s;
  double vh;        // the heading innovation, wrapped
};

// The chain, in the twin's order; block 0 also writes the new pose and
// P00.
template <bool kHeading>
__device__ void chain(const float* __restrict__ x_in,
                      const float* __restrict__ P00_in,
                      const float* __restrict__ Q, double v, double g,
                      double phi, double wheelbase, double dt,
                      double sigma_phi, float* __restrict__ x_out,
                      float* __restrict__ P00_out, Chain& out) {
  const double th = x_in[2];
  double s, c, sg, cg;
  sincos(g + th, &s, &c);
  sincos(g, &sg, &cg);
  const double vdt = v * dt;
  const double vts = vdt * s, vtc = vdt * c;
  const double Gv[3][3] = {{1.0, 0.0, -vts}, {0.0, 1.0, vtc}, {0.0, 0.0, 1.0}};
  const double Gu[3][2] = {{dt * c, -vts},
                           {dt * s, vtc},
                           {dt * sg / wheelbase, vdt * cg / wheelbase}};
  double pose[3] = {x_in[0] + vtc, x_in[1] + vts,
                    wrap(th + vdt * sg / wheelbase)};

  // P = (Gv P00) Gv' + (Gu Q) Gu'.
  double A[3][3], B[3][2], P[3][3];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      A[i][j] = 0.0;
      for (int k = 0; k < 3; ++k) A[i][j] += Gv[i][k] * P00_in[3 * k + j];
    }
    for (int j = 0; j < 2; ++j)
      B[i][j] = Gu[i][0] * Q[j] + Gu[i][1] * Q[2 + j];
  }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      double gvt = 0.0;
      for (int k = 0; k < 3; ++k) gvt += A[i][k] * Gv[j][k];
      P[i][j] = gvt + (B[i][0] * Gu[j][0] + B[i][1] * Gu[j][1]);
    }

  out.vts = vts;
  out.vtc = vtc;
  if (kHeading) {
    const double sv = P[2][2] + sigma_phi * sigma_phi;
    double cp[3], Wp[3];
    for (int i = 0; i < 3; ++i) {
      cp[i] = P[i][2];
      Wp[i] = cp[i] / sv;
    }
    const double vh = wrap(phi - pose[2]);
    for (int i = 0; i < 3; ++i) pose[i] += Wp[i] * vh;
    pose[2] = wrap(pose[2]);
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        P[i][j] = P[i][j] - Wp[i] * cp[j] - cp[i] * Wp[j] + sv * (Wp[i] * Wp[j]);
    for (int i = 0; i < 3; ++i) {
      out.cp[i] = cp[i];
      out.Wp[i] = Wp[i];
    }
    out.s = sv;
    out.sqrt_s = sqrt(sv);
    out.vh = vh;
  }
  if (blockIdx.x == 0) {
    x_out[0] = static_cast<float>(pose[0]);
    x_out[1] = static_cast<float>(pose[1]);
    x_out[2] = heading_f32(pose[2]);
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) P00_out[3 * i + j] = static_cast<float>(P[i][j]);
  }
}

template <bool kHeading>
__global__ void __launch_bounds__(kThreads) ekf_predict_kernel(
    const float* __restrict__ x_in, const float* __restrict__ P00_in,
    const float* __restrict__ P0m_in, const float* __restrict__ Q,
    const float* __restrict__ v_in, const float* __restrict__ g_in,
    const float* __restrict__ phi_in, double wheelbase, double dt,
    double sigma_phi, int n2, float* __restrict__ x_out,
    float* __restrict__ P00_out, float* __restrict__ P0m_out,
    float* __restrict__ u_out, long long u_stride) {
  __shared__ Chain ch;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const bool col = j < n2;
  // The column's loads go out while thread 0 computes the chain.
  double p0 = 0.0, p1 = 0.0, p2 = 0.0, xm = 0.0;
  if (col) {
    p0 = P0m_in[j];
    p1 = P0m_in[n2 + j];
    p2 = P0m_in[2 * static_cast<long long>(n2) + j];
    xm = x_in[3 + j];
  }
  if (threadIdx.x == 0)
    chain<kHeading>(x_in, P00_in, Q, *v_in, *g_in, kHeading ? *phi_in : 0.0,
                    wheelbase, dt, sigma_phi, x_out, P00_out, ch);
  __syncthreads();
  if (!col) return;

  // P0m = Gv P0m.
  const double q[3] = {p0 - ch.vts * p2, p1 + ch.vtc * p2, p2};
  if (!kHeading) {
    for (int i = 0; i < 3; ++i)
      P0m_out[i * static_cast<long long>(n2) + j] = static_cast<float>(q[i]);
    x_out[3 + j] = static_cast<float>(xm);
    return;
  }
  // The heading's Joseph update on the cross rows, and its deferred
  // landmark term.
  const double cm = q[2];
  const double Wm = cm / ch.s;
  x_out[3 + j] = static_cast<float>(xm + Wm * ch.vh);
  for (int i = 0; i < 3; ++i)
    P0m_out[i * static_cast<long long>(n2) + j] = static_cast<float>(
        q[i] - ch.Wp[i] * cm - ch.cp[i] * Wm + ch.s * (ch.Wp[i] * Wm));
  u_out[j * u_stride] = static_cast<float>(cm / ch.sqrt_s);
}

}  // namespace

extern "C" int slam_ekf_predict(
    const float* x, const float* P00, const float* P0m, const float* Q,
    const float* v, const float* g, const float* phi, double wheelbase,
    double dt, double sigma_phi, int heading_known, int n2, float* x_out,
    float* P00_out, float* P0m_out, float* u, int u_stride,
    cudaStream_t stream) {
  const int blocks = n2 > 0 ? (n2 + kThreads - 1) / kThreads : 1;
  if (heading_known)
    ekf_predict_kernel<true><<<blocks, kThreads, 0, stream>>>(
        x, P00, P0m, Q, v, g, phi, wheelbase, dt, sigma_phi, n2, x_out,
        P00_out, P0m_out, u, u_stride);
  else
    ekf_predict_kernel<false><<<blocks, kThreads, 0, stream>>>(
        x, P00, P0m, Q, v, g, phi, wheelbase, dt, sigma_phi, n2, x_out,
        P00_out, P0m_out, u, u_stride);
  return (int)cudaGetLastError();
}
