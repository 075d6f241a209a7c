// S1, the simulator's control ticks of a superstep in one launch.
//
// No TPU kernel stands behind this one: the JAX package runs a tick
// inside its superstep's lax.scan, while the port ran each tick as some
// 72 eager operations on 0-d tensors, 12-15 microseconds of host
// dispatch apiece for a few nanoseconds of arithmetic. A tick is, in
// the operation order of the plain twin (ops/kernels/vehicle.py:
// control_multi_plain, which runs sim/vehicle.py:steer_and_move and
// runtime/loop.py's dead reckoning T times):
//
//   steering: d2 = |wp - xy|^2 to the current waypoint; reached when
//             d2 < AT_WAYPOINT^2; the next waypoint, a loop counted at
//             the end of the list, done after the last loop; the
//             heading error to the target, wrapped, clamped by the rate
//             RATEG dt, the steer clamped to +-MAXG (kept when the list
//             is exhausted);
//   truth:    the bicycle step with the new steer; pose, steer,
//             waypoint and loops keep their old values once done, and
//             done stays set;
//   controls: v = V + n0 sigma_v, g = steer + n1 sigma_g, with the
//             tick's row (n0, n1) of the noise;
//   odometry: the bicycle step of dr (zero at the superstep's start)
//             with the noisy (v, g).
//
// The scalars are rounded to float32 as ATen rounds a Python scalar
// against a float32 tensor: products of two Python floats (V dt,
// AT_WAYPOINT^2, RATEG dt) are folded in double by the caller and cast
// once. ATen divides a CUDA tensor by a host scalar as a product with
// the scalar's float32 reciprocal (div_true_kernel_cuda), so the turn
// V dt sin G / WHEELBASE is taken here as (V dt sin G) (1 / WHEELBASE),
// as the eager code computes it on the card. torch.remainder's floored
// modulo is planes.cuh:wrap_angle_fast, which equals wrap_angle on every
// float32 (predict.cu's sweep). The library is built with --fmad=false
// and without fast math, so every product and sum rounds on its own as
// in the eager operations, and sinf, cosf and atan2f are the device
// libm's, as ATen's.
//
// Bound: latency. One thread walks the T ticks in order; a tick is a
// chain of some 70 dependent float operations (two sinf, two cosf, one
// atan2f among them) through the pose, the steer and dr, and a read of
// one or two waypoints, which stay in L1 after the first tick. The
// state is 24 bytes in and out, the noise and the outputs 20 bytes a
// tick: neither bytes nor operations bound it, the length of the chain
// does, a few microseconds for T = 8. There is nothing to spread over
// threads: tick t + 1 needs tick t's pose, steer and waypoint.
#include <cuda_runtime.h>
#include <math.h>

#include "planes.cuh"

namespace {

// torch.clamp against host scalars: NaN passes, else min(max(v, lo), hi).
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// One bicycle step of (x, y, th) with speed term vdt = V dt and steer G,
// as sim/vehicle.py:predict_true_position on the card.
__device__ __forceinline__ void bicycle(float vdt, float G, float inv_wb,
                                        float& x, float& y, float& th) {
  const float a = G + th;
  const float nx = x + vdt * cosf(a);
  const float ny = y + vdt * sinf(a);
  th = slam::wrap_angle_fast(th + (vdt * sinf(G)) * inv_wb);
  x = nx;
  y = ny;
}

__global__ void sim_control_multi_kernel(
    const float* __restrict__ pose_in, const float* __restrict__ steer_in,
    const int* __restrict__ waypoint_in, const int* __restrict__ loops_in,
    const bool* __restrict__ done_in, const float* __restrict__ waypoints,
    const float* __restrict__ noise, float V, float vdt, float dt,
    float wheelbase, float at2, float max_delta, float maxg, float sigma_v,
    float sigma_g, int n_wp, int T, float* __restrict__ pose_out,
    float* __restrict__ steer_out, int* __restrict__ waypoint_out,
    int* __restrict__ loops_out, bool* __restrict__ done_out,
    float* __restrict__ ctl, float* __restrict__ poses,
    float* __restrict__ dr) {
  float x = pose_in[0], y = pose_in[1], th = pose_in[2];
  float steer = *steer_in;
  int wp = *waypoint_in;
  int loops = *loops_in;
  bool done = *done_in;
  float dx = 0.0f, dy = 0.0f, dth = 0.0f;
  const float inv_wb = 1.0f / wheelbase;
  for (int t = 0; t < T; ++t) {
    // sim/vehicle.py:_update_steering. A waypoint index outside the
    // list (a state from another map), where index_select would fault,
    // reads the nearest row rather than past the tensor.
    const int cur = min(max(wp, 0), n_wp - 1);
    const float ex = __ldg(waypoints + 2 * cur) - x;
    const float ey = __ldg(waypoints + 2 * cur + 1) - y;
    const float d2 = ex * ex + ey * ey;
    int next = d2 < at2 ? wp + 1 : wp;
    const bool exhausted = next >= n_wp;
    const int new_loops = (exhausted && loops > 1) ? loops - 1 : loops;
    const bool finished = exhausted && loops <= 1;
    next = exhausted ? 0 : next;
    const int target = min(max(next, 0), n_wp - 1);
    const float tx = __ldg(waypoints + 2 * target);
    const float ty = __ldg(waypoints + 2 * target + 1);
    float delta =
        slam::wrap_angle_fast((atan2f(ty - y, tx - x) - th) - steer);
    delta = clamp(delta, -max_delta, max_delta);
    const float new_steer =
        exhausted ? steer : clamp(steer + delta, -maxg, maxg);
    // steer_and_move: the truth step, frozen once done.
    float nx = x, ny = y, nth = th;
    bicycle(vdt, new_steer, inv_wb, nx, ny, nth);
    done = done || finished;
    if (!done) {
      x = nx;
      y = ny;
      th = nth;
      steer = new_steer;
      wp = next;
      loops = new_loops;
    }
    // Simulator.control_step's noisy controls, then the odometry.
    const float v = V + noise[2 * t] * sigma_v;
    const float g = steer + noise[2 * t + 1] * sigma_g;
    ctl[2 * t] = v;
    ctl[2 * t + 1] = g;
    poses[3 * t] = x;
    poses[3 * t + 1] = y;
    poses[3 * t + 2] = th;
    bicycle(v * dt, g, inv_wb, dx, dy, dth);
  }
  pose_out[0] = x;
  pose_out[1] = y;
  pose_out[2] = th;
  *steer_out = steer;
  *waypoint_out = wp;
  *loops_out = loops;
  *done_out = done;
  dr[0] = dx;
  dr[1] = dy;
  dr[2] = dth;
}

}  // namespace

extern "C" int slam_sim_control_multi(
    const float* pose, const float* steer, const int* waypoint,
    const int* loops, const bool* done, const float* waypoints,
    const float* noise, float V, float vdt, float dt, float wheelbase,
    float at2, float max_delta, float maxg, float sigma_v, float sigma_g,
    int n_wp, int T, float* pose_out, float* steer_out, int* waypoint_out,
    int* loops_out, bool* done_out, float* ctl, float* poses, float* dr,
    cudaStream_t stream) {
  sim_control_multi_kernel<<<1, 1, 0, stream>>>(
      pose, steer, waypoint, loops, done, waypoints, noise, V, vdt, dt,
      wheelbase, at2, max_delta, maxg, sigma_v, sigma_g, n_wp, T, pose_out,
      steer_out, waypoint_out, loops_out, done_out, ctl, poses, dr);
  return (int)cudaGetLastError();
}
