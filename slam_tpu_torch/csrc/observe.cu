// K2, the in-place FastSLAM 1 update at any particle count, with one
// thread per (observation, particle) pair.
//
// Replaces slam_tpu/ops/pallas/kernels.py:_observe_kernel (entry point
// fs1_observe_tpu -> _observe_call) together with what the JAX package
// runs around it: the gather of the matched landmark planes, the scatter
// of their updates, the weight delta and add_new_features' planes. The
// JAX package sends a particle count that is no multiple of 128 there
// only because a TPU block is 128 lanes wide; the function is K4's
// (csrc/fused_update.cu), so K2 takes K4's contract: per particle p,
// each matched observation k updates the landmark at slot[k] of
// lm [2, L, P] and lm_P [3, L, P] in place and adds its log-likelihood
// to logw[p]; each ok_new k writes its new feature at slot_new[k]. The
// id table and the live count stay with the caller. Slots outside
// [0, L) are dropped, as in K4.
//
// Bound: at P = 100 (the reference default), the latency of one
// observation's dependent chain: the Jacobians, IEEE divides, atan2,
// sqrt and log of planes.cuh:fs1_match. One thread per particle
// walking the K observations (K4's first map) is K chains long on one
// SM at P = 100. Here a block holds all K observations of PB particles, p
// fastest, so that each (slot, plane) access of a warp is contiguous:
// PB = 8 below kWideP particles (P = 100, K = 15: 13 blocks of 120
// threads), else 16, widened until a block has 128 threads. Where K x PB
// would pass 1024 threads, each thread takes k, k + Kt, ... in order. At
// large P the bytes bound K2 as they bound K4, but K4's map is the
// better one there: its thread loads the pose once for all K and keeps
// busy, where here the rows of masked k wait at the barrier.
//
// Phases, per block:
//   1. Read: each matched (k, p) whose slot lies in [0, L) reads its
//      slot's 5 values once and runs planes.cuh:fs1_match (K4's and K5's
//      operation order), keeping the update and its log-likelihood term
//      in shared memory [K][PB]. Column 0 records each k's role: matched,
//      and the first matched k that aims at its slot.
//   2. __syncthreads(): every read has seen the old values.
//   3. Write: the first matched k of a slot writes its update there (the
//      twin's rule, models/rbpf.py:_write_sources: the first valid entry
//      wins, and every update comes from the old values); each ok_new k
//      writes planes.cuh:feature_init_planes at slot_new[k]; one thread
//      per particle sums the matched terms in k order from 0.0f, as
//      K4 (fused_update.cu) does, and writes logw[p] + d.
//
// Race freedom, with no atomics and no reduction across blocks: a
// particle column belongs to one block; matched slots are < n and new
// slots >= n; the new slots are consecutive, so distinct; phase 3 has
// one writer per (slot, p) cell, and the barrier puts every read before
// every write. So on inputs whose matched slots are distinct K2 is
// bit-equal to K4 (the same planes.cuh functions, the same sum order);
// on a duplicated slot it equals the twin, as K4 does not.
#include <cuda_runtime.h>

#include "planes.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kSmallPB = 8;
constexpr int kWidePB = 16;
constexpr int kWideP = 2 * kWidePB * 132;  // two wide blocks per SM
constexpr int kMinWideThreads = 128;
constexpr size_t kMaxSmem = 232448;    // a block's shared memory on H100
constexpr size_t kDefaultSmem = 48 * 1024;

enum : unsigned char { kMatched = 1, kFirst = 2 };

// Dynamic shared memory of a block: the log-likelihood term and the five
// updated values of every (k, p), then each k's role.
size_t smem_bytes(int K, int pb) {
  return (size_t)6 * K * pb * sizeof(float) + K;
}

int particles_per_block(int K, int P) {
  int pb = kSmallPB;
  if (P >= kWideP) {
    pb = kWidePB;
    while (pb * K < kMinWideThreads) pb *= 2;
  }
  while (pb > 1 && smem_bytes(K, pb) > kMaxSmem) pb /= 2;
  return pb;
}

__global__ void __launch_bounds__(kMaxThreads) fs1_observe_kernel(
    const float* __restrict__ xv, float* __restrict__ logw,
    float* __restrict__ lm, float* __restrict__ lmP,
    const float* __restrict__ z, const int* __restrict__ slot,
    const unsigned char* __restrict__ matched,
    const int* __restrict__ slot_new,
    const unsigned char* __restrict__ ok_new, float r00, float r01,
    float r11, int K, int L, int P) {
  extern __shared__ float smem[];
  const int pb = blockDim.x, kt = blockDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int kp = K * pb;
  float* term = smem;                                      // [K][pb]
  float* upd = smem + kp;                                  // [5][K][pb]
  unsigned char* role = (unsigned char*)(smem + 6 * kp);   // [K]
  const int p = blockIdx.x * pb + tx;
  const bool live = p < P;
  const long plane = (long)L * P;  // stride between component planes

  float x = 0.0f, y = 0.0f, t = 0.0f;
  if (live) {
    x = xv[p];
    y = xv[P + p];
    t = xv[2 * P + p];
  }
  // 1. Read; column 0 records each k's role.
  for (int k = ty; k < K; k += kt) {
    const int s = slot[k];
    const bool use = matched[k] && s >= 0 && s < L;
    if (use && live) {
      const long i = (long)s * P + p;
      float d = 0.0f;
      const slam::Feature f = slam::fs1_match(
          x, y, t, slam::Feature{lm[i], lm[plane + i], lmP[i],
                                 lmP[plane + i], lmP[2 * plane + i]},
          z[2 * k], z[2 * k + 1], r00, r01, r11, d);
      const int c = k * pb + tx;
      term[c] = d;
      upd[c] = f.x;
      upd[kp + c] = f.y;
      upd[2 * kp + c] = f.p00;
      upd[3 * kp + c] = f.p01;
      upd[4 * kp + c] = f.p11;
    }
    if (tx == 0) {
      unsigned char r = 0;
      if (use) {
        r = kMatched | kFirst;
        for (int j = 0; j < k; ++j) {
          if (matched[j] && slot[j] == s) {
            r = kMatched;
            break;
          }
        }
      }
      role[k] = r;
    }
  }
  // 2. Every read before any write.
  __syncthreads();
  if (!live) return;

  // 3. Write.
  for (int k = ty; k < K; k += kt) {
    if (role[k] & kFirst) {
      const long i = (long)slot[k] * P + p;
      const int c = k * pb + tx;
      lm[i] = upd[c];
      lm[plane + i] = upd[kp + c];
      lmP[i] = upd[2 * kp + c];
      lmP[plane + i] = upd[3 * kp + c];
      lmP[2 * plane + i] = upd[4 * kp + c];
    }
    const int sn = slot_new[k];
    if (ok_new[k] && sn >= 0 && sn < L) {
      const long i = (long)sn * P + p;
      const slam::Feature f = slam::feature_init_planes(
          x, y, t, z[2 * k], z[2 * k + 1], r00, r01, r11);
      lm[i] = f.x;
      lm[plane + i] = f.y;
      lmP[i] = f.p00;
      lmP[plane + i] = f.p01;
      lmP[2 * plane + i] = f.p11;
    }
  }
  if (ty == 0) {
    float d = 0.0f;
    for (int k = 0; k < K; ++k) {
      if (role[k] & kMatched) d += term[k * pb + tx];
    }
    logw[p] = logw[p] + d;
  }
}

}  // namespace

// Returns cudaErrorInvalidValue for a K whose shared memory no block
// holds (above some 9,400 observations).
extern "C" int slam_fs1_observe(
    const float* xv, float* logw, float* lm, float* lmP, const float* z,
    const int* slot, const unsigned char* matched, const int* slot_new,
    const unsigned char* ok_new, float r00, float r01, float r11, int K,
    int L, int P, cudaStream_t stream) {
  if (P <= 0 || K <= 0) return 0;
  const int pb = particles_per_block(K, P);
  const size_t smem = smem_bytes(K, pb);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        fs1_observe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int kt = K < kMaxThreads / pb ? K : kMaxThreads / pb;
  const int blocks = (P + pb - 1) / pb;
  fs1_observe_kernel<<<blocks, dim3(pb, kt), smem, stream>>>(
      xv, logw, lm, lmP, z, slot, matched, slot_new, ok_new, r00, r01, r11,
      K, L, P);
  return (int)cudaGetLastError();
}
