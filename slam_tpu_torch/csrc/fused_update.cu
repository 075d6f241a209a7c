// K4, the fused in-place FastSLAM 1 update on the landmark state.
//
// Replaces slam_tpu/ops/pallas/kernels.py:_fused_update_kernel and
// _fused_update_math (entry point fs1_update_tpu). Per particle p: for
// each matched observation k, read the landmark at slot[k] straight
// from lm [2, L, P] and lm_P [3, L, P], compute the Jacobians and the
// log-likelihood, and write the 2x2 EKF update back to the same slot;
// for each ok_new k, write the new feature at slot_new[k]; finally
// logw[p] += d, where d is the sum of the matched k's log-likelihood
// terms (planes.cuh:fs1_match) added in k order starting from 0.0f.
// Slots outside [0, L) are dropped, as the JAX package's mode="drop"
// writes are. Untouched slots keep their values, as under the TPU
// kernel's input/output aliasing.
//
// Bound: memory, and only the touched slots move: per particle, the
// pose, the weight and 5 floats per matched k read, the weight and 5
// floats per matched or new k written. The TPU
// kernel streams all L slots of a particle block through VMEM and
// gathers and scatters them with one-hot matmuls; here a thread loads
// the slots it touches directly. Where K is large next to P (config
// #5's full-10k point: K = 96, 70 matched and 20 new, P = 32,768) the
// instructions of fs1_match come close to the bytes as well.
//
// Design. One thread per particle walking the K observations in order
// has one DRAM round trip in flight at a time (each matched k stores to
// the arrays the next k reads), which leaves the card idle wherever P
// is small next to it. So:
//
//   1. Events. Each block builds, in shared memory, the list of the
//      launch's events in k order: for each k, a matched event (matched
//      and slot[k] in [0, L)), then a new event (ok_new and slot_new[k]
//      in [0, L)), each with its slot, and z. The list is the same for
//      every particle, so no warp diverges on the masks, and no thread
//      reads the metadata from device memory again.
//   2. Threads per particle. A block is 128 threads: 128 / T particles,
//      p fastest, times T threads per particle, with T = 4 below 2^16
//      particles and T = 1 from there (threads_per_particle), so that
//      small P still fills the card (P = 32,768 gives 2^17 threads,
//      about 1,000 per SM) and large P pays no barrier. A warp holds 32
//      consecutive particles of one thread row, so each (slot, plane)
//      access of a warp is one 128-byte line.
//   3. Rounds of chunks. The events are taken in rounds of T x kChunk:
//      thread row t takes the round's events t, t + T, ..., up to
//      kChunk of them, issues the 5 loads of each of its matched events
//      first (5 kChunk independent loads in flight), then computes and
//      stores each event in turn. kChunk is 2: a deeper chunk holds more
//      loads in flight per thread but takes more registers, so fewer
//      warps fit an SM, and the dependent chains of fs1_match (IEEE
//      divides, sqrtf, logf, fmodf) need those warps as much as the loads
//      do: at these shapes the instructions come within reach of the
//      bytes (chip_smoke.py prints K4's registers and times, and reads
//      T and kChunk from slam_fs1_fused_update_map).
//   4. The sum. With T = 1 the thread adds each matched term to d in
//      event order. With T > 1 each thread writes its matched terms to
//      shared memory (two buffers, one per round in turn); after the
//      round's barrier, row 0 adds the round's terms to d in event
//      order. Either way d is summed in k order from 0.0f and each term
//      is fs1_match's, so K4 is bit-equal to the one-thread walk, to K2
//      (csrc/observe.cu) on distinct slots, and K5
//      (csrc/resample_update.cu) stays bit-equal to G2 + K4.
//
// Why the early loads are legal: under the contract (known
// association: a matched slot is used once per batch, matched slots are
// < n and new slots >= n and distinct) every (slot, p) cell is touched
// by at most one event, so no event reads a cell that another event of
// the launch writes, and the threads of one particle write disjoint
// cells. Only events of one round can meet out of order: a round's
// stores come before the next round's loads (in one thread's program
// order with T = 1, across the round's barrier with T > 1). So each
// block checks each event against the earlier events of its round (at
// most T x kChunk - 1 of them): if some slot is touched twice within a
// round (a landmark observed twice, a new slot that repeats or meets a
// matched one: outside the contract), every round holds one event,
// taken by row 0, so each event reads what the one before it wrote:
// the block walks the events in k order, and the result is bit for bit
// that of one thread per particle walking them (the first port's map;
// K5 reads a repeated slot back from its own output, so it equals
// G2 + K4 there too). A repeat in two different rounds keeps the rounds,
// which give that same in-order result. The one-event walk is slow (a
// barrier per event); the main paths never take it.
//
// Race freedom across blocks: a particle column belongs to one block.
#include <cuda_runtime.h>

#include "planes.cuh"

namespace {

constexpr int kThreads = 128;            // threads of a block
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 2;                // events a thread loads at once
constexpr size_t kMaxSmem = 232448;      // a block's shared memory on H100
constexpr size_t kDefaultSmem = 48 * 1024;

// Dynamic shared memory: z [2K], then the code (2k + is_new) and the
// slot of each of at most 2K events.
size_t smem_bytes(int K) { return (size_t)6 * K * sizeof(int); }

// T: 4 threads per particle below 2^16 particles, else 1.
int threads_per_particle(int P) { return P < (1 << 16) ? 4 : 1; }

template <int T>
__global__ void __launch_bounds__(kThreads) fs1_fused_update_kernel(
    const float* __restrict__ xv, float* __restrict__ logw,
    float* __restrict__ lm, float* __restrict__ lmP,
    const float* __restrict__ z, const int* __restrict__ slot,
    const unsigned char* __restrict__ matched,
    const int* __restrict__ slot_new,
    const unsigned char* __restrict__ ok_new, float r00, float r01,
    float r11, int K, int L, int P) {
  constexpr int PB = kThreads / T;  // particles of a block
  extern __shared__ int smem[];
  float* zs = reinterpret_cast<float*>(smem);  // [2K]
  int* ev_code = smem + 2 * K;                 // [2K] 2k + is_new
  int* ev_slot = ev_code + 2 * K;              // [2K]
  __shared__ int warp_sums[kWarps];
  __shared__ float term[2][T > 1 ? kChunk * kThreads : 1];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  // 1. The events, compacted in order of c = 2k + is_new.
  for (int k = tid; k < K; k += kThreads) {
    zs[2 * k] = z[2 * k];
    zs[2 * k + 1] = z[2 * k + 1];
  }
  int n_ev = 0;
  for (int base = 0; base < 2 * K; base += kThreads) {
    const int c = base + tid;
    int s = -1;
    bool keep = false;
    if (c < 2 * K) {
      const int k = c >> 1;
      if (c & 1) {
        s = slot_new[k];
        keep = ok_new[k] && s >= 0 && s < L;
      } else {
        s = slot[k];
        keep = matched[k] && s >= 0 && s < L;
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_sums[warp] = __popc(ballot);
    __syncthreads();
    int off = n_ev, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      off += w < warp ? warp_sums[w] : 0;
      total += warp_sums[w];
    }
    if (keep) {
      const int e = off + __popc(ballot & ((1u << lane) - 1u));
      ev_code[e] = c;
      ev_slot[e] = s;
    }
    __syncthreads();
    n_ev += total;
  }
  // A slot that two events of one round touch puts the block on the
  // in-order walk.
  int repeat = 0;
  for (int e = tid; e < n_ev; e += kThreads) {
    const int s = ev_slot[e];
    for (int q = e - e % (T * kChunk); q < e; ++q) repeat |= ev_slot[q] == s;
  }
  const int round = __syncthreads_or(repeat) ? 1 : T * kChunk;

  // 2. This thread's particle and row.
  const int tx = tid % PB, ty = tid / PB;
  const int p = blockIdx.x * PB + tx;
  const bool live = p < P;
  float x = 0.0f, y = 0.0f, t = 0.0f;
  if (live) {
    x = xv[p];
    y = xv[P + p];
    t = xv[2 * (long)P + p];
  }
  const long plane = (long)L * P;  // stride between component planes

  // 3. Rounds: loads of the thread's matched events first, then each
  // event's update and store.
  float d = 0.0f;
  int buf = 0;
  for (int base = 0; base < n_ev; base += round) {
    const int end = min(n_ev, base + round);
    float v[kChunk][5];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int e = base + ty + T * i;
      if (live && e < end && !(ev_code[e] & 1)) {
        const long at = (long)ev_slot[e] * P + p;
        v[i][0] = lm[at];
        v[i][1] = lm[plane + at];
        v[i][2] = lmP[at];
        v[i][3] = lmP[plane + at];
        v[i][4] = lmP[2 * plane + at];
      }
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int e = base + ty + T * i;
      if (!live || e >= end) continue;
      const int code = ev_code[e];
      const int k = code >> 1;
      const float z0 = zs[2 * k], z1 = zs[2 * k + 1];
      slam::Feature f;
      if (code & 1) {
        f = slam::feature_init_planes(x, y, t, z0, z1, r00, r01, r11);
      } else {
        float ll = 0.0f;
        f = slam::fs1_match(
            x, y, t,
            slam::Feature{v[i][0], v[i][1], v[i][2], v[i][3], v[i][4]},
            z0, z1, r00, r01, r11, ll);
        if constexpr (T == 1) {
          d += ll;
        } else {
          term[buf][(e - base) * PB + tx] = ll;
        }
      }
      const long at = (long)ev_slot[e] * P + p;
      lm[at] = f.x;
      lm[plane + at] = f.y;
      lmP[at] = f.p00;
      lmP[plane + at] = f.p01;
      lmP[2 * plane + at] = f.p11;
    }
    if constexpr (T > 1) {
      __syncthreads();
      if (ty == 0 && live) {
        for (int j = 0; j < end - base; ++j)
          if (!(ev_code[base + j] & 1)) d += term[buf][j * PB + tx];
      }
      buf ^= 1;
    }
  }
  if (ty == 0 && live) logw[p] = logw[p] + d;
}

template <int T>
int launch(const float* xv, float* logw, float* lm, float* lmP,
           const float* z, const int* slot, const unsigned char* matched,
           const int* slot_new, const unsigned char* ok_new, float r00,
           float r01, float r11, int K, int L, int P, cudaStream_t stream) {
  const size_t smem = smem_bytes(K);
  const size_t fixed =
      sizeof(int) * kWarps +
      sizeof(float) * 2 * (T > 1 ? kChunk * kThreads : 1);
  if (smem + fixed > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > kDefaultSmem - fixed) {
    const cudaError_t err = cudaFuncSetAttribute(
        fs1_fused_update_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  constexpr int PB = kThreads / T;
  const int blocks = (P + PB - 1) / PB;
  fs1_fused_update_kernel<T><<<blocks, kThreads, smem, stream>>>(
      xv, logw, lm, lmP, z, slot, matched, slot_new, ok_new, r00, r01, r11,
      K, L, P);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaErrorInvalidValue for a K whose event list no block holds
// (above some 9,600 observations).
extern "C" int slam_fs1_fused_update(
    const float* xv, float* logw, float* lm, float* lmP, const float* z,
    const int* slot, const unsigned char* matched, const int* slot_new,
    const unsigned char* ok_new, float r00, float r01, float r11, int K,
    int L, int P, cudaStream_t stream) {
  if (P <= 0) return 0;
  if (threads_per_particle(P) == 4)
    return launch<4>(xv, logw, lm, lmP, z, slot, matched, slot_new, ok_new,
                     r00, r01, r11, K, L, P, stream);
  return launch<1>(xv, logw, lm, lmP, z, slot, matched, slot_new, ok_new,
                   r00, r01, r11, K, L, P, stream);
}

// K4's map at P particles: the threads per particle and the events a
// thread loads before it stores. Returns 0.
extern "C" int slam_fs1_fused_update_map(int P, int* threads, int* chunk) {
  *threads = threads_per_particle(P);
  *chunk = kChunk;
  return 0;
}
