// K5, the fused resample + FastSLAM 1 update of the deferred-resample
// path, in one pass over the landmark state.
//
// Replaces slam_tpu/ops/pallas/kernels.py:_deferred_kernel (entry point
// fs1_resample_update_tpu; update math _fused_update_math). The landmark
// planes lm [2, L, P] and lmP [3, L, P] still hold the particles as they
// were before the previous superstep's resample, whose ancestors are
// pending as offspring bounds S (ancestor g owns output columns
// [S[g-1], S[g]), S[P-1] == P). Semantics: K4 (fused_update.cu) applied
// after gathering the columns by S, into fresh output planes (column j
// may be the ancestor of column j + 1, so it cannot run in place), with
// the empty rows stored as zero.
//
// Live and empty rows. The live count n (a device scalar, read by
// pointer) and the observations split the L slots: rows [0, n_end) are
// live and rows [n_end, L) empty, where n_end is n plus the new features
// of the launch (they take consecutive slots from n), or one past the
// last slot an observation writes where that lies further, at most L.
// Empty rows are stored as +0.0 and never read. The filter's empty rows
// are zero in every state it makes (init_particles makes them zero, K4
// writes only rows below n + new, K5 stores zeros), so the planes equal
// G2's gather followed by K4 bit for bit. The twin
// (kernels.py:resample_update_plain) zeroes the same rows after G2's
// twin and K4's twin, so kernel and twin agree on any input, rows past n
// that are not zero included.
//
// Bound: memory. The least traffic writes every output row once and
// reads each distinct ancestor's live rows once, less the rows of the
// slots that get a new feature: at most 20 (L + n_end) bytes per
// particle. At L = 10,000, P = 32,768 and n_end = 1,469 that is 6.55 GB
// written (5.59 GB of it zeros) and at most 0.96 GB read, 2.24 ms at
// 3.35 TB/s; at L = 192, P = 2^20 and 127 live rows, 4.03 GB written and
// at most 2.66 GB read, 2.00 ms.
//
// Design. slot, matched, slot_new and ok_new are the same for every
// particle, so each block first builds, in shared memory, the role of
// every slot: touched by the k that name it, or not, and for each
// matched k whether it is the first to touch its slot. The grid is
// column tile x slot chunk; every output row is written exactly once
// and every live input row read at most once:
//
//   - block (t, c) owns tile t, kTile consecutive output columns. The
//     stratified ancestors are non-decreasing, so the tile's ancestors
//     form one run [g_first, g_last]: two warp-wide searches of S find
//     its ends and the block walks S between them to decode the
//     ancestor of every column into shared memory;
//   - chunk 0 takes the observations in k order (matched and new); each
//     chunk c copies the untouched live slots of its range of [0,
//     n_end), the ranges cut so that chunk 0's observations count as
//     slots of its share. The work is a list of items, each the 5 rows
//     (x, y, p00, p01, p11) of one slot: chunk 0's matched slots in k
//     order, then the untouched slots of the range in slot order. When
//     the tile's ancestor run fits kStageWidth columns, one thread
//     streams each item's 5 row segments [g_first, g_last] into a ring
//     of kStages shared-memory stages with TMA bulk copies
//     (cp.async.bulk, one mbarrier per stage), so the loads of later
//     items overlap the work and stores of earlier ones, and every
//     thread selects its columns' ancestors from shared memory. A wider
//     run (a stretch where most particles died) reads the ancestors'
//     columns from device memory directly;
//   - the k steps run in k order per column with planes.cuh:fs1_match,
//     the operation order of K4, built with --fmad=false: the planes
//     and the k-ordered log-likelihood sum are bit-equal to G2's gather
//     followed by K4. A slot touched by two k in one launch (two
//     observations of one landmark) reads the later k's input back from
//     the thread's own output, as K4 does in place;
//   - each thread owns 4 adjacent output columns and writes each row as
//     one 16-byte store;
//   - the empty rows of each of the 5 component planes are one span of
//     (L - n_end) P floats. Every block stores its share of each span as
//     16-byte zeros, strided over the whole grid: no ancestor, no tile
//     and no shared memory.
//
// The host picks the number of chunks from P, L and the card's SM count
// (kernels.py:resample_update_chunks). One thread a launch adds
// (L - n_end, L) to rows [2], the count of empty rows stored.
//
// The TPU kernel's DMA windows, int8 one-hot selection and per-block
// window metadata (lo, nch, ident) exist to gather columns on a machine
// with no per-lane loads; here a lane loads any shared-memory word.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bounds.cuh"
#include "planes.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;                  // adjacent output columns/thread
constexpr int kTile = kThreads * kCols;   // output columns per block
constexpr int kRows = 5;                  // the rows of one slot
constexpr int kStageWidth = 768;          // floats per staged row segment
constexpr int kStages = 3;
constexpr int kMaxSmem = 232448;          // a block's limit on sm_90
constexpr int kMisc = kWarps + 5;         // see the kernel's misc

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Copies bytes (a multiple of 16, both addresses 16-byte aligned) from
// device memory to shared memory; completion is counted on bar.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// In-order compaction of value(i) >= 0 over i in [0, n) into
// out[count...]; returns the new count. Every thread of the block calls
// it; sums holds kWarps ints.
template <class Value>
__device__ int compact(int n, Value value, int* out, int count, int* sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int base = 0; base < n; base += kThreads) {
    const int i = base + threadIdx.x;
    const int v = i < n ? value(i) : -1;
    const unsigned keep = __ballot_sync(0xffffffffu, v >= 0);
    if (lane == 0) sums[warp] = __popc(keep);
    __syncthreads();
    int off = count, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      off += w < warp ? sums[w] : 0;
      total += sums[w];
    }
    if (v >= 0) out[off + __popc(keep & ((1u << lane) - 1u))] = v;
    __syncthreads();
    count += total;
  }
  return count;
}

// Component c of slot s, as a row of P floats of lm (c < 2) or lmP.
template <class T>
__device__ __forceinline__ T* row_of(T* lm, T* lmP, int c, int s, int L,
                                     int P) {
  return c < 2 ? lm + ((long)c * L + s) * P
               : lmP + ((long)(c - 2) * L + s) * P;
}

// Writes v[0..n) to p[0..n); one 16-byte store when vec and n == 4.
__device__ __forceinline__ void store_cols(float* p, const float (&v)[kCols],
                                           int n, bool vec) {
  if (vec && n == kCols) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (c < n) p[c] = v[c];
  }
}

__device__ __forceinline__ void load_cols(const float* p, float (&v)[kCols],
                                          int n, bool vec) {
  if (vec && n == kCols) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c) v[c] = c < n ? p[c] : 0.0f;
  }
}

__device__ __forceinline__ bool touched_at(const unsigned* touched, int s) {
  return (touched[s >> 5] >> (s & 31)) & 1u;
}

// The first slot in [s, hi) that no observation touches, else hi.
__device__ __forceinline__ int next_untouched(const unsigned* touched, int s,
                                              int hi) {
  while (s < hi && touched_at(touched, s)) ++s;
  return s;
}

__global__ void __launch_bounds__(kThreads, 4) fs1_resample_update_kernel(
    const float* __restrict__ xv, float* __restrict__ logw,
    const float* __restrict__ lm, const float* __restrict__ lmP,
    float* __restrict__ lm_out, float* __restrict__ lmP_out,
    const int* __restrict__ S, const float* __restrict__ z,
    const int* __restrict__ slot, const unsigned char* __restrict__ matched,
    const int* __restrict__ slot_new,
    const unsigned char* __restrict__ ok_new, const int* __restrict__ n_live,
    unsigned long long* __restrict__ rows, float r00, float r01, float r11,
    int K, int L, int P, int vec_ok, int stage_ok) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);  // [kStages][kRows][W]
  uint64_t* bar =
      reinterpret_cast<uint64_t*>(stage + kStages * kRows * kStageWidth);
  int* anc = reinterpret_cast<int*>(bar + kStages);  // [kTile]
  int* misc = anc + kTile;                           // [kMisc]
  int* ev_m = misc + kMisc;  // [K] slot of matched k, or -1
  int* ev_n = ev_m + K;      // [K] slot of new k, or -1
  int* fresh = ev_n + K;     // [K] matched k touches its slot first
  int* items = fresh + K;    // [K] chunk 0's matched slots in k order
  float* zs = reinterpret_cast<float*>(items + K);  // [2 K]
  unsigned* touched = reinterpret_cast<unsigned*>(zs + 2 * K);
  // misc: [kWarps] compact's sums, [2] the run's ends, then the new
  // features, one past the last slot written and the touched slots.
  int* n_new = misc + kWarps + 2;
  int* past = n_new + 1;
  int* n_touch = past + 1;

  const int tid = threadIdx.x;
  const int chunk = blockIdx.y, chunks = gridDim.y;
  const bool obs = chunk == 0;  // this block takes the observations
  const int j0 = blockIdx.x * kTile;
  const int jn = min(kTile, P - j0);  // columns of this tile

  // 1. The per-launch tables, and the tile's ancestor run.
  for (int k = tid; k < K; k += kThreads) {
    const int s = slot[k], sn = slot_new[k];
    ev_m[k] = (matched[k] && s >= 0 && s < L) ? s : -1;
    ev_n[k] = (ok_new[k] && sn >= 0 && sn < L) ? sn : -1;
    zs[2 * k] = z[2 * k];
    zs[2 * k + 1] = z[2 * k + 1];
  }
  for (int w = tid; w < (L + 31) / 32; w += kThreads) touched[w] = 0u;
  if (tid == 0) *n_new = *past = *n_touch = 0;
  // The ancestors of the tile's columns, and the ends of their run.
  slam::decode_bounds(S, P, j0, jn, anc, misc + kWarps, kThreads);
  const int g_first = misc[kWarps], g_last = misc[kWarps + 1];
  for (int k = tid; k < K; k += kThreads) {
    const int s = ev_m[k], sn = ev_n[k];
    bool first = s >= 0;
    for (int q = 0; first && q < k; ++q) first = ev_m[q] != s && ev_n[q] != s;
    fresh[k] = first;
    if (s >= 0) {
      atomicOr(&touched[s >> 5], 1u << (s & 31));
      atomicMax(past, s + 1);
    }
    if (sn >= 0) {
      atomicOr(&touched[sn >> 5], 1u << (sn & 31));
      atomicMax(past, sn + 1);
      atomicAdd(n_new, 1);
    }
    if (first || sn >= 0) atomicAdd(n_touch, 1);
  }
  __syncthreads();
  const int n_end = min(L, max(min(max(*n_live, 0), L) + *n_new, *past));
  // The chunk's range [lo, hi) of the live slots: chunk 0's share less
  // its observations, so that each chunk has ~(n_end + T) / chunks items.
  const long share = (long)n_end + *n_touch;
  auto edge = [&](int c) {
    return (int)max(0L, min((long)n_end,
                            (c * share + chunks - 1) / chunks - *n_touch));
  };
  const int lo = edge(chunk), hi = edge(chunk + 1);
  const int n_obs = obs ? compact(
      K, [&](int k) { return fresh[k] ? ev_m[k] : -1; }, items, 0, misc) : 0;

  // 2. This thread's columns, their ancestors, poses and weights.
  const int base = g_first & ~3;
  const int width = ((g_last | 3) + 1) - base;  // a multiple of 4
  const bool vec = vec_ok != 0;
  const bool staged = stage_ok && vec && width <= kStageWidth;
  const int jt = j0 + tid * kCols;  // this thread's first column
  const int n = max(0, min(kCols, jn - tid * kCols));
  int off[kCols];  // ancestor - base when staged, else the ancestor
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int g = c < n ? anc[tid * kCols + c] : g_first;
    off[c] = staged ? g - base : g;
  }
  float px[kCols] = {}, py[kCols] = {}, pt[kCols] = {}, lw[kCols] = {};
  if (obs && n > 0) {
    load_cols(xv + jt, px, n, vec);
    load_cols(xv + P + jt, py, n, vec);
    load_cols(xv + 2 * (long)P + jt, pt, n, vec);
    load_cols(logw + jt, lw, n, vec);
  }

  // 3. The item ring: item i goes to stage i % kStages. Thread 0 walks
  // the untouched slots of the range kStages items ahead of the block.
  const uint32_t seg_bytes = (uint32_t)width * 4u;
  int ahead = next_untouched(touched, lo, hi);  // thread 0's next copy
  // Starts the loads of item i, if the block has one; thread 0 only.
  auto prefetch = [&](int i) {
    int s;
    if (i < n_obs) {
      s = items[i];
    } else {
      if (ahead >= hi) return;
      s = ahead;
      ahead = next_untouched(touched, s + 1, hi);
    }
    const int st = i % kStages;
    mbar_expect(&bar[st], kRows * seg_bytes);
    for (int c = 0; c < kRows; ++c)
      bulk_copy(stage + (st * kRows + c) * kStageWidth,
                row_of(lm, lmP, c, s, L, P) + base, seg_bytes, &bar[st]);
  };
  if (staged) {
    if (tid == 0) {
      for (int st = 0; st < kStages; ++st) mbar_init(&bar[st]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int i = 0; i < kStages; ++i) prefetch(i);
    }
    __syncthreads();
  }
  // The 5 rows of item i (slot s) at this thread's columns' ancestors.
  auto fetch = [&](int i, int s, float (&v)[kRows][kCols]) {
    if (staged) {
      const int st = i % kStages;
      mbar_wait(&bar[st], (uint32_t)(i / kStages) & 1u);
      const float* src = stage + st * kRows * kStageWidth;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) v[r][c] = src[r * kStageWidth + off[c]];
    } else {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float* row = row_of(lm, lmP, r, s, L, P);
#pragma unroll
        for (int c = 0; c < kCols; ++c) v[r][c] = __ldg(row + off[c]);
      }
    }
  };
  // Item i is consumed: once every thread has read its stage, refill it.
  auto release = [&](int i) {
    if (!staged) return;
    __syncthreads();
    if (tid == 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      prefetch(i + kStages);
    }
  };
  auto store = [&](int s, const float (&v)[kRows][kCols]) {
    if (n == 0) return;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      store_cols(row_of(lm_out, lmP_out, r, s, L, P) + jt, v[r], n, vec);
  };

  // 4. The observations in k order (chunk 0), then the range's
  // untouched slots.
  float d[kCols] = {0.0f, 0.0f, 0.0f, 0.0f};
  int item = 0;
  for (int k = 0; obs && k < K; ++k) {
    const float z0 = zs[2 * k], z1 = zs[2 * k + 1];
    const int s = ev_m[k];
    if (s >= 0) {
      float v[kRows][kCols];
      if (fresh[k]) {
        fetch(item, s, v);
      } else {  // an earlier k of this launch wrote the slot
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float* row = row_of(lm_out, lmP_out, r, s, L, P) + jt;
#pragma unroll
          for (int c = 0; c < kCols; ++c) v[r][c] = c < n ? row[c] : 0.0f;
        }
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const slam::Feature f = slam::fs1_match(
            px[c], py[c], pt[c],
            slam::Feature{v[0][c], v[1][c], v[2][c], v[3][c], v[4][c]}, z0,
            z1, r00, r01, r11, d[c]);
        v[0][c] = f.x;
        v[1][c] = f.y;
        v[2][c] = f.p00;
        v[3][c] = f.p01;
        v[4][c] = f.p11;
      }
      store(s, v);
      if (fresh[k]) release(item++);
    }
    const int sn = ev_n[k];
    if (sn >= 0) {
      float v[kRows][kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const slam::Feature f = slam::feature_init_planes(
            px[c], py[c], pt[c], z0, z1, r00, r01, r11);
        v[0][c] = f.x;
        v[1][c] = f.y;
        v[2][c] = f.p00;
        v[3][c] = f.p01;
        v[4][c] = f.p11;
      }
      store(sn, v);
    }
  }
  if (obs && n > 0) {
    float out[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) out[c] = lw[c] + d[c];
    store_cols(logw + jt, out, n, vec);
  }
  for (int s = next_untouched(touched, lo, hi); s < hi;
       s = next_untouched(touched, s + 1, hi), ++item) {
    float v[kRows][kCols];
    fetch(item, s, v);
    store(s, v);
    release(item);
  }

  // 5. The empty rows, [n_end, L) of each plane, as zeros over the grid.
  const long span = (long)(L - n_end) * P;
  const long stride = (long)gridDim.x * gridDim.y * kThreads;
  const long g0 = ((long)blockIdx.y * gridDim.x + blockIdx.x) * kThreads + tid;
  for (int r = 0; r < kRows; ++r) {
    float* row = row_of(lm_out, lmP_out, r, n_end, L, P);
    if (vec) {
      float4* row4 = reinterpret_cast<float4*>(row);
      for (long i = g0; i < span / 4; i += stride)
        row4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    } else {
      for (long i = g0; i < span; i += stride) row[i] = 0.0f;
    }
  }
  if (rows != nullptr && g0 == 0) {
    atomicAdd(rows, (unsigned long long)(L - n_end));
    atomicAdd(rows + 1, (unsigned long long)L);
  }
}

size_t smem_bytes(int K, int L) {
  // stage, bar, then anc, misc, ev_m, ev_n, fresh, items, zs, touched.
  const size_t words = (size_t)kTile + kMisc + 4 * (size_t)K +
                       2 * (size_t)K + (L + 31) / 32;
  return sizeof(float) * kStages * kRows * kStageWidth +
         sizeof(uint64_t) * kStages + 4 * words;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// n_live: the live count, an int on the device. rows: two uint64 on the
// device, or null, to which the launch adds (L - n_end, L). chunks: the
// slot chunks of each column tile (kernels.py:resample_update_chunks).
// staged: 1 streams the ancestor rows through shared memory when a
// tile's ancestor run fits (the path's setting); 0 always reads the
// ancestors' columns directly (a measurement of the other branch).
extern "C" int slam_fs1_resample_update(
    const float* xv, float* logw, const float* lm, const float* lmP,
    float* lm_out, float* lmP_out, const int* S, const float* z,
    const int* slot, const unsigned char* matched, const int* slot_new,
    const unsigned char* ok_new, const int* n_live,
    unsigned long long* rows, float r00, float r01, float r11, int K,
    int L, int P, int chunks, int staged, cudaStream_t stream) {
  if (P <= 0) return 0;
  if (chunks < 1 || chunks > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(K, L);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fs1_resample_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec_ok = P % kCols == 0 && aligned16(xv) && aligned16(logw) &&
                     aligned16(lm) && aligned16(lmP) && aligned16(lm_out) &&
                     aligned16(lmP_out);
  const dim3 grid((P + kTile - 1) / kTile, chunks);
  fs1_resample_update_kernel<<<grid, kThreads, smem, stream>>>(
      xv, logw, lm, lmP, lm_out, lmP_out, S, z, slot, matched, slot_new,
      ok_new, n_live, rows, r00, r01, r11, K, L, P, vec_ok, staged);
  return (int)cudaGetLastError();
}
