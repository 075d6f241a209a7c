// Decoding stratified offspring bounds on the card, for the kernels that
// gather by them (G2 in gather.cu, K5 in resample_update.cu).
//
// Ancestor g owns output columns [S[g-1], S[g]); S is non-decreasing
// with S[P-1] == P, so the ancestor of column j is the first g with
// S[g] > j, and the ancestors of a run of columns form one run.
#pragma once

namespace slam {

// First g with S[g] > j (S non-decreasing, S[P - 1] == P > j), by the
// 32 lanes of one warp together: a 32-way search, 4 rounds at P = 2^20.
__device__ __forceinline__ int first_above(const int* __restrict__ S, int P,
                                           int j, int lane) {
  int lo = 0, hi = P - 1;  // the answer lies in [lo, hi]; S[hi] > j
  while (hi - lo >= 32) {
    const long span = hi - lo;
    const int probe = lo + (int)(span * (lane + 1) / 32);  // lane 31: hi
    const unsigned above = __ballot_sync(0xffffffffu, S[probe] > j);
    const int f = __ffs(above) - 1;
    const int prev = __shfl_sync(0xffffffffu, probe, f > 0 ? f - 1 : 0);
    hi = __shfl_sync(0xffffffffu, probe, f);
    if (f > 0) lo = prev + 1;
  }
  const int g = lo + lane;
  const unsigned above =
      __ballot_sync(0xffffffffu, g <= hi && S[min(g, hi)] > j);
  return lo + __ffs(above) - 1;
}

// The ancestors of output columns [j0, j0 + jn) into anc[0, jn), by a
// block of nthreads threads: warps 0 and 1 find the ends of the run
// (ends[0], ends[1] in shared memory), then the block walks S between
// them. Ends with a barrier.
__device__ __forceinline__ void decode_bounds(const int* __restrict__ S,
                                              int P, int j0, int jn,
                                              int* anc, int* ends,
                                              int nthreads) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (warp < 2) {
    const int g = first_above(S, P, warp == 0 ? j0 : j0 + jn - 1, lane);
    if (lane == 0) ends[warp] = g;
  }
  __syncthreads();
  for (int g = ends[0] + tid; g <= ends[1]; g += nthreads) {
    const int lo = max(g > 0 ? S[g - 1] : 0, j0);
    const int hi = min(S[g], j0 + jn);
    for (int j = lo; j < hi; ++j) anc[j - j0] = g;
  }
  __syncthreads();
}

}  // namespace slam
