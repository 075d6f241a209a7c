// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as
// 1, 2, 3", SC 2011), written out as a device function.
//
// A counter-based generator: the four output words are a pure function
// of a 128-bit counter and a 64-bit key, so every (particle, tick) of a
// kernel draws its own words with no state carried between threads or
// launches. It takes the place of the TPU's hardware PRNG
// (pltpu.prng_random_bits) in the kernels that sample inside the
// kernel; the bits differ from the TPU's, the distribution does not.
//
// The plain twin is slam_tpu_torch/ops/kernels/predict.py:philox4x32,
// which gives the same words for the same (counter, key).
#pragma once

#include <stdint.h>

namespace slam {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;  // golden ratio
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;  // sqrt(3) - 1

struct Philox4 {
  uint32_t w[4];
};

// Ten rounds; the key is bumped by the Weyl constants before every
// round but the first.
__device__ __forceinline__ Philox4 philox4x32_10(uint32_t c0, uint32_t c1,
                                                 uint32_t c2, uint32_t c3,
                                                 uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    const uint32_t lo0 = kPhiloxM0 * c0;
    const uint32_t hi0 = __umulhi(kPhiloxM0, c0);
    const uint32_t lo1 = kPhiloxM1 * c2;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c2);
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  Philox4 out;
  out.w[0] = c0;
  out.w[1] = c1;
  out.w[2] = c2;
  out.w[3] = c3;
  return out;
}

}  // namespace slam
