// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as
// 1, 2, 3", SC 2011), written out as device functions.
//
// A counter-based generator: the four output words are a pure function
// of a 128-bit counter and a 64-bit key, so every (particle, tick) of a
// kernel draws its own words with no state carried between threads or
// launches. It takes the place of the TPU's hardware PRNG
// (pltpu.prng_random_bits) in the kernels that sample inside the
// kernel, K6 and K6b of predict.cu; the bits differ from the TPU's, the
// distribution does not.
//
// The plain twin is slam_tpu_torch/ops/kernels/predict.py:philox4x32,
// which gives the same words for the same (counter, key).
//
// The generator is all integer work: per block of four words, ten
// rounds of two 32 x 32 -> 64-bit products, and nothing from memory.
// In the predict kernels it is the largest single share of the
// instructions a thread issues, and instruction issue is what bounds
// those kernels. What is done about that here, with the stream
// unchanged:
//
// - each product is written as one 64-bit multiply, which compiles to a
//   single wide multiply-add instruction (IMAD.WIDE.U32) and not to a
//   low multiply and a separate multiply-high;
// - the ten round keys depend on the key only, so they are computed
//   once per thread (philox_key_schedule) and held in registers, not
//   once per block of words;
// - the predict kernels' counters are (p, t, 0, 0) and they use words 0
//   and 1 only, so philox4x32_10_w01 starts from the known zeros: the
//   first round's second product and the last round's first product
//   are never formed.
#pragma once

#include <stdint.h>

namespace slam {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;  // golden ratio
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;  // sqrt(3) - 1
constexpr int kPhiloxRounds = 10;

// The round keys: the key is bumped by the Weyl constants before every
// round but the first.
struct PhiloxKeys {
  uint32_t k0[kPhiloxRounds];
  uint32_t k1[kPhiloxRounds];
};

__device__ __forceinline__ PhiloxKeys philox_key_schedule(uint32_t k0,
                                                          uint32_t k1) {
  PhiloxKeys ks;
#pragma unroll
  for (int r = 0; r < kPhiloxRounds; ++r) {
    ks.k0[r] = k0;
    ks.k1[r] = k1;
    // Opaque to the compiler from here on: left alone it adds the Weyl
    // constants to the key again before every round of every block
    // (the additions are cheap, but each takes an issue slot); pinned,
    // the twenty round keys are registers that the rounds read.
    asm volatile("" : "+r"(ks.k0[r]), "+r"(ks.k1[r]));
    k0 += kPhiloxW0;
    k1 += kPhiloxW1;
  }
  return ks;
}

// (hi, lo) words of m * c.
__device__ __forceinline__ void philox_mulhilo(uint32_t m, uint32_t c,
                                               uint32_t& hi, uint32_t& lo) {
  const uint64_t prod = (uint64_t)m * (uint64_t)c;
  hi = (uint32_t)(prod >> 32);
  lo = (uint32_t)prod;
}

// Words 0 and 1 of the ten-round block at counter (c0, c1, 0, 0).
__device__ __forceinline__ void philox4x32_10_w01(uint32_t c0, uint32_t c1,
                                                  const PhiloxKeys& ks,
                                                  uint32_t& w0,
                                                  uint32_t& w1) {
  // Round 0 with c2 = c3 = 0: the product M1 * c2 is zero.
  uint32_t hi0, lo0, hi1, lo1;
  philox_mulhilo(kPhiloxM0, c0, hi0, lo0);
  c0 = c1 ^ ks.k0[0];
  c1 = 0u;
  uint32_t c2 = hi0 ^ ks.k1[0];
  uint32_t c3 = lo0;
#pragma unroll
  for (int r = 1; r < kPhiloxRounds; ++r) {
    philox_mulhilo(kPhiloxM0, c0, hi0, lo0);
    philox_mulhilo(kPhiloxM1, c2, hi1, lo1);
    c0 = hi1 ^ c1 ^ ks.k0[r];
    c1 = lo1;
    c2 = hi0 ^ c3 ^ ks.k1[r];
    c3 = lo0;
  }
  // Words 2 and 3 (c2, c3) are not used: the compiler drops the last
  // round's M0 product with them.
  w0 = c0;
  w1 = c1;
}

}  // namespace slam
