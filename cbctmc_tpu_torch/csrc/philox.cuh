// philox.cuh: the engine's random numbers, made in registers where they are
// used. Philox4x32-10 (Salmon et al., SC'11), written out by hand: ten
// rounds of two 32 x 32 -> 64 bit products (multipliers 0xD2511F53 and
// 0xCD9E8D57) with the key bumped by the Weyl constants 0x9E3779B9 and
// 0xBB67AE85 between rounds. Integer arithmetic only, so the plain version
// (cbctmc_tpu_torch/engine/rng.py philox4x32_10) reproduces every bit.
//
// Layout of the stream of one engine call (key = the call's two words):
// the random word of row `r` (transport.bits_row_map names the consumer of
// every row), lane `i` and outer iteration `t` is word r % 4 of
//   philox4x32_10(counter = (i, r / 4, t, 0), key).
// One call serves four consecutive rows of a lane; `Rng` keeps the last
// quadruple in registers, so a consumer that walks its rows in order (a
// photon pool, the shell trips) pays one call per four uniforms, and a lane
// computes only the rows it reads. The iteration number is a control word
// on the device, not a kernel argument: a launch recorded once in a CUDA
// graph draws fresh numbers at every replay.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define PHILOX_M0 0xD2511F53u
#define PHILOX_M1 0xCD9E8D57u
#define PHILOX_W0 0x9E3779B9u
#define PHILOX_W1 0xBB67AE85u

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(PHILOX_M0, c.x), lo0 = PHILOX_M0 * c.x;
    const uint32_t hi1 = __umulhi(PHILOX_M1, c.z), lo1 = PHILOX_M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += PHILOX_W0;
    k1 += PHILOX_W1;
  }
  return c;
}

// uniform in the open interval (0, 1) from a 32-bit word:
// (word >> 8) * 2^-24 + 2^-25 in float32 arithmetic, as the plain version's
// uniform_from_bits
__device__ __forceinline__ float uniform_from_word(uint32_t word) {
  return (float)(int)(word >> 8) * (1.0f / 16777216.0f) + (0.5f / 16777216.0f);
}

// one lane's generator for one outer iteration
struct Rng {
  uint32_t k0, k1, lane, iteration;
  uint32_t group;  // the row group (row / 4) whose words `w` holds
  uint4 w;
};

__device__ __forceinline__ Rng rng_for_lane(uint32_t k0, uint32_t k1, uint32_t iteration,
                                            uint32_t lane) {
  Rng g;
  g.k0 = k0;
  g.k1 = k1;
  g.lane = lane;
  g.iteration = iteration;
  g.group = 0xffffffffu;  // no row group has this number
  g.w = make_uint4(0u, 0u, 0u, 0u);
  return g;
}

__device__ __forceinline__ uint32_t rng_word(Rng& g, int row) {
  const uint32_t group = (uint32_t)row >> 2;
  if (group != g.group) {
    g.w = philox4x32_10(make_uint4(g.lane, group, g.iteration, 0u), g.k0, g.k1);
    g.group = group;
  }
  // selects, not an indexed read: the quadruple stays in registers
  return (row & 2) ? ((row & 1) ? g.w.w : g.w.z) : ((row & 1) ? g.w.y : g.w.x);
}

// the uniform of row `row` of this lane and iteration
__device__ __forceinline__ float u_open(Rng& g, int row) {
  return uniform_from_word(rng_word(g, row));
}
