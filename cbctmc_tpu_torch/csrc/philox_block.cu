// philox_block: the block of random words of one outer iteration,
// int64[n_rows, n_lanes] in [0, 2^32), written to device memory: row r, lane
// i holds word r % 4 of philox4x32_10((i, r / 4, iteration, 0), key).
//
// Replaces: the JAX engine's per-iteration jax.random.bits draws
// (cbctmc_tpu/engine/transport.py run_projection: the rbg / threefry bits
// of every consumer), which on the TPU are XLA's generator inside the
// compiled loop; no Pallas counterpart. The phase kernels of the main path
// do not read this block: they compute the same words in registers
// (philox.cuh). This kernel is that generator as a launch of its own: it
// feeds the plain PyTorch phases of the stepwise path on the card, and it
// is how philox.cuh is held, word for word, against the plain version
// (rng.philox_bits).
//
// Bound on the H100: bytes. 8 B written per word, nothing read: 39.8 MB for
// the production block of 76 rows x 65,536 lanes. One Philox call (~60
// integer instructions) yields four words, far below the integer rate at
// that traffic.
//
// Design: one thread per (row group, lane); a thread makes one Philox call
// and stores its four words into four consecutive rows, so the lanes of a
// warp write neighbouring addresses of each row.
//
// A second entry point, philox_words, runs the generator on arbitrary
// (counter, key) pairs given in device memory: how the known-answer vectors
// and counters outside the block's layout reach philox4x32_10.

#include "philox.cuh"

__global__ void philox_block_kernel(long long* __restrict__ out, int n_rows, int n,
                                    uint32_t iteration, uint32_t k0, uint32_t k1) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const int group = blockIdx.y;
  if (lane >= n) return;
  const uint4 w = philox4x32_10(make_uint4((uint32_t)lane, (uint32_t)group, iteration, 0u),
                                k0, k1);
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int row = 4 * group + j;
    if (row < n_rows) out[(size_t)row * (size_t)n + lane] = (long long)words[j];
  }
}

extern "C" int philox_block_launch(long long* out, int n_rows, int n, unsigned iteration,
                                   unsigned k0, unsigned k1, void* stream) {
  if (n > 0 && n_rows > 0) {
    const dim3 grid((n + 255) / 256, (n_rows + 3) / 4);
    philox_block_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(out, n_rows, n, iteration,
                                                               k0, k1);
  }
  return (int)cudaGetLastError();
}

// out[i] = philox4x32_10(counters[i], keys[i]); all words held as int64
__global__ void philox_words_kernel(const long long* __restrict__ counters,
                                    const long long* __restrict__ keys,
                                    long long* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long* c = counters + 4 * (size_t)i;
  const uint4 w = philox4x32_10(
      make_uint4((uint32_t)c[0], (uint32_t)c[1], (uint32_t)c[2], (uint32_t)c[3]),
      (uint32_t)keys[2 * (size_t)i], (uint32_t)keys[2 * (size_t)i + 1]);
  long long* o = out + 4 * (size_t)i;
  o[0] = (long long)w.x;
  o[1] = (long long)w.y;
  o[2] = (long long)w.z;
  o[3] = (long long)w.w;
}

extern "C" int philox_words_launch(const long long* counters, const long long* keys,
                                   long long* out, int n, void* stream) {
  if (n > 0) {
    philox_words_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(counters, keys,
                                                                          out, n);
  }
  return (int)cudaGetLastError();
}
