// flight_step: one Woodcock flight of every photon lane of the engine-v4
// transport loop, over the packed u32 voxel word.
//
// Replaces: the JAX engine's flight closure
// (cbctmc_tpu/engine/transport.py run_projection::flight), whose planned
// TPU kernel is cbctmc_tpu/engine/pallas_kernels.py::_flight_kernel. This is
// the production form of that computation: per lane
//   - the three majorant tiers (full Woodcock, air, soft) from their
//     conservative log-polynomials, the clearance-bounded tier choice and
//     the analytic air flight outside the non-air box; the step clamp;
//   - the voxel lookup (each axis clamped to shape-1) and ONE packed-word
//     gather, unpacked into material | air level | soft level | density;
//   - the total inverse MFP from the per-material Chebyshev rows (Clenshaw,
//     degree 23, in the JAX package's order) and the real-event test, which
//     sets pending / vox / mat_evt / xi;
//   - the detector-plane pixel of an escaping photon, the depth-1 stash of
//     its record and the adoption of the lane's pre-sampled candidate photon
//     while the history budget allows (remaining >= n_lanes, read on the
//     device at launch).
// Inactive lanes (dead or pending) are left untouched.
//
// Bound on the H100: bytes. A lane reads ~31 state and candidate words and
// writes up to 21, plus one 32-byte sector for the voxel gather: about
// 240 B per lane, 15.7 MB per launch at 65,536 lanes, i.e. ~4.7 us at
// 3.35 TB/s. The arithmetic (~3 Clenshaw recurrences of 23 steps, three
// Horner polynomials and ~8 transcendentals, some 400 flops) is ~0.4 us of
// the card's fp32 peak at that width.
//
// Design: one thread per lane with structure-of-arrays lane state, so every
// state word is a coalesced load/store. The [n_mats, 3*24+6] coefficient
// table (~7 KB) is staged in shared memory once per block; lanes of one
// material read the same row (broadcast). The voxel word is a single
// 4-byte __ldg (no paired layout: that was a TPU gather-pricing trick). The
// adoptions and active lanes of the launch are summed with a warp-shuffle
// block reduction and ONE atomicAdd per block; the wrapper then decrements
// the device-side history budget, so every launch of a sub-phase sees the
// budget its predecessors left, as the JAX loop does.
//
// The per-lane body lives in flight.cuh (flight_lane), which the fused
// flight_resolve kernel shares; this kernel loads an active lane's state,
// flies it once and stores it back. The engine's main path runs
// flight_resolve; this single-flight form stays as the kernel the flight is
// measured and checked by on its own.
//
// Built without --use_fast_math (the physics needs logf/expf/expm1f to
// full accuracy) and with -fmad=false, so each product and sum rounds on its
// own, as the plain PyTorch version's separate operations do.

#include "flight.cuh"

__global__ void flight_step_kernel(Lanes L, Candidates C,
                                   const float* __restrict__ u_step_all,
                                   const float* __restrict__ u_int_all,
                                   const uint32_t* __restrict__ packed,
                                   const float* __restrict__ coeffs, int coeff_len,
                                   const int32_t* __restrict__ remaining,
                                   int32_t* __restrict__ counts, Params P) {
  extern __shared__ float s_coeff[];
  for (int j = threadIdx.x; j < coeff_len; j += blockDim.x) s_coeff[j] = coeffs[j];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int adopted = 0, was_active = 0;
  if (i < P.n && L.alive[i] && !L.pending[i]) {
    was_active = 1;
    LaneRegs s = load_lane(L, i);
    adopted = flight_lane(s, C, i, u_step_all[i], u_int_all[i], packed, s_coeff,
                          remaining[0] >= P.n, P);
    store_lane(L, i, s);
  }

  // ---- block reduction of (adopted, active), one atomic per block -------
  __shared__ int s_buf[32];
  adopted = block_sum(adopted, s_buf);
  was_active = block_sum(was_active, s_buf);
  if (threadIdx.x == 0) {
    if (adopted) atomicAdd(counts, adopted);
    if (was_active) atomicAdd(counts + 1, was_active);
  }
}

extern "C" int flight_step_launch(const Lanes* lanes, const Candidates* cands,
                                  const float* u_step, const float* u_int,
                                  const uint32_t* packed, const float* coeffs,
                                  int coeff_len, const int32_t* remaining,
                                  int32_t* counts, const Params* params, void* stream) {
  if (params->n > 0) {
    const int threads = 256;
    const int blocks = (params->n + threads - 1) / threads;
    flight_step_kernel<<<blocks, threads, coeff_len * sizeof(float),
                         (cudaStream_t)stream>>>(*lanes, *cands, u_step, u_int, packed,
                                                 coeffs, coeff_len, remaining, counts,
                                                 *params);
  }
  return (int)cudaGetLastError();
}
