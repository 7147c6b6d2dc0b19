// refill: start new photon histories in dead lanes and, at the start of an
// outer iteration, sample every lane's adoption candidate.
//
// Replaces: the refill stage of the JAX engine's loop body
// (cbctmc_tpu/engine/transport.py run_projection: the exclusive-cumsum
// history budget, sample_photons = sample_spectrum_energy_cdf +
// sample_source_direction + _move_to_bbox, the candidate pool and
// _mid_refill), which on the TPU is some hundred whole-batch XLA operations
// inside the compiled while_loop; it has no Pallas counterpart.
//
// Bound on the H100: bytes. A lane reads its alive flag and up to 12 rows of
// the iteration's random block (8 B each), and writes the 8 candidate words
// plus, where a history starts, 11 state words: at most ~190 B per lane,
// 12 MB per launch at 65,536 lanes. The arithmetic (a 7-step binary search,
// two sin/cos pairs, three divisions per sampled photon) is far below the
// fp32 peak at that rate.
//
// Design: one thread per lane. The spectrum table (CDF, bin edges, bin
// widths: 359 floats) is staged in shared memory. Every block reads the
// budget as the previous launch left it; while it covers every lane, a dead
// lane starts a history without looking at any other lane. When it runs
// short (once per chunk), lanes start in lane order: each block sums the
// dead-lane counts its predecessors' blocks left in `block_dead` and scans
// its own lanes by warp ballot. The histories started are summed per block,
// added with one atomic, and the block that finishes last takes the total
// off the budget, so no block sees another's decrement.

#include "samplers.cuh"

__global__ void __launch_bounds__(PHASE_THREADS)
refill_kernel(Lanes L, Candidates C, const long long* __restrict__ bits, int pool,
              int cand_pool, const float* __restrict__ spec, int32_t* ctrl,
              unsigned long long* counters, const int32_t* __restrict__ block_dead,
              PhaseParams Q) {
  extern __shared__ float s_spec[];
  __shared__ int s_word, s_buf[32];
  const int spec_len = 3 * Q.n_spec_bins - 1;
  for (int j = threadIdx.x; j < spec_len; j += blockDim.x) s_spec[j] = spec[j];
  const int remaining = read_remaining(ctrl, &s_word);  // also orders s_spec

  const int n = Q.n;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool with_candidates = cand_pool >= 0;
  // between sub-phases a lane that parked an escape record keeps it
  const bool dead = i < n && !L.alive[i] && (with_candidates || !L.escaped[i]);

  bool want = dead && remaining >= n;
  if (remaining < n && remaining > 0) {  // the ordered tail of the budget
    int before = 0;
    for (int b = threadIdx.x; b < (int)blockIdx.x; b += blockDim.x) before += block_dead[b];
    before = block_sum(before, s_buf);
    if (threadIdx.x == 0) s_word = before;
    const unsigned ballot = __ballot_sync(0xffffffffu, dead);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    __syncthreads();
    before = s_word;
    if (lane == 0) s_buf[warp] = __popc(ballot);
    __syncthreads();
    for (int w = 0; w < warp; ++w) before += s_buf[w];
    const int order = before + __popc(ballot & ((1u << lane) - 1u));
    want = dead && order < remaining;
  }

  int started = 0;
  if (want) {
    const Photon p = sample_photon(bits, pool, n, i, s_spec, Q);
    if (p.ok) {
      started = 1;
      L.px[i] = p.px; L.py[i] = p.py; L.pz[i] = p.pz;
      L.dx[i] = p.dx; L.dy[i] = p.dy; L.dz[i] = p.dz;
      L.energy[i] = p.energy;
      L.ebin[i] = p.ebin;
      L.scatter[i] = 0;
      L.alive[i] = 1;
      L.pending[i] = 0;
      // the lane enters at the volume wall: the analytic-air flight branch
      // covers the crossing, no clearance lookup at the entry point
      L.k_air[i] = 0;
      L.k_soft[i] = 0;
    }
  }
  if (with_candidates && i < n) {
    const Photon p = sample_photon(bits, cand_pool, n, i, s_spec, Q);
    C.px[i] = p.px; C.py[i] = p.py; C.pz[i] = p.pz;
    C.dx[i] = p.dx; C.dy[i] = p.dy; C.dz[i] = p.dz;
    C.energy[i] = p.energy;
    C.ebin[i] = p.ebin;
    L.cand_free[i] = p.ok;
    L.escaped[i] = 0;
  }

  started = block_sum(started, s_buf);
  if (threadIdx.x == 0) {
    count(counters, with_candidates ? COUNT_REFILLS : COUNT_ADOPTIONS, started);
    settle_budget(ctrl, started);
  }
}

extern "C" int refill_launch(const Lanes* lanes, const Candidates* cands,
                             const long long* bits, int pool, int cand_pool,
                             const float* spec, int32_t* ctrl,
                             unsigned long long* counters, const int32_t* block_dead,
                             const PhaseParams* params, void* stream) {
  if (params->n > 0) {
    const int blocks = (params->n + PHASE_THREADS - 1) / PHASE_THREADS;
    const size_t shared = (3 * params->n_spec_bins - 1) * sizeof(float);
    refill_kernel<<<blocks, PHASE_THREADS, shared, (cudaStream_t)stream>>>(
        *lanes, *cands, bits, pool, cand_pool, spec, ctrl, counters, block_dead, *params);
  }
  return (int)cudaGetLastError();
}
