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
// Bound on the H100: bytes. A lane reads its alive flag and writes the 8
// candidate words plus, where a history starts, 11 state words: at most
// ~80 B per lane, 5 MB per launch at 65,536 lanes. Its random numbers cost
// no bytes: they are Philox words made in registers (philox.cuh), two to
// three calls of ~60 integer instructions per sampled photon; before, 12
// rows of a block that another operation had written to device memory were
// the larger part of this kernel's traffic. The arithmetic (a 7-step binary
// search, two sin/cos pairs, three divisions per sampled photon) is far
// below the fp32 peak at that rate.
//
// Design: one thread per lane. The spectrum table (CDF, bin edges, bin
// widths: 359 floats) and the parameter struct are staged in shared memory.
// Every block reads the control words as the previous launch left them and
// returns at once when the loop has ended (CTRL_RUN = 0: a launch recorded
// in a graph beyond the last iteration changes nothing). While the budget
// covers every lane, a dead
// lane starts a history without looking at any other lane. When it runs
// short (once per chunk), lanes start in lane order: each block sums the
// dead-lane counts its predecessors' blocks left in `block_dead` and scans
// its own lanes by warp ballot. The histories started are summed per block,
// added with one atomic, and the block that finishes last takes the total
// off the budget, so no block sees another's decrement. A photon pool is 6
// consecutive rows, so a lane that starts a history and samples its
// candidate makes three Philox calls (the pools at rows 0 and 6 share the
// group of rows 4..7).

#include "samplers.cuh"

__global__ void __launch_bounds__(PHASE_THREADS)
refill_kernel(Lanes L, Candidates C, int pool, int cand_pool,
              const float* __restrict__ spec, int spec_len, int32_t* ctrl,
              unsigned long long* counters, const int32_t* __restrict__ block_dead,
              const PhaseParams* __restrict__ phase) {
  extern __shared__ float s_spec[];
  __shared__ PhaseParams s_phase;
  __shared__ int s_word, s_ctrl[5], s_buf[32];
  for (int j = threadIdx.x; j < spec_len; j += blockDim.x) s_spec[j] = spec[j];
  stage_struct(&s_phase, phase);
  const Ctrl ctrl_in = read_ctrl(ctrl, s_ctrl);  // also orders s_spec and s_phase
  if (!ctrl_in.run) return;
  const PhaseParams& Q = s_phase;
  const int remaining = ctrl_in.remaining;

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

  Rng rng = rng_for_lane(ctrl_in.k0, ctrl_in.k1, ctrl_in.iteration, (uint32_t)i);
  int started = 0;
  if (want) {
    const Photon p = sample_photon(rng, pool, s_spec, Q);
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
    const Photon p = sample_photon(rng, cand_pool, s_spec, Q);
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
    settle_launch(ctrl, started, CTRL_LAUNCHES_REFILL, false, 0);
  }
}

extern "C" int refill_launch(const Lanes* lanes, const Candidates* cands, int pool,
                             int cand_pool, const float* spec, int spec_len, int n,
                             int32_t* ctrl, unsigned long long* counters,
                             const int32_t* block_dead, const PhaseParams* phase,
                             void* stream) {
  if (n > 0) {
    const int blocks = (n + PHASE_THREADS - 1) / PHASE_THREADS;
    refill_kernel<<<blocks, PHASE_THREADS, spec_len * sizeof(float), (cudaStream_t)stream>>>(
        *lanes, *cands, pool, cand_pool, spec, spec_len, ctrl, counters, block_dead, phase);
  }
  return (int)cudaGetLastError();
}
