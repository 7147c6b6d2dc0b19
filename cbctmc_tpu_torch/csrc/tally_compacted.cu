// tally_compacted: the v3 tally of a sub-phase, a primary pass over every
// lane that also ranks the doubles, and a second pass over the doubles with
// the overflow carry.
//
// Replaces: the compacted tally of the JAX engine's v3 body
// (cbctmc_tpu/engine/transport.py run_projection :1196-1232, resolve_inplace
// =False): _tally_pixel, the one n-slot scatter-add of each lane's stash or
// parked record, the lanes holding both (doubles) compacted into a batch of
// doubles_lanes whose parked records a second scatter-add takes, the doubles
// past that budget carrying their parked record as the stash. No Pallas
// counterpart: on the TPU it is XLA's scatters in the compiled loop. Plain
// version: transport.tally_compacted_phase_reference.
//
// Bound on the H100: bytes. A lane reads its two record flags and, where it
// holds a record, 32 B of a parked one (position, direction, energy, scatter
// class) and 8 B of a stashed one, and writes a flag byte, the doubles byte
// and, for an overflowed double, 8 B of stash; each record is one 4-byte
// atomic add into the image (a 32-byte sector of L2). A double is read again
// by the second pass (32 B). About 2 MB a sub-phase at 65,536 lanes with a
// third of them holding a record (0.6 us at 3.35 TB/s); at that size the
// two launches' fixed costs and the atomics' latency bound it.
//
// Design: one thread per lane in both passes (the per-lane body of the
// first is flight.cuh's tally, reordered as the JAX engine orders it: the
// stash, else the parked record). The first pass also ranks the doubles
// among the lanes by the single-pass scan of compact.cuh (a ticket orders
// its blocks, epoch-tagged flags need no reset; the blocks' lanes follow
// their tickets; warp 0 walks back while the other warps' image atomics
// drain) and leaves a byte per lane: 0 no double, 1 a double ranked
// below the budget, 2 one past it; so no compact launch sits between the
// passes (the first design wrote per-block counts for a compact launch to
// rank). The second pass adds the parked records of the doubles below the
// budget and carries the others: such a lane's record is recomputed from its
// frozen state (an escaped lane does not move), so nothing else is kept
// between the passes. The second pass also clears the sub-phase's parked
// flags (the JAX body clears them after the resolve, which does not read
// them). Records and tallied energy (float64) are summed per block and
// added by one atomic each; the image's adds come in an order that changes
// from run to run, so it agrees with the plain version's index_add_ to
// rounding; the integer counters exactly.

#include "compact.cuh"
#include "flight.cuh"

// the lane's parked record (idx < 4 * npix: it hits the detector)
__device__ __forceinline__ int parked_record(const Lanes& L, int i, const Params& P,
                                             float& energy) {
  const int npix = P.npix_x * P.npix_z;
  const int pix = detector_pixel(L.px[i], L.py[i], L.pz[i], L.dx[i], L.dy[i], L.dz[i], P);
  energy = L.energy[i];
  return pix >= 0 ? L.scatter[i] * npix + pix : 4 * npix;
}

__global__ void __launch_bounds__(PHASE_THREADS)
tally_primary_kernel(Lanes L, float* __restrict__ image, int32_t* ctrl,
                     unsigned long long* counters, double* energy_sum,
                     uint8_t* __restrict__ doubles, ScanScratch scan, int budget,
                     const Params* __restrict__ params) {
  __shared__ Params s_params;
  __shared__ int s_ctrl[5], s_buf[32], s_warp[PHASE_THREADS / 32], s_logical, s_before;
  __shared__ uint32_t s_tag;
  __shared__ double s_dbuf[32];
  if (threadIdx.x == 0) {  // taken whether or not the loop runs (compact.cuh)
    const ScanTicket k = scan_ticket(scan);
    s_logical = k.logical;
    s_tag = k.tag;
  }
  stage_struct(&s_params, params);
  const Ctrl ctrl_in = read_ctrl(ctrl, s_ctrl);  // also orders s_params and the ticket
  if (!ctrl_in.run) return;  // every block of the launch agrees
  const ScanTicket k = {s_logical, s_tag};
  const Params& P = s_params;
  const int npix = P.npix_x * P.npix_z;
  const int i = k.logical * PHASE_THREADS + threadIdx.x;
  int tallied = 0, dbl = 0;
  double tallied_energy = 0.0;
  if (i < P.n) {
    const bool escaped = L.escaped[i], stashed = L.stash_valid[i];
    if (escaped || stashed) {
      int parked = 4 * npix;
      float parked_energy = 0.0f;
      if (escaped) parked = parked_record(L, i, P, parked_energy);
      const int stash_idx = stashed ? L.stash_idx[i] : 4 * npix;
      const bool has_stash = stashed && stash_idx < 4 * npix;
      const int idx = has_stash ? stash_idx : parked;
      if (idx < 4 * npix) {
        const float val = has_stash ? L.stash_energy[i] : parked_energy;
        atomicAdd(image + idx, val);
        tallied = 1;
        tallied_energy = (double)val;
      }
      dbl = has_stash && parked < 4 * npix;
      // the stash flag becomes the overflow carry: the doubles' is settled
      // by the second pass
      if (stashed && !dbl) L.stash_valid[i] = 0;
    }
  }
  // the doubles' ranks: the block's by ballots, its prefix by the look-back
  // (a block without a double needs none, and does not wait for one)
  int block_doubles;
  const int in_block = block_rank(dbl != 0, s_warp, block_doubles);
  if (threadIdx.x == 0) scan_publish_aggregate(scan, k, block_doubles);
  if (block_doubles > 0) {
    if (threadIdx.x < 32) {
      const int before = scan_lookback(scan, k, block_doubles);
      if (threadIdx.x == 0) s_before = before;
    }
    __syncthreads();
  }
  if (i < P.n) doubles[i] = dbl ? (s_before + in_block < budget ? 1 : 2) : 0;
  tallied = block_sum(tallied, s_buf);
  tallied_energy = block_sum(tallied_energy, s_dbuf);
  if (threadIdx.x == 0) {
    count(counters, COUNT_TALLIED, tallied);
    if (tallied) atomicAdd(energy_sum, tallied_energy);
  }
  count_launch(ctrl, CTRL_LAUNCHES_TALLY_COMPACTED);
}

__global__ void __launch_bounds__(PHASE_THREADS)
tally_doubles_kernel(Lanes L, float* __restrict__ image, int32_t* ctrl,
                     unsigned long long* counters, double* energy_sum,
                     const uint8_t* __restrict__ doubles,
                     const Params* __restrict__ params) {
  __shared__ Params s_params;
  __shared__ int s_ctrl[5], s_buf[32];
  __shared__ double s_dbuf[32];
  stage_struct(&s_params, params);
  const Ctrl ctrl_in = read_ctrl(ctrl, s_ctrl);
  if (!ctrl_in.run) return;
  const Params& P = s_params;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int tallied = 0;
  double tallied_energy = 0.0;
  if (i < P.n) {
    const int dbl = doubles[i];
    if (dbl) {
      float energy;
      const int idx = parked_record(L, i, P, energy);
      if (dbl == 1) {
        atomicAdd(image + idx, energy);
        tallied = 1;
        tallied_energy = (double)energy;
        L.stash_valid[i] = 0;
      } else {  // overflow carry: the parked record waits in the stash
        L.stash_idx[i] = idx;
        L.stash_energy[i] = energy;
      }
    }
    L.escaped[i] = 0;
  }
  tallied = block_sum(tallied, s_buf);
  tallied_energy = block_sum(tallied_energy, s_dbuf);
  if (threadIdx.x == 0) {
    count(counters, COUNT_TALLIED, tallied);
    if (tallied) atomicAdd(energy_sum, tallied_energy);
  }
  count_launch(ctrl, CTRL_LAUNCHES_TALLY_COMPACTED);
}

static int blocks_of(int n) { return (n + PHASE_THREADS - 1) / PHASE_THREADS; }

// `scan` holds 1 + blocks_of(n) words (`scan_len`), the same n at every
// launch on it
extern "C" int tally_compacted_launch(const Lanes* lanes, int n, float* image, int32_t* ctrl,
                                      unsigned long long* counters, double* energy_sum,
                                      uint8_t* doubles, unsigned long long* scan,
                                      long long scan_len, int budget, const Params* params,
                                      void* stream) {
  if (n < 0 || budget < 0 || (n > 0 && scan_len != 1 + (long long)blocks_of(n))) {
    return (int)cudaErrorInvalidValue;
  }
  if (n > 0) {
    tally_primary_kernel<<<blocks_of(n), PHASE_THREADS, 0, (cudaStream_t)stream>>>(
        *lanes, image, ctrl, counters, energy_sum, doubles, ScanScratch{scan}, budget,
        params);
  }
  return (int)cudaGetLastError();
}

extern "C" int tally_doubles_launch(const Lanes* lanes, int n, float* image, int32_t* ctrl,
                                    unsigned long long* counters, double* energy_sum,
                                    const uint8_t* doubles, const Params* params,
                                    void* stream) {
  if (n > 0) {
    tally_doubles_kernel<<<blocks_of(n), PHASE_THREADS, 0, (cudaStream_t)stream>>>(
        *lanes, image, ctrl, counters, energy_sum, doubles, params);
  }
  return (int)cudaGetLastError();
}
