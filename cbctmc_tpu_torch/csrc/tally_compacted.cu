// tally_compacted: the v3 tally of a sub-phase and the ranks of its pending
// events in one launch: every lane's stash or parked record into the image,
// the doubles ranked and settled where they are ranked (tallied below the
// budget, carried past it), the pending events compacted into the resolve's
// slots.
//
// Replaces: the compacted tally of the JAX engine's v3 body
// (cbctmc_tpu/engine/transport.py run_projection :1196-1232, resolve_inplace
// =False): _tally_pixel, the one n-slot scatter-add of each lane's stash or
// parked record, the lanes holding both (doubles) compacted into a batch of
// doubles_lanes whose parked records a second scatter-add takes, the doubles
// past that budget carrying their parked record as the stash; and the first
// step of the _resolve that follows it (:1280), _compact_indices (:549) of
// the pending, live lanes into event_lanes slots, which the tally does not
// change. No Pallas counterpart: on the TPU it is XLA's scatters and cumsums
// in the compiled loop. Plain version: transport.tally_compacted_phase_reference,
// then transport.compact_indices(pending & alive, event_lanes, n)
// (transport.tally_compacted_events_reference).
//
// Bound on the H100: bytes. A lane reads its four flags (its records',
// pending, alive) and, where it holds a record, 32 B of a parked one
// (position, direction, energy, scatter class) and 8 B of a stashed one,
// and writes a cleared flag and, for an overflowed double, 8 B of stash; each
// record is one 4-byte atomic add into the image (a 32-byte sector of L2);
// each event slot is written once (4 B). About 0.65 MB a sub-phase at 65,536
// lanes with a third of them holding a record and 22,937 slots (0.2 us at
// 3.35 TB/s). At that size the launch's fixed cost (~1.4 us for a launch of
// 256 blocks that only reads the control words), the chain of dependent reads
// a lane makes (its flags, then its record, then the image's sector) and the
// look-back's round trips through L2 bound it.
//
// Design: one launch, TALLY_ITEMS lanes a thread (the per-lane body is
// flight.cuh's tally, ordered as the JAX engine orders it: the stash, else
// the parked record). Every flag of the thread's lanes is read at once, then
// every record it holds, so no read waits on another but the record on its
// flag. Two masks are ranked by the single-pass scan of compact.cuh under
// one ticket a block (it orders the blocks, and the blocks' lanes follow
// their tickets; epoch-tagged flags need no reset), each in a row of flags
// of its own in the scratch: the doubles and the events (pending && alive).
// Both aggregates are published at once; warp 0 walks back for the events'
// prefix (every block: its slots and its share of the fill) while warp 1
// walks back for the doubles' (only a block that holds a double) and the
// other warps' image atomics drain. Then the thread that holds a double
// finishes it with its parked record still in registers: below
// doubles_lanes it adds the record and clears the stash flag, past it the
// record waits in the stash (overflow carry: never dropped); an event ranked
// below event_lanes writes its lane into its slot, and each block writes
// n into its share of the slots past the total, as compact.cu fills them.
// A lane clears its own parked flag where it is set (the JAX body clears
// them after the resolve, which does not read them). Records and tallied
// energy (float64) are summed per block and added by one atomic each; the
// image's adds come in an order that changes from run to run, so it agrees
// with the plain version's index_add_ to rounding; the counters, the lane
// state and the slots exactly.

#include "compact.cuh"
#include "flight.cuh"

// lanes a thread: 4, 1,024 lanes a block (compact.cu's grid: 64 blocks at
// 65,536 lanes, one window of the look-back), measured faster than 1 (256
// blocks) on the main path's state (scripts/compare_engine_phases.py
// --variants). The scan scratch the wrapper allocates holds the widest grid
// (a lane a thread).
#define TALLY_ITEMS 4
#define TALLY_BLOCK (PHASE_THREADS * TALLY_ITEMS)

__global__ void __launch_bounds__(PHASE_THREADS)
tally_compacted_kernel(Lanes L, float* __restrict__ image, int32_t* ctrl,
                       unsigned long long* counters, double* energy_sum, ScanScratch scan,
                       int doubles_budget, int32_t* __restrict__ events_idx, int event_budget,
                       const Params* __restrict__ params) {
  constexpr int kWarps = PHASE_THREADS / 32;
  __shared__ Params s_params;
  __shared__ int s_ctrl[5], s_buf[32], s_count[2][TALLY_ITEMS][kWarps];
  __shared__ int s_logical, s_events_before, s_doubles_before;
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
  // one ticket, two rows of flags: the doubles' scan, then the events'
  const ScanScratch doubles_scan = scan, events_scan = {scan.words + gridDim.x};
  const Params& P = s_params;
  const int n = P.n, npix = P.npix_x * P.npix_z, none = 4 * npix;  // none: no record
  const int first = k.logical * TALLY_BLOCK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // lane first + q * PHASE_THREADS + threadIdx.x: every flag read at once
  uint8_t escaped[TALLY_ITEMS], stashed[TALLY_ITEMS], pending[TALLY_ITEMS],
      alive[TALLY_ITEMS];
#pragma unroll
  for (int q = 0; q < TALLY_ITEMS; ++q) {
    const int i = first + q * PHASE_THREADS + threadIdx.x;
    const bool in = i < n;
    escaped[q] = in ? L.escaped[i] : 0;
    stashed[q] = in ? L.stash_valid[i] : 0;
    pending[q] = in ? L.pending[i] : 0;
    alive[q] = in ? L.alive[i] : 0;
  }
  // then every record the thread's lanes hold
  float px[TALLY_ITEMS], py[TALLY_ITEMS], pz[TALLY_ITEMS], dx[TALLY_ITEMS], dy[TALLY_ITEMS],
      dz[TALLY_ITEMS], parked_energy[TALLY_ITEMS], stash_energy[TALLY_ITEMS];
  int scatter[TALLY_ITEMS], stash_idx[TALLY_ITEMS];
#pragma unroll
  for (int q = 0; q < TALLY_ITEMS; ++q) {
    const int i = first + q * PHASE_THREADS + threadIdx.x;
    if (escaped[q]) {
      px[q] = L.px[i]; py[q] = L.py[i]; pz[q] = L.pz[i];
      dx[q] = L.dx[i]; dy[q] = L.dy[i]; dz[q] = L.dz[i];
      parked_energy[q] = L.energy[i];
      scatter[q] = L.scatter[i];
    }
    stash_idx[q] = none;
    if (stashed[q]) {
      stash_idx[q] = L.stash_idx[i];
      stash_energy[q] = L.stash_energy[i];
    }
  }
  int tallied = 0, parked[TALLY_ITEMS];
  double tallied_energy = 0.0;
  bool dbl[TALLY_ITEMS], event[TALLY_ITEMS];
#pragma unroll
  for (int q = 0; q < TALLY_ITEMS; ++q) {
    const int i = first + q * PHASE_THREADS + threadIdx.x;
    event[q] = pending[q] && alive[q];
    parked[q] = none;
    if (escaped[q]) {
      const int pix = detector_pixel(px[q], py[q], pz[q], dx[q], dy[q], dz[q], P);
      parked[q] = pix >= 0 ? scatter[q] * npix + pix : none;
      L.escaped[i] = 0;
    }
    const bool has_stash = stash_idx[q] < none;
    const int idx = has_stash ? stash_idx[q] : parked[q];
    if (idx < none) {
      const float val = has_stash ? stash_energy[q] : parked_energy[q];
      atomicAdd(image + idx, val);
      tallied += 1;
      tallied_energy += (double)val;
    }
    dbl[q] = has_stash && parked[q] < none;
    // a double's stash flag is settled below, by its rank
    if (stashed[q] && !dbl[q]) L.stash_valid[i] = 0;
  }

  // both masks ranked in the block: ballots a warp and chunk, then the
  // entries of each mask before this warp's chunk q and the block's totals
  unsigned ballot_d[TALLY_ITEMS], ballot_e[TALLY_ITEMS];
#pragma unroll
  for (int q = 0; q < TALLY_ITEMS; ++q) {
    ballot_d[q] = __ballot_sync(0xffffffffu, dbl[q]);
    ballot_e[q] = __ballot_sync(0xffffffffu, event[q]);
    if (lane == 0) {
      s_count[0][q][warp] = __popc(ballot_d[q]);
      s_count[1][q][warp] = __popc(ballot_e[q]);
    }
  }
  __syncthreads();
  int below_d[TALLY_ITEMS] = {}, below_e[TALLY_ITEMS] = {}, block_d = 0, block_e = 0;
#pragma unroll
  for (int q = 0; q < TALLY_ITEMS; ++q) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w == warp) {
        below_d[q] = block_d;
        below_e[q] = block_e;
      }
      block_d += s_count[0][q][w];
      block_e += s_count[1][q][w];
    }
  }
  if (threadIdx.x == 0) {
    scan_publish_aggregate(doubles_scan, k, block_d);
    scan_publish_aggregate(events_scan, k, block_e);
  }
  // the prefixes: the events' in every block, the doubles' only in a block
  // that holds one (the others' aggregates stand for them)
  if (warp == 0) {
    const int before = scan_lookback(events_scan, k, block_e);
    if (lane == 0) s_events_before = before;
  } else if (warp == 1 && block_d > 0) {
    const int before = scan_lookback(doubles_scan, k, block_d);
    if (lane == 0) s_doubles_before = before;
  }
  __syncthreads();
  const int events_before = s_events_before;
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int q = 0; q < TALLY_ITEMS; ++q) {
    const int i = first + q * PHASE_THREADS + threadIdx.x;
    if (dbl[q]) {
      const int rank = s_doubles_before + below_d[q] + __popc(ballot_d[q] & lower);
      if (rank < doubles_budget) {
        atomicAdd(image + parked[q], parked_energy[q]);
        tallied += 1;
        tallied_energy += (double)parked_energy[q];
        L.stash_valid[i] = 0;
      } else {  // overflow carry: the parked record waits in the stash
        L.stash_idx[i] = parked[q];
        L.stash_energy[i] = parked_energy[q];
      }
    }
    const int rank = events_before + below_e[q] + __popc(ballot_e[q] & lower);
    if (event[q] && rank < event_budget) events_idx[rank] = i;
  }
  // n in the slots past the events' total, each slot by one block
  // (compact.cu): up to the lanes after this block, the slots from its
  // inclusive prefix on hold no event; up to where the block before starts,
  // that is this block's lanes less its events
  const int lanes = n - first < TALLY_BLOCK ? n - first : TALLY_BLOCK;
  const int after = n - first - lanes;
#pragma unroll
  for (int q = 0; q < TALLY_ITEMS; ++q) {
    const int t = q * PHASE_THREADS + threadIdx.x;
    const int j = events_before + block_e + after + t;
    if (t < lanes - block_e && j < event_budget) events_idx[j] = n;
  }
  for (int base = n + first; base < event_budget; base += gridDim.x * TALLY_BLOCK) {
#pragma unroll
    for (int q = 0; q < TALLY_ITEMS; ++q) {
      const int j = base + q * PHASE_THREADS + threadIdx.x;
      if (j < event_budget) events_idx[j] = n;
    }
  }

  tallied = block_sum(tallied, s_buf);
  tallied_energy = block_sum(tallied_energy, s_dbuf);
  if (threadIdx.x == 0) {
    count(counters, COUNT_TALLIED, tallied);
    if (tallied) atomicAdd(energy_sum, tallied_energy);
  }
  count_launch(ctrl, CTRL_LAUNCHES_TALLY_COMPACTED);
}

static long long blocks_of(int n, int per_block) {
  return ((long long)n + per_block - 1) / per_block;
}

// `scan` holds at least 1 + 2 * blocks_of(n, PHASE_THREADS) words
// (`scan_len`: the ticket and two rows of flags at the widest grid), and
// every launch on it has the same n; `events_idx` holds `event_budget`
// slots
extern "C" int tally_compacted_launch(const Lanes* lanes, int n, float* image, int32_t* ctrl,
                                      unsigned long long* counters, double* energy_sum,
                                      unsigned long long* scan, long long scan_len,
                                      int doubles_budget, int32_t* events_idx,
                                      int event_budget, const Params* params, void* stream) {
  if (n < 0 || doubles_budget < 0 || event_budget < 0 ||
      (n > 0 && scan_len < 1 + 2 * blocks_of(n, PHASE_THREADS))) {
    return (int)cudaErrorInvalidValue;
  }
  if (n > 0) {
    tally_compacted_kernel<<<(int)blocks_of(n, TALLY_BLOCK), PHASE_THREADS, 0,
                             (cudaStream_t)stream>>>(*lanes, image, ctrl, counters, energy_sum,
                                                     ScanScratch{scan}, doubles_budget,
                                                     events_idx, event_budget, params);
  }
  return (int)cudaGetLastError();
}
