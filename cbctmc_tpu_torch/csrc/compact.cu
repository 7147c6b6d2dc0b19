// compact: order-preserving stream compaction of a lane (or slot) mask into
// a batch of static size, and each entry's rank, in one launch.
//
// Replaces: the JAX engine's _compact_indices (cbctmc_tpu/engine/transport.py
// :549: cumsum of the mask, a masked position, one scatter into budget + 1
// slots), which the v3 body (resolve_inplace=False) runs three times a
// sub-phase: the pending events into event_lanes slots, the Rayleigh events
// among those slots into rayleigh_lanes, the tally's doubles into
// doubles_lanes. No Pallas counterpart: on the TPU it is XLA's cumsum and
// scatter. Plain version: transport.compact_indices. This kernel is the
// compaction as a launch of its own (the wrapper kernels.compact); the
// engine runs all three as the same scan (compact.cuh) inside the kernels
// that make their masks (tally_compacted.cu: the doubles and the events,
// with this kernel's fill; resolve_compacted.cu: the Rayleigh slots).
//
// Contract: mask[i] = a[i] && (b == nullptr || b[i]) for i < m (bytes);
// idx[0 .. budget) gets the indices of the first `budget` true entries in
// index order and `fill` in the slots left empty (the budget may be 0 or
// exceed m); order[i] = (true entries at or before i) - 1, for every i < m,
// so a true entry's rank. Either output may be null (not written).
//
// Bound on the H100: bytes. Each entry's mask byte (two with `b`) is read
// once and its rank written (4 B), each slot written once (4 B): ~9 B an
// entry, 0.6 MB at 65,536 lanes (0.13 us at 3.35 TB/s). At that size the
// launch itself is the cost: the first design's two launches (the counts
// per block, then a scan in which every block re-read all the counts) took
// ~2 us each.
//
// Design: one launch, blocks of COMPACT_BLOCK entries (4 a thread), the
// scan across blocks by decoupled look-back (compact.cuh: a ticket orders the blocks,
// epoch-tagged flags need no reset inside a CUDA graph). A block ranks its
// entries by warp ballots, warp 0 finds the block's prefix, the entries
// ranked below the budget write their index into their slot, and each block
// writes `fill` into its share of the slots past the total, though only the
// last block learns the total: the slots from a block's inclusive prefix
// plus the lanes after it on can hold no entry, so each block fills at most
// its own lane count of slots, one store a thread (the slots at m and past,
// where a budget exceeds m, by a grid-stride loop). Launched with a control
// word array (the engine), it does nothing once the loop has ended (every
// block reads the same word; the tickets are taken all the same) and counts
// itself (CTRL_LAUNCHES_COMPACT); launched without (the wrapper), it always
// runs.
//
// Entry control_floor: a launch of a given grid whose blocks only read the
// control words, the floor under which no phase launch of that grid can
// run (timed by chip_smoke.py beside the v3 iteration's launches).

#include "compact.cuh"

// entries a thread, and a block: a block of 1,024 entries keeps the walk
// back of a launch of 65,536 lanes to 64 flags, one window of compact.cuh
#define COMPACT_ITEMS 4
#define COMPACT_BLOCK (PHASE_THREADS * COMPACT_ITEMS)

__global__ void __launch_bounds__(PHASE_THREADS)
compact_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b, int m,
               ScanScratch scan, int budget, int fill, int32_t* __restrict__ idx,
               int32_t* __restrict__ order, int32_t* ctrl) {
  __shared__ int s_run, s_logical, s_before;
  __shared__ int s_count[COMPACT_ITEMS][PHASE_THREADS / 32];
  __shared__ uint32_t s_tag;
  if (threadIdx.x == 0) {
    const ScanTicket k = scan_ticket(scan);  // taken whether or not the loop runs
    s_run = ctrl == nullptr ? 1 : ((const volatile int32_t*)ctrl)[CTRL_RUN];
    s_logical = k.logical;
    s_tag = k.tag;
  }
  __syncthreads();
  if (!s_run) return;  // every block of the launch agrees
  const ScanTicket k = {s_logical, s_tag};
  const int first = k.logical * COMPACT_BLOCK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // entry first + q * PHASE_THREADS + threadIdx.x: every mask byte read at
  // once (no read waits on another), then ballots a warp and chunk
  uint8_t in_a[COMPACT_ITEMS], in_b[COMPACT_ITEMS];
#pragma unroll
  for (int q = 0; q < COMPACT_ITEMS; ++q) {
    const int i = first + q * PHASE_THREADS + threadIdx.x;
    in_a[q] = i < m ? a[i] : 0;
    in_b[q] = i < m && b != nullptr ? b[i] : 1;
  }
  bool flag[COMPACT_ITEMS];
  unsigned ballot[COMPACT_ITEMS];
#pragma unroll
  for (int q = 0; q < COMPACT_ITEMS; ++q) {
    flag[q] = in_a[q] && in_b[q];
    ballot[q] = __ballot_sync(0xffffffffu, flag[q]);
    if (lane == 0) s_count[q][warp] = __popc(ballot[q]);
  }
  __syncthreads();
  int below[COMPACT_ITEMS] = {}, aggregate = 0;  // true entries before this warp's chunk q
#pragma unroll
  for (int q = 0; q < COMPACT_ITEMS; ++q) {
#pragma unroll
    for (int w = 0; w < PHASE_THREADS / 32; ++w) {
      if (w == warp) below[q] = aggregate;
      aggregate += s_count[q][w];
    }
  }
  if (threadIdx.x == 0) scan_publish_aggregate(scan, k, aggregate);
  if (threadIdx.x < 32) {
    const int before = scan_lookback(scan, k, aggregate);
    if (threadIdx.x == 0) s_before = before;
  }
  __syncthreads();
  const int before = s_before;
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int q = 0; q < COMPACT_ITEMS; ++q) {
    const int i = first + q * PHASE_THREADS + threadIdx.x;
    const int rank = before + below[q] + __popc(ballot[q] & lower);
    if (i < m && order != nullptr) order[i] = rank + (flag[q] ? 1 : 0) - 1;
    if (flag[q] && rank < budget && idx != nullptr) idx[rank] = i;
  }
  if (idx != nullptr) {
    // `fill` past the total, each slot by one block: the entries after this
    // block are at most the lanes after it (`after`), so the slots from its
    // inclusive prefix + `after` on hold no entry; up to where the block
    // before starts, that is this block's lanes less its entries
    const int lanes = m - first < COMPACT_BLOCK ? m - first : COMPACT_BLOCK;
    const int after = m - first - lanes;
#pragma unroll
    for (int q = 0; q < COMPACT_ITEMS; ++q) {
      const int t = q * PHASE_THREADS + threadIdx.x;
      const int j = before + aggregate + after + t;
      if (t < lanes - aggregate && j < budget) idx[j] = fill;
    }
    for (int base = m + first; base < budget; base += gridDim.x * COMPACT_BLOCK) {
#pragma unroll
      for (int q = 0; q < COMPACT_ITEMS; ++q) {
        const int j = base + q * PHASE_THREADS + threadIdx.x;
        if (j < budget) idx[j] = fill;
      }
    }
  }
  count_launch(ctrl, CTRL_LAUNCHES_COMPACT);
}

__global__ void __launch_bounds__(PHASE_THREADS) control_floor_kernel(const int32_t* ctrl) {
  __shared__ int s_ctrl[5];
  read_ctrl(ctrl, s_ctrl);
}

static int blocks_of(int m) { return (m + COMPACT_BLOCK - 1) / COMPACT_BLOCK; }

// `scan` holds 1 + blocks_of(m) words (`scan_len`), the same m at every
// launch on it; a negative m or budget is refused
extern "C" int compact_launch(const uint8_t* a, const uint8_t* b, int m,
                              unsigned long long* scan, long long scan_len, int budget,
                              int fill, int32_t* idx, int32_t* order, int32_t* ctrl,
                              void* stream) {
  if (m < 0 || budget < 0 || (m > 0 && scan_len != 1 + (long long)blocks_of(m))) {
    return (int)cudaErrorInvalidValue;
  }
  if (m > 0) {
    compact_kernel<<<blocks_of(m), PHASE_THREADS, 0, (cudaStream_t)stream>>>(
        a, b, m, ScanScratch{scan}, budget, fill, idx, order, ctrl);
  }
  return (int)cudaGetLastError();
}

extern "C" int control_floor_launch(const int32_t* ctrl, int blocks, void* stream) {
  if (blocks > 0) {
    control_floor_kernel<<<blocks, PHASE_THREADS, 0, (cudaStream_t)stream>>>(ctrl);
  }
  return (int)cudaGetLastError();
}
