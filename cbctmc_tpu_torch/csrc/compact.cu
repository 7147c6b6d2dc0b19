// compact: order-preserving stream compaction of a lane (or slot) mask into
// a batch of static size, and each entry's rank.
//
// Replaces: the JAX engine's _compact_indices (cbctmc_tpu/engine/transport.py
// :549: cumsum of the mask, a masked position, one scatter into budget + 1
// slots), which the v3 body (resolve_inplace=False) runs three times a
// sub-phase: the pending events into event_lanes slots, the Rayleigh events
// among those slots into rayleigh_lanes, the tally's doubles into
// doubles_lanes. No Pallas counterpart: on the TPU it is XLA's cumsum and
// scatter. Plain version: transport.compact_indices.
//
// Contract: mask[i] = a[i] && (b == nullptr || b[i]) for i < m (bytes);
// idx[0 .. budget) gets the indices of the first `budget` true entries in
// index order and `fill` in the slots left empty (the budget may exceed m);
// order[i] = (true entries at or before i) - 1, for every i < m, so a true
// entry's rank. Either output may be null (not written).
//
// Bound on the H100: bytes. Each entry's mask byte (two with `b`) is read
// once and its rank written (4 B), each slot written once (4 B), and each
// block reads the per-block counts of the blocks before it (at most a few
// KB, from L2): ~9 B an entry, 0.6 MB at 65,536 lanes. The arithmetic is a
// ballot and two popcounts a warp.
//
// Design: two passes, no host read of the count. The per-block counts of
// the mask (blocks of PHASE_THREADS entries) are written by the launch
// before: the kernel that made the mask (tally_compacted's first pass for
// the doubles, resolve_compacted's branch for the Rayleigh slots) or the
// entry compact_count (the events: pending & alive). The scan's block then
// sums the counts of the blocks before it and its own warps' ballots
// (__popc), so each true entry knows its rank; the entries ranked below the
// budget write their index into their slot; the slots past the last true
// entry get `fill` from a grid-stride loop. Launched with a control word
// array (the engine), it does nothing once the loop has ended and counts
// itself (CTRL_LAUNCHES_COMPACT); launched without (the wrapper), it always
// runs.

#include "engine.cuh"

__device__ __forceinline__ bool mask_at(const uint8_t* __restrict__ a,
                                        const uint8_t* __restrict__ b, int i, int m) {
  return i < m && a[i] && (b == nullptr || b[i]);
}

// true when the engine's loop has ended (every block of the launch agrees)
__device__ __forceinline__ bool loop_ended(const int32_t* ctrl) {
  __shared__ int s_run;
  if (threadIdx.x == 0) s_run = ctrl == nullptr ? 1 : ((const volatile int32_t*)ctrl)[CTRL_RUN];
  __syncthreads();
  return !s_run;
}

__global__ void __launch_bounds__(PHASE_THREADS)
compact_count_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b, int m,
                     int32_t* __restrict__ counts, int32_t* ctrl) {
  __shared__ int s_buf[32];
  if (loop_ended(ctrl)) return;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int c = block_sum(mask_at(a, b, i, m) ? 1 : 0, s_buf);
  if (threadIdx.x == 0) counts[blockIdx.x] = c;
  count_launch(ctrl, CTRL_LAUNCHES_COMPACT);
}

__global__ void __launch_bounds__(PHASE_THREADS)
compact_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b, int m,
               const int32_t* __restrict__ counts, int budget, int fill,
               int32_t* __restrict__ idx, int32_t* __restrict__ order, int32_t* ctrl) {
  __shared__ int s_buf[32], s_before, s_total, s_warp[PHASE_THREADS / 32];
  if (loop_ended(ctrl)) return;
  int before = 0, total = 0;
  for (int blk = threadIdx.x; blk < (int)gridDim.x; blk += blockDim.x) {
    const int c = counts[blk];
    total += c;
    if (blk < (int)blockIdx.x) before += c;
  }
  before = block_sum(before, s_buf);
  if (threadIdx.x == 0) s_before = before;
  total = block_sum(total, s_buf);
  if (threadIdx.x == 0) s_total = total;

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool flag = mask_at(a, b, i, m);
  const unsigned ballot = __ballot_sync(0xffffffffu, flag);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) s_warp[warp] = __popc(ballot);
  __syncthreads();
  int rank = s_before;
  for (int w = 0; w < warp; ++w) rank += s_warp[w];
  rank += __popc(ballot & ((1u << lane) - 1u));
  if (i < m && order != nullptr) order[i] = rank + (flag ? 1 : 0) - 1;
  if (flag && rank < budget && idx != nullptr) idx[rank] = i;
  if (idx != nullptr) {
    const int stride = gridDim.x * blockDim.x;
    for (int j = (s_total < budget ? s_total : budget) + i; j < budget; j += stride) idx[j] = fill;
  }
  count_launch(ctrl, CTRL_LAUNCHES_COMPACT);
}

static int blocks_of(int m) { return (m + PHASE_THREADS - 1) / PHASE_THREADS; }

extern "C" int compact_count_launch(const uint8_t* a, const uint8_t* b, int m, int32_t* counts,
                                    int32_t* ctrl, void* stream) {
  if (m > 0) {
    compact_count_kernel<<<blocks_of(m), PHASE_THREADS, 0, (cudaStream_t)stream>>>(
        a, b, m, counts, ctrl);
  }
  return (int)cudaGetLastError();
}

extern "C" int compact_launch(const uint8_t* a, const uint8_t* b, int m, const int32_t* counts,
                              int budget, int fill, int32_t* idx, int32_t* order, int32_t* ctrl,
                              void* stream) {
  if (m > 0) {
    compact_kernel<<<blocks_of(m), PHASE_THREADS, 0, (cudaStream_t)stream>>>(
        a, b, m, counts, budget, fill, idx, order, ctrl);
  }
  return (int)cudaGetLastError();
}
