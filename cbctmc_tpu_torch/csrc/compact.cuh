// compact.cuh: an order-preserving single-pass scan of a per-block count
// across the blocks of one launch, by decoupled look-back (Merrill and
// Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back",
// NVIDIA technical report NVR-2016-002), as device functions: the
// compaction of compact.cu, the Rayleigh slots' ranks inside
// resolve_compacted.cu and the doubles' and the events' ranks inside
// tally_compacted.cu call it where they make their mask, so no launch of its
// own sits between a mask and its ranks.
//
// A launch that scans owns a ScanScratch: one 64-bit ticket word and one
// 64-bit flag word per block of the launch, zeroed once when allocated and
// never reset. Every launch on one scratch has the same number of blocks B.
// Each block:
// - takes a ticket from the ticket word (thread 0, one 64-bit atomicAdd):
//   its logical index is ticket % B and the launch's epoch ticket / B. A
//   block scans the data of its logical index, not of blockIdx: a block
//   holds a ticket only once it runs, so the blocks it waits on (lower
//   tickets) are running too, and the look-back never waits on a block that
//   has not been scheduled;
// - publishes its aggregate (flag A), looks back over its predecessors'
//   flags 32 at a time (warp 0: a predecessor's inclusive prefix P ends the
//   walk, an aggregate A is added and the walk goes on, a flag not yet
//   written for this epoch is waited for), then publishes its inclusive
//   prefix (flag P; the first block publishes P at once).
// A flag word is (epoch tag << 34 | state << 32 | value): the tag (30 bits of
// the epoch) makes the flags of the launch before read as not written, so
// neither a CUDA graph replayed many times nor a run of many launches needs
// a reset launch (consecutive epochs differ in their tag, and every launch
// on the scratch that runs writes all B flags, so a stale flag is at least
// one epoch old). Every block takes its ticket whether or not the launch
// then runs (the engine's loop may have ended: the block returns after the
// ticket), so the tickets stay a multiple of B; the ticket's atomic and the
// control word's read are in flight together. Values are int32 counts: a
// scan holds up to 2^31 - 1 true entries.

#pragma once

#include "engine.cuh"

struct ScanScratch {
  unsigned long long* words;  // [1 + B]: the ticket, then one flag a block
};

#define SCAN_STATE_AGGREGATE 1ull
#define SCAN_STATE_PREFIX 2ull

struct ScanTicket {
  int logical;    // the block's logical index in [0, B)
  uint32_t tag;   // the launch's epoch tag (30 bits)
};

// Thread 0: take this block's ticket (B = gridDim.x)
__device__ __forceinline__ ScanTicket scan_ticket(ScanScratch s) {
  const unsigned long long t = atomicAdd(s.words, 1ull);
  const unsigned long long blocks = gridDim.x;
  const unsigned long long epoch = t / blocks;
  ScanTicket k;
  k.logical = (int)(t - epoch * blocks);
  k.tag = (uint32_t)(epoch & 0x3fffffffull);
  return k;
}

__device__ __forceinline__ void scan_publish(ScanScratch s, int logical, uint32_t tag,
                                             unsigned long long state, int value) {
  const unsigned long long word =
      ((unsigned long long)tag << 34) | (state << 32) | (unsigned long long)(uint32_t)value;
  atomicExch(s.words + 1 + logical, word);
}

// One thread of the block: publish the block's `aggregate` (the first
// block: its inclusive prefix, the same number). A block publishes it as
// soon as it has it, and looks back later, when it needs its prefix.
__device__ __forceinline__ void scan_publish_aggregate(ScanScratch s, ScanTicket k,
                                                       int aggregate) {
  scan_publish(s, k.logical, k.tag, k.logical == 0 ? SCAN_STATE_PREFIX : SCAN_STATE_AGGREGATE,
               aggregate);
}

// Warp 0 of the block (all 32 threads), after scan_publish_aggregate: the
// block's exclusive prefix by the look-back, in every thread of warp 0; it
// then publishes its inclusive prefix. A block that needs no prefix (it
// holds no true entry, and writes nothing past the total) may skip it: its
// aggregate stands for it, and the blocks after it walk on past. The walk
// reads SCAN_WINDOW predecessors at a time (4 flags a thread, all loads in
// flight together): a block that looks back while its predecessors have
// published only their aggregates walks back to the first block, a window's
// round trip through L2 each SCAN_WINDOW blocks.
#define SCAN_WINDOW 128

__device__ __forceinline__ int scan_lookback(ScanScratch s, ScanTicket k, int aggregate) {
  constexpr int kPer = SCAN_WINDOW / 32;
  const int lane = threadIdx.x & 31;
  if (k.logical == 0) return 0;
  const unsigned full = 0xffffffffu;
  int exclusive = 0;
  for (int base = k.logical - 1;; base -= SCAN_WINDOW) {
    // predecessor q * 32 + lane of the window is block base - q * 32 - lane
    int value[kPer];
    int first;  // the window's nearest prefix (SCAN_WINDOW: none)
    for (;;) {
      unsigned long long state[kPer];
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int p = base - q * 32 - lane;
        state[q] = SCAN_STATE_PREFIX;  // before the first block: a prefix of 0
        value[q] = 0;
        if (p >= 0) {
          const unsigned long long w = *((volatile unsigned long long*)(s.words + 1 + p));
          state[q] = (uint32_t)(w >> 34) == k.tag ? (w >> 32) & 3ull : 0ull;
          value[q] = (int)(uint32_t)w;
        }
      }
      first = SCAN_WINDOW;
      bool wait = false;
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const unsigned prefixes = __ballot_sync(full, state[q] == SCAN_STATE_PREFIX);
        const unsigned missing = __ballot_sync(full, state[q] == 0ull);
        if (first == SCAN_WINDOW) {
          // the flags up to and including the nearest prefix must be there
          const int in_q = prefixes ? __ffs(prefixes) - 1 : 31;
          wait = wait || (missing & ((2u << in_q) - 1u));  // 2u << 31 is 0: all 32
          if (prefixes) first = q * 32 + in_q;
        }
      }
      if (!wait) break;
      __nanosleep(64);
    }
    int v = 0;
#pragma unroll
    for (int q = 0; q < kPer; ++q) v += q * 32 + lane <= first ? value[q] : 0;
    exclusive += (int)__reduce_add_sync(full, (unsigned)v);
    if (first < SCAN_WINDOW) break;
  }
  if (lane == 0) scan_publish(s, k.logical, k.tag, SCAN_STATE_PREFIX, exclusive + aggregate);
  return exclusive;
}

// Every thread of the block (PHASE_THREADS of them): the number of threads
// below it whose `flag` is set (its rank within the block); `total` gets the
// block's count. `s_warp` holds PHASE_THREADS / 32 words of shared memory.
__device__ __forceinline__ int block_rank(bool flag, int* s_warp, int& total) {
  const unsigned ballot = __ballot_sync(0xffffffffu, flag);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // s_warp may still be read from a previous call
  if (lane == 0) s_warp[warp] = __popc(ballot);
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < PHASE_THREADS / 32; ++w) {
    const int c = s_warp[w];
    before += w < warp ? c : 0;
    total += c;
  }
  return before + __popc(ballot & ((1u << lane) - 1u));
}
