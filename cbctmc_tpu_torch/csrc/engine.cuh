// engine.cuh: what every kernel of the transport engine shares: the lane
// state and parameter structs (mirrored field by field by the ctypes
// structures of cbctmc_tpu_torch/engine/kernels.py), a lane's registers,
// block reductions, the control words of an engine call and the last-block
// epilogue that keeps them consistent across the blocks of one launch: the
// history budget, the iteration number (the counter word of philox.cuh) and
// the loop condition, which lives on the device so that a fixed sequence of
// launches (a CUDA graph) can run past the end of the loop and change
// nothing.
//
// All engine kernels are built without --use_fast_math and with -fmad=false:
// each product and sum rounds on its own, as the separate PyTorch operations
// of the plain versions do, so a kernel and its plain version agree lane for
// lane.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "philox.cuh"

#define MAX_POLY 16
#define MAX_SHELLS 32
#define PHASE_THREADS 256

#define EPS_SOURCE 1.5e-5f
#define TALLY_MIN_COS 0.025f
#define BIG 1.0e30f

struct Lanes {
  float *px, *py, *pz, *dx, *dy, *dz, *energy;
  int32_t *ebin, *scatter;
  uint8_t *alive, *pending, *escaped;
  int32_t *k_air, *k_soft, *vox, *mat_evt;
  float *xi;
  int32_t *stash_idx;
  float *stash_energy;
  uint8_t *stash_valid, *cand_free;
};

struct Candidates {
  float *px, *py, *pz, *dx, *dy, *dz, *energy;
  int32_t *ebin;
};

// scene, majorant and detector constants of the flight and the tally
struct Params {
  int n, nx, ny, nz, n_voxels, npix_x, npix_z, n_mats, cheb_d, poly_len;
  int air_skip, soft_skip;
  float wc_poly[MAX_POLY], air_poly[MAX_POLY], soft_poly[MAX_POLY];
  float log_e_lo, inv_log_range, inv_air_den, voxmin, den_scale;
  float nonair_lo[3], nonair_hi[3], bbox_hi[3], voxel_size[3];
  float sigma_log_lo, sigma_range;
  float sdir[3], det_center[3], rot0[3], rot2[3];
  float corner_x, corner_z, inv_pix_x, inv_pix_z;
};

// the tables and tallies of the engine's v4 options (transport.py
// EngineConfig), read only by the flight_resolve instantiations that turn
// each on: sigma_mode "table" (pair), rayleigh_mode "rita" (pmax, rita) and
// tally_dose (voxel_dose, material_dose); null / 0 where an option is off
struct OptionTables {
  const float2* pair;     // [n_pair] (a, b): inv_mfp = a + E * b at ebin * n_mats + mat
  const float* pmax;      // [n_pmax] RITA pmax at ebin * n_mats + mat
  const float* rita;      // [4][rita_plane] x, p, a, b; rita_plane = n_mats * 128
  float* voxel_dose;      // [n_voxels] eV
  float* material_dose;   // [dose_len / 2][2] eV, eV^2
  int n_pair, n_pmax, rita_plane, dose_len;
};

// source, spectrum and interaction-sampler constants
struct PhaseParams {
  int n, n_spec_bins, n_bins, n_ie, k_knots, n_icdf_rows, n_mats, s_max;
  float src_pos[3], rot_fan[9];
  float cos_theta_low, d_cos_theta, phi_low, d_phi, max_height;
  float bbox[3];
  float e0, ide, icdf_log_lo, icdf_scale;
};

// the control words (int32) of one engine call (transport.py CTRL_*)
enum {
  CTRL_REMAINING = 0,   // history budget
  CTRL_LIVE = 1,        // after a tally: any lane alive or holding a record
  CTRL_TICKET = 2,      // blocks of the running launch that have finished
  CTRL_DECREMENT = 3,   // histories the running launch has started so far
  CTRL_LIVE_ACC = 4,    // the running tally's OR of its blocks' live flags
  CTRL_ITERATION = 5,   // outer iterations finished: the Philox counter word
  CTRL_RUN = 6,         // 1 while the next iteration is to run
  CTRL_DRAIN = 7,       // the call runs until no lane is alive (set by the host)
  CTRL_MAX_ITERATIONS = 8,  // set by the host
  CTRL_KEY0 = 9,        // the call's Philox key (set by the host)
  CTRL_KEY1 = 10,
  CTRL_LAUNCHES_REFILL = 11,  // launches that did work, counted per kernel
  CTRL_LAUNCHES_FLIGHT_RESOLVE = 12,
  CTRL_LAUNCHES_TALLY = 13,
  CTRL_LAUNCHES_COMPACT = 14,  // the v3 kernels (compact.cu, tally_compacted.cu,
  CTRL_LAUNCHES_TALLY_COMPACTED = 15,  // resolve_compacted.cu)
  CTRL_LAUNCHES_RESOLVE_COMPACTED = 16
};

// the 10-slot counters (the JAX engine's layout)
enum {
  COUNT_TALLIED = 0, COUNT_COMPTON = 2, COUNT_RAYLEIGH = 3, COUNT_PHOTO = 4,
  COUNT_REFILLS = 5, COUNT_ADOPTIONS = 6, COUNT_ACTIVE = 7
};

// one lane's state in registers
struct LaneRegs {
  float px, py, pz, dx, dy, dz, energy, xi, stash_energy;
  int ebin, scatter, k_air, k_soft, vox, mat_evt, stash_idx;
  bool alive, pending, escaped, stash_valid, cand_free;
};

__device__ __forceinline__ LaneRegs load_lane(const Lanes& L, int i) {
  LaneRegs s;
  s.px = L.px[i]; s.py = L.py[i]; s.pz = L.pz[i];
  s.dx = L.dx[i]; s.dy = L.dy[i]; s.dz = L.dz[i];
  s.energy = L.energy[i]; s.xi = L.xi[i]; s.stash_energy = L.stash_energy[i];
  s.ebin = L.ebin[i]; s.scatter = L.scatter[i];
  s.k_air = L.k_air[i]; s.k_soft = L.k_soft[i];
  s.vox = L.vox[i]; s.mat_evt = L.mat_evt[i]; s.stash_idx = L.stash_idx[i];
  s.alive = L.alive[i]; s.pending = L.pending[i]; s.escaped = L.escaped[i];
  s.stash_valid = L.stash_valid[i]; s.cand_free = L.cand_free[i];
  return s;
}

__device__ __forceinline__ void store_lane(const Lanes& L, int i, const LaneRegs& s) {
  L.px[i] = s.px; L.py[i] = s.py; L.pz[i] = s.pz;
  L.dx[i] = s.dx; L.dy[i] = s.dy; L.dz[i] = s.dz;
  L.energy[i] = s.energy; L.xi[i] = s.xi; L.stash_energy[i] = s.stash_energy;
  L.ebin[i] = s.ebin; L.scatter[i] = s.scatter;
  L.k_air[i] = s.k_air; L.k_soft[i] = s.k_soft;
  L.vox[i] = s.vox; L.mat_evt[i] = s.mat_evt; L.stash_idx[i] = s.stash_idx;
  L.alive[i] = s.alive; L.pending[i] = s.pending; L.escaped[i] = s.escaped;
  L.stash_valid[i] = s.stash_valid; L.cand_free[i] = s.cand_free;
}

// sum of `v` over the block, valid in thread 0 (blockDim.x a multiple of 32,
// at most 1024; `s_buf` holds 32 words and may be reused after the call)
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* s_buf) {
  const unsigned full = 0xffffffffu;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(full, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // s_buf may still be read from a previous call
  if (lane == 0) s_buf[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (blockDim.x >> 5) ? s_buf[lane] : (T)0;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(full, v, off);
  }
  return v;
}

// Called by thread 0 of every block after its atomics on the launch's
// accumulators: true in the block that finishes last, which then sees every
// other block's contribution and may fold the accumulators into the control
// words (every block read those at its start, so none can see the update).
__device__ __forceinline__ bool last_block_done(int32_t* ctrl) {
  __threadfence();
  const int ticket = atomicAdd(ctrl + CTRL_TICKET, 1);
  if (ticket != (int)gridDim.x - 1) return false;
  __threadfence();
  ctrl[CTRL_TICKET] = 0;
  return true;
}

// The control words as every block of this launch sees them: the values
// its predecessors left (read before any block can finish, and no word read
// here changes before the last block has finished).
struct Ctrl {
  int remaining, run;
  uint32_t iteration, k0, k1;
};

__device__ __forceinline__ Ctrl read_ctrl(const int32_t* ctrl, int* s_words) {
  if (threadIdx.x == 0) {
    const volatile int32_t* c = ctrl;
    s_words[0] = c[CTRL_REMAINING];
    s_words[1] = c[CTRL_RUN];
    s_words[2] = c[CTRL_ITERATION];
    s_words[3] = c[CTRL_KEY0];
    s_words[4] = c[CTRL_KEY1];
  }
  __syncthreads();
  Ctrl v;
  v.remaining = s_words[0];
  v.run = s_words[1];
  v.iteration = (uint32_t)s_words[2];
  v.k0 = (uint32_t)s_words[3];
  v.k1 = (uint32_t)s_words[4];
  return v;
}

// copy a parameter struct from device memory into shared memory (the
// per-view source and detector change between engine calls while the
// launches recorded in a graph keep their arguments, so the structs are read
// through a pointer); the caller synchronises before reading `dst`
template <typename T>
__device__ __forceinline__ void stage_struct(T* dst, const T* src) {
  static_assert(sizeof(T) % 4 == 0, "parameter structs are made of 32-bit words");
  const uint32_t* from = reinterpret_cast<const uint32_t*>(src);
  uint32_t* to = reinterpret_cast<uint32_t*>(dst);
  for (int j = threadIdx.x; j < (int)(sizeof(T) / 4); j += blockDim.x) to[j] = from[j];
}

// Thread 0 of every block, after its atomics on the launch's accumulators:
// add this block's started histories to the launch's decrement; the block
// that finishes last takes the sum off the budget and counts the launch.
// A launch that carries the tally (`ends_iteration`, with `live` = this
// block holds a live lane or a record that waits) also settles, in this
// order after the budget, the live word, the iteration number and whether
// the next iteration is to run.
__device__ __forceinline__ void settle_launch(int32_t* ctrl, int started, int launch_word,
                                              bool ends_iteration, int live) {
  if (started) atomicAdd(ctrl + CTRL_DECREMENT, started);
  if (ends_iteration && live) atomicOr(ctrl + CTRL_LIVE_ACC, 1);
  if (!last_block_done(ctrl)) return;
  const int remaining = ctrl[CTRL_REMAINING] - atomicExch(ctrl + CTRL_DECREMENT, 0);
  ctrl[CTRL_REMAINING] = remaining;
  ctrl[launch_word] += 1;
  if (ends_iteration) {
    const int any_live = atomicExch(ctrl + CTRL_LIVE_ACC, 0);
    const int iteration = ctrl[CTRL_ITERATION] + 1;
    ctrl[CTRL_LIVE] = any_live;
    ctrl[CTRL_ITERATION] = iteration;
    ctrl[CTRL_RUN] = iteration < ctrl[CTRL_MAX_ITERATIONS] &&
                     (remaining > 0 || (any_live && ctrl[CTRL_DRAIN]));
  }
}

// A launch that settles nothing counts itself in `launch_word` from block 0
// (after read_ctrl found the loop running; no other block of the launch
// touches the word).
__device__ __forceinline__ void count_launch(int32_t* ctrl, int launch_word) {
  if (ctrl != nullptr && blockIdx.x == 0 && threadIdx.x == 0) ctrl[launch_word] += 1;
}

__device__ __forceinline__ void count(unsigned long long* counters, int slot, int v) {
  if (v) atomicAdd(counters + slot, (unsigned long long)v);
}
