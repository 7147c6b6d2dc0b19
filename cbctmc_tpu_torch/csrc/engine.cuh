// engine.cuh: what every kernel of the transport engine shares: the lane
// state and parameter structs (mirrored field by field by the ctypes
// structures of cbctmc_tpu_torch/engine/kernels.py), a lane's registers,
// the map from raw random bits to uniforms, block reductions, and the
// last-block epilogue that keeps the history budget consistent across the
// blocks of one launch.
//
// All engine kernels are built without --use_fast_math and with -fmad=false:
// each product and sum rounds on its own, as the separate PyTorch operations
// of the plain versions do, so a kernel and its plain version agree lane for
// lane.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

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

// source, spectrum and interaction-sampler constants
struct PhaseParams {
  int n, n_spec_bins, n_bins, n_ie, k_knots, n_icdf_rows, n_mats, s_max;
  float src_pos[3], rot_fan[9];
  float cos_theta_low, d_cos_theta, phi_low, d_phi, max_height;
  float bbox[3];
  float e0, ide, icdf_log_lo, icdf_scale;
};

// the control words (int32) of one engine call
enum {
  CTRL_REMAINING = 0,  // history budget
  CTRL_LIVE = 1,       // after a tally: any lane alive or holding a record
  CTRL_TICKET = 2,     // blocks of the running launch that have finished
  CTRL_DECREMENT = 3,  // histories the running launch has started so far
  CTRL_LIVE_ACC = 4    // the running tally's OR of its blocks' live flags
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

// uniform in the open interval (0, 1) from row `row` of the iteration's
// block of raw draws (int64 in [0, 2^32)): (bits >> 8) * 2^-24 + 2^-25 in
// float32 arithmetic, as the plain version's uniform_from_bits
__device__ __forceinline__ float u_open(const long long* __restrict__ bits, int row,
                                        int n, int i) {
  const long long b = bits[(size_t)row * (size_t)n + i];
  return (float)(int)(b >> 8) * (1.0f / 16777216.0f) + (0.5f / 16777216.0f);
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

// The budget as every block of this launch sees it: the value its
// predecessors left (read before any block can finish).
__device__ __forceinline__ int read_remaining(const int32_t* ctrl, int* s_word) {
  if (threadIdx.x == 0) *s_word = *((volatile const int32_t*)(ctrl + CTRL_REMAINING));
  __syncthreads();
  return *s_word;
}

// Thread 0: add this block's started histories to the launch's decrement;
// the last block takes the sum off the budget.
__device__ __forceinline__ void settle_budget(int32_t* ctrl, int started) {
  if (started) atomicAdd(ctrl + CTRL_DECREMENT, started);
  if (last_block_done(ctrl)) {
    const int total = atomicExch(ctrl + CTRL_DECREMENT, 0);
    ctrl[CTRL_REMAINING] -= total;
  }
}

__device__ __forceinline__ void count(unsigned long long* counters, int slot, int v) {
  if (v) atomicAdd(counters + slot, (unsigned long long)v);
}
