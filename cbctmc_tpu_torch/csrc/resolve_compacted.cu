// resolve_compacted: the v3 resolve of a sub-phase on a stream-compacted
// batch of events, the branch, the samplers, the Rayleigh slots' ranks and
// the write-back in one launch.
//
// Replaces: _resolve of the JAX engine's v3 body
// (cbctmc_tpu/engine/transport.py :1280-1467, resolve_inplace=False) and the
// analytic Compton sampler it calls with tau_table=False
// (cbctmc_tpu/engine/samplers.py compton_scatter_rows: the 16-trip GCOa tau
// rejection). No Pallas counterpart: on the TPU it is XLA's compaction
// scatters, the packed lane-state gather, the 6-wide event-table gather,
// the one-hot MXU shell fetch, the masked samplers and the [n, 2] staging
// scatter. Plain version: transport.resolve_compacted_reference.
//
// The events arrive compacted by compact.cu: idx_e[j] is the lane of slot j
// (n in empty slots), the first event_lanes pending lanes in lane order;
// the others stay pending, their photons waiting at the interaction site.
// Two entries:
// - resolve_compacted, a tile of RESOLVE_TILE threads per slot: the lane's
//   (energy, xi, max(ebin, 0) * 32 + mat), its 6-wide row of the event table
//   at the fused (bin, material) index (Compton a, b, Rayleigh a, b,
//   S(E, pi), the next bin's pmax), the branch on the pair-table partials;
//   the Rayleigh slots ranked among the slots by the single-pass scan of
//   compact.cuh (the block's ballots, warp 0's look-back over the blocks
//   before it, while the other warps sample); a Compton slot samples its
//   angle (kTauTable: the tabulated inverse CDF, samplers.cuh
//   sample_icdf_cdt1; else the GCOa rejection) and its shell and Doppler
//   energy by samplers_tile.cuh (the shell terms spread over the tile, the
//   trips G at a time); a Rayleigh slot ranked below rayleigh_lanes samples
//   its angle by RITA (samplers_tile.cuh: each trip's knot count spread over
//   the tile; the others stay pending); then the tile's first thread writes
//   the slot's outcome back to its lane as the JAX engine's staging does,
//   (energy + code * 2e6, cos theta), decoded there (code = rint(enc *
//   5e-7), energy = enc - code * 2e6: the float32 round trip of the
//   reference, 0.125-0.5 eV), and finishes the lane: azimuth, rotation,
//   absorption (photoelectric, or Compton below the energy grid), with kDose
//   the deposit (KERMA: the decoded energy of a photoelectric event, what a
//   Compton event took) and the block's per-material sums, ebin, scatter
//   class, pending; a lane that holds no slot is left as it is, which is
//   what the reference's masked step over all lanes does to it; a block
//   whose first slot is empty leaves at once (the events fill the first
//   slots, so its slots and every later block's are empty);
// - resolve_finish, one thread a lane, after the iteration's last resolve
//   only (it reads every lane after every slot has finished): the dead lanes
//   per block (the next refill's ordered tail reads them) and the loop's
//   control words (live = any lane alive or holding a record), settled by
//   the last block.
// A slot reads the random words of its lane (philox.cuh), whatever slot it
// takes: the same law as the reference's per-slot draws, another stream.
//
// Bound on the H100: bytes. A slot reads its lane's index and 4 state words
// (16 B), 24 B of the event table, for a Compton slot the shell rows from
// shared memory (staged once a block, ~3.7 KB) and two angle knots, for a
// Rayleigh slot its RITA row, and reads and writes the lane's
// direction, energy, ebin, scatter, alive and pending (~30 B): ~1.2 MB a
// sub-phase at 65,536 lanes (22,937 slots, ~13,000 events), 0.35 us. What
// held the first design (a thread per slot, branch and scatter two
// launches around a compact launch of the Rayleigh slots) at ~59x that:
// - a Compton slot's chain of dependent transcendentals: ~14 shells x
//   (rsqrt + exp) walked in order twice, up to 8 shell trips, with the GCOa
//   up to 16 tau trips each summing every shell, with a warp waiting for its
//   slowest lane and cum[] / rn[] on a 256 B stack;
// - 90 blocks of 256 on 132 SMs, the events in the first ~50: at most one
//   block an SM, too few warps to hide that chain;
// - a Rayleigh slot's bisection of its RITA row, 7 dependent reads a trip;
// - three launches a sub-phase.
// The tile spreads a slot's chain over G threads (its shell terms, G trips
// at a time, the RITA interval search), which also makes the grid G times
// wider (359 blocks of 256 at G = 4, 717 at G = 8; the blocks past the
// events leave at once); the scan and the write-back join the branch in one
// launch. G = 4 measured faster than 8 on the CatPhan state
// (scripts/compare_engine_phases.py --variants). Photoelectric,
// Rayleigh and empty slots skip the Compton samplers as a whole tile.
// -fmad=false and no fast math, as the other engine kernels: a slot computes
// what the plain version computes for it, operation for operation
// (samplers_tile.cuh: same words, same choice).

#include "compact.cuh"
#include "samplers_tile.cuh"

// threads a slot: a power of two, at most 8 (the scan scratch the wrapper
// allocates holds the blocks of a grid at 8); 4 measured faster than 8
#define RESOLVE_TILE 4
#define RESOLVE_SLOTS (PHASE_THREADS / RESOLVE_TILE)  // slots a block

// the slot's fused event-table row (clipped into the table, as XLA clamps a
// gather's index) and material, from its lane's packed (ebin, material)
__device__ __forceinline__ const float* event_row(const Lanes& L, int lane,
                                                  const float* __restrict__ event_pair,
                                                  int n_rows, const PhaseParams& Q, int& mat) {
  const int eb = L.ebin[lane];
  const int em = (eb < 0 ? 0 : eb) * 32 + L.mat_evt[lane];
  const int ebin_e = em >> 5;
  mat = em & 31;
  int row = (ebin_e < 0 ? 0 : (ebin_e > Q.n_bins - 1 ? Q.n_bins - 1 : ebin_e)) * Q.n_mats + mat;
  row = row < 0 ? 0 : (row > n_rows - 1 ? n_rows - 1 : row);
  return event_pair + 6 * row;
}

// slot outcomes before the write-back: 0 empty, 1 Compton, 2 Rayleigh
// wanted, 3 photoelectric
template <bool kTauTable, bool kDose>
__global__ void __launch_bounds__(PHASE_THREADS)
resolve_compacted_kernel(Lanes L, const int32_t* __restrict__ idx_e, int c_e,
                         const float* __restrict__ event_pair, int n_rows,
                         const float* __restrict__ icdf, const float* __restrict__ shells,
                         int shell_len, const float* __restrict__ rita, int rita_plane,
                         ScanScratch scan, int c_r, int32_t* ctrl,
                         unsigned long long* counters, const PhaseParams* __restrict__ phase,
                         int angle_row, int shell_row, int rita_row, int phi_row,
                         const OptionTables opt) {
  extern __shared__ float s_dyn[];  // the shell table; kDose: then [n_mats][2] of this block
  __shared__ float s_cum[RESOLVE_SLOTS][MAX_SHELLS], s_rn[RESOLVE_SLOTS][MAX_SHELLS];
  __shared__ PhaseParams s_phase;
  __shared__ int s_ctrl[5], s_buf[32], s_warp[PHASE_THREADS / 32], s_logical, s_before;
  __shared__ uint32_t s_tag;
  if (threadIdx.x == 0) {  // taken whether or not the loop runs (compact.cuh)
    const ScanTicket k = scan_ticket(scan);
    s_logical = k.logical;
    s_tag = k.tag;
  }
  float* s_shell = s_dyn;
  float* s_mdose = s_dyn + shell_len;
  for (int k = threadIdx.x; k < shell_len; k += blockDim.x) s_shell[k] = shells[k];
  if constexpr (kDose) {
    for (int k = threadIdx.x; k < opt.dose_len; k += blockDim.x) s_mdose[k] = 0.0f;
  }
  stage_struct(&s_phase, phase);
  const Ctrl ctrl_in = read_ctrl(ctrl, s_ctrl);  // also orders the ticket and the tables
  if (!ctrl_in.run) return;  // every block of the launch agrees
  count_launch(ctrl, CTRL_LAUNCHES_RESOLVE_COMPACTED);  // before a block leaves for want of events
  const ScanTicket ticket = {s_logical, s_tag};
  const Tile<RESOLVE_TILE> tile;
  const bool leader = tile.rank == 0;
  const PhaseParams& Q = s_phase;
  const int n = Q.n;
  const int j0 = ticket.logical * RESOLVE_SLOTS;
  const int slot = threadIdx.x / RESOLVE_TILE;
  const int j = j0 + slot;
  const int lane = j < c_e ? idx_e[j] : n;  // n: an empty slot
  // the events fill the first slots: a block whose first slot is empty, and
  // every block after it, holds none (nobody reads its ranks)
  if (j0 >= c_e || idx_e[j0] >= n) return;

  // the branch (every thread of the tile alike); the tile's first thread
  // also reads what its write-back will need
  int code = 0, mat = 0, scatter = 0;
  float energy = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  const float* e6 = event_pair;
  if (lane < n) {
    e6 = event_row(L, lane, event_pair, n_rows, Q, mat);
    energy = L.energy[lane];
    const float xi = L.xi[lane];
    if (leader) {
      dx = L.dx[lane];
      dy = L.dy[lane];
      dz = L.dz[lane];
      scatter = L.scatter[lane];
    }
    const float inv_com = __ldg(e6) + energy * __ldg(e6 + 1);
    const float inv_ray = __ldg(e6 + 2) + energy * __ldg(e6 + 3);
    code = xi < inv_com ? 1 : (xi < inv_com + inv_ray ? 2 : 3);
  }
  // the Rayleigh slots' ranks: the block's by ballots of the tiles' first
  // threads, published at once; its prefix by warp 0's look-back once warp
  // 0 has sampled (its predecessors' aggregates are out by then), while the
  // other warps sample; a block without a Rayleigh slot needs none
  int block_rayleigh;
  const int rank_in_block = block_rank(leader && code == 2, s_warp, block_rayleigh);
  if (threadIdx.x == 0) scan_publish_aggregate(scan, ticket, block_rayleigh);

  const float energy_before = energy;
  float costh = 1.0f;
  Rng rng = rng_for_lane(ctrl_in.k0, ctrl_in.k1, ctrl_in.iteration, (uint32_t)lane);
  if (code == 1) {  // Compton, by the whole tile
    const float* sh = s_shell + mat * Q.s_max;
    const int plane = Q.n_mats * Q.s_max;
    float cdt1;
    if constexpr (kTauTable) {
      const float u0 = u_open(rng, angle_row);
      const float u1 = u_open(rng, angle_row + 1);
      cdt1 = sample_icdf_cdt1(u0, u1, logf(energy), 0, mat, icdf, Q);
      energy = compton_shell_energy_tile(tile, energy, cdt1, sh, plane, Q.s_max, rng,
                                         shell_row, s_cum[slot], s_rn[slot]);
    } else {
      float tau;
      compton_tau_gcoa_tile(tile, energy, __ldg(e6 + 4), sh, plane, Q.s_max, rng, angle_row,
                            tau, cdt1);
      energy = compton_shell_energy_tau_tile(tile, energy, tau, cdt1, sh, plane, Q.s_max, rng,
                                             shell_row, s_cum[slot], s_rn[slot]);
    }
    costh = 1.0f - cdt1;
  }
  if (threadIdx.x < 32 && block_rayleigh > 0) {
    const int before = scan_lookback(scan, ticket, block_rayleigh);
    if (threadIdx.x == 0) s_before = before;
  }
  __syncthreads();  // s_before is the block's prefix

  if (code == 2) {  // Rayleigh, by the whole tile: its rank is the tile leader's
    if (s_before + tile.shfl(rank_in_block, 0) < c_r) {
      costh = rayleigh_rita_costh_tile(tile, energy, mat, __ldg(e6 + 5), rita, rita_plane, rng,
                                       rita_row);
    } else {  // over the Rayleigh budget: the event stays pending
      code = 0;
    }
  }
  int took = 0;
  if (leader && lane < n) {
    // the staging round trip: (energy + code * 2e6) decoded on the lane
    const float enc = energy + (float)code * 2.0e6f;
    const int got = (int)rintf(enc * 5.0e-7f);
    const float e_new = enc - (float)got * 2.0e6f;
    const bool took_c = got == 1, took_r = got == 2, took_p = got == 3;
    if (took_c || took_r) {
      const float phi = u_open(rng, phi_row) * TWO_PI_F;
      rotate_direction(dx, dy, dz, costh, phi);
      L.dx[lane] = dx;
      L.dy[lane] = dy;
      L.dz[lane] = dz;
      L.scatter[lane] = scatter == 0 ? (took_c ? 1 : 2) : 3;
    }
    if (took_c || took_r || took_p) L.pending[lane] = 0;
    L.energy[lane] = e_new;
    if (took_c) {
      const int new_ebin = ebin_of(e_new, Q);
      L.ebin[lane] = new_ebin;
      if (new_ebin < 0) L.alive[lane] = 0;  // below the energy grid: absorbed
    }
    if (took_p) L.alive[lane] = 0;
    if constexpr (kDose) {
      if (took_c || took_p) {
        const float edep = took_p ? e_new : energy_before - e_new;
        const int m = L.mat_evt[lane];
        atomicAdd(opt.voxel_dose + L.vox[lane], edep);
        atomicAdd(s_mdose + 2 * m, edep);
        atomicAdd(s_mdose + 2 * m + 1, edep * edep);
      }
    }
    // the three counts of the block in one sum: each is at most
    // RESOLVE_SLOTS (< 256), a byte each
    took = (took_c ? 1 : 0) | (took_r ? 1 << 8 : 0) | (took_p ? 1 << 16 : 0);
  }
  took = block_sum(took, s_buf);
  if (threadIdx.x == 0) {
    count(counters, COUNT_COMPTON, took & 255);
    count(counters, COUNT_RAYLEIGH, (took >> 8) & 255);
    count(counters, COUNT_PHOTO, took >> 16);
  }
  if constexpr (kDose) {
    __syncthreads();  // every slot's deposit is in s_mdose
    for (int k = threadIdx.x; k < opt.dose_len; k += blockDim.x) {
      const float v = s_mdose[k];
      if (v != 0.0f) atomicAdd(opt.material_dose + k, v);
    }
  }
}

__global__ void __launch_bounds__(PHASE_THREADS)
resolve_finish_kernel(Lanes L, int n, int32_t* ctrl, int32_t* block_dead) {
  __shared__ int s_ctrl[5], s_buf[32];
  const Ctrl ctrl_in = read_ctrl(ctrl, s_ctrl);
  if (!ctrl_in.run) return;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int dead = 0, live = 0;
  if (i < n) {
    const bool alive = L.alive[i];
    dead = !alive;
    live = alive || L.stash_valid[i];
  }
  dead = block_sum(dead, s_buf);
  live = block_sum(live, s_buf);
  if (threadIdx.x == 0) {
    block_dead[blockIdx.x] = dead;
    settle_launch(ctrl, 0, CTRL_LAUNCHES_RESOLVE_COMPACTED, true, live);
  }
}

static int blocks_of(int n) { return (n + PHASE_THREADS - 1) / PHASE_THREADS; }

template <bool kTauTable, bool kDose>
static void launch_resolve(int blocks, size_t shared, cudaStream_t stream, const Lanes& L,
                           const int32_t* idx_e, int c_e, const float* event_pair, int n_rows,
                           const float* icdf, const float* shells, int shell_len,
                           const float* rita, int rita_plane, ScanScratch scan, int c_r,
                           int32_t* ctrl, unsigned long long* counters,
                           const PhaseParams* phase, int angle_row, int shell_row,
                           int rita_row, int phi_row, const OptionTables& opt) {
  resolve_compacted_kernel<kTauTable, kDose><<<blocks, PHASE_THREADS, shared, stream>>>(
      L, idx_e, c_e, event_pair, n_rows, icdf, shells, shell_len, rita, rita_plane, scan, c_r,
      ctrl, counters, phase, angle_row, shell_row, rita_row, phi_row, opt);
}

// `scan` holds at least 1 + the grid's blocks words (`scan_len`; the grid is
// c_e / RESOLVE_SLOTS blocks, rounded up), and every launch on it has the
// same grid
extern "C" int resolve_compacted_launch(const Lanes* lanes, const int32_t* idx_e, int c_e,
                                        const float* event_pair, int n_rows,
                                        const float* icdf, const float* shells, int shell_len,
                                        const float* rita, int rita_plane,
                                        unsigned long long* scan, long long scan_len, int c_r,
                                        int32_t* ctrl, unsigned long long* counters,
                                        const PhaseParams* phase, int angle_row, int shell_row,
                                        int rita_row, int phi_row, const OptionTables* opt,
                                        int tau_table, int dose, void* stream) {
  const int blocks = (c_e + RESOLVE_SLOTS - 1) / RESOLVE_SLOTS;
  if (c_e < 0 || c_r < 0 || (c_e > 0 && scan_len < 1 + (long long)blocks)) {
    return (int)cudaErrorInvalidValue;
  }
  if (c_e > 0) {
    const size_t shared = (shell_len + (dose ? opt->dose_len : 0)) * sizeof(float);
    const cudaStream_t s = (cudaStream_t)stream;
    const ScanScratch sc{scan};
    if (tau_table && !dose) {
      launch_resolve<true, false>(blocks, shared, s, *lanes, idx_e, c_e, event_pair, n_rows,
                                  icdf, shells, shell_len, rita, rita_plane, sc, c_r, ctrl,
                                  counters, phase, angle_row, shell_row, rita_row, phi_row,
                                  *opt);
    } else if (tau_table) {
      launch_resolve<true, true>(blocks, shared, s, *lanes, idx_e, c_e, event_pair, n_rows,
                                 icdf, shells, shell_len, rita, rita_plane, sc, c_r, ctrl,
                                 counters, phase, angle_row, shell_row, rita_row, phi_row,
                                 *opt);
    } else if (!dose) {
      launch_resolve<false, false>(blocks, shared, s, *lanes, idx_e, c_e, event_pair, n_rows,
                                   icdf, shells, shell_len, rita, rita_plane, sc, c_r, ctrl,
                                   counters, phase, angle_row, shell_row, rita_row, phi_row,
                                   *opt);
    } else {
      launch_resolve<false, true>(blocks, shared, s, *lanes, idx_e, c_e, event_pair, n_rows,
                                  icdf, shells, shell_len, rita, rita_plane, sc, c_r, ctrl,
                                  counters, phase, angle_row, shell_row, rita_row, phi_row,
                                  *opt);
    }
  }
  return (int)cudaGetLastError();
}

extern "C" int resolve_finish_launch(const Lanes* lanes, int n, int32_t* ctrl,
                                     int32_t* block_dead, void* stream) {
  if (n > 0) {
    resolve_finish_kernel<<<blocks_of(n), PHASE_THREADS, 0, (cudaStream_t)stream>>>(
        *lanes, n, ctrl, block_dead);
  }
  return (int)cudaGetLastError();
}
