// resolve_compacted: the v3 resolve of a sub-phase on a stream-compacted
// batch of events.
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
// Three entries, in this order:
// - resolve_compacted (the branch), one thread a slot: the lane's (energy,
//   xi, max(ebin, 0) * 32 + mat), its 6-wide row of the event table at the
//   fused (bin, material) index (Compton a, b, Rayleigh a, b, S(E, pi), the
//   next bin's pmax), the branch on the pair-table partials; a Compton slot
//   samples its angle (kTauTable: the tabulated inverse CDF, samplers.cuh
//   sample_icdf_cdt1; else the GCOa rejection, compton_tau_gcoa) and its
//   shell and Doppler energy (compton_shell_energy); the slot's outcome
//   (energy, cos theta, code) goes to three slot arrays, and the Rayleigh
//   slots to a byte mask with their count per block, which compact.cu turns
//   into ranks among the slots;
// - resolve_scatter, one thread a slot: a Rayleigh slot ranked below
//   rayleigh_lanes samples its angle by RITA (samplers.cuh
//   rayleigh_rita_costh; the others stay pending); the slot's outcome is
//   written back to its lane as the JAX engine's staging does, (energy +
//   code * 2e6, cos theta), decoded there (code = rint(enc * 5e-7), energy =
//   enc - code * 2e6: the float32 round trip of the reference, 0.125-0.5 eV),
//   and the lane is finished in the same thread: azimuth, rotation,
//   absorption (photoelectric, or Compton below the energy grid), with kDose
//   the deposit (KERMA: the decoded energy of a photoelectric event, what a
//   Compton event took), ebin, scatter class, pending; a lane that holds no
//   slot is left as it is, which is what the reference's masked step over
//   all lanes does to it;
// - resolve_finish, one thread a lane, after the iteration's last resolve
//   only: the dead lanes per block (the next refill's ordered tail reads
//   them) and the loop's control words (live = any lane alive or holding a
//   record), settled by the last block.
// A slot reads the random words of its lane (philox.cuh), whatever slot it
// takes: the same law as the reference's per-slot draws, another stream.
//
// Bound on the H100: bytes. A slot reads its lane's index and 4 state words
// (16 B), 24 B of the event table, for a Compton slot the shell rows from
// shared memory (staged once a block, ~3.7 KB) and two angle knots, and
// writes 9 B of outcome; the scatter reads those back, the rank of a
// Rayleigh slot and its RITA intervals, and reads and writes the lane's
// direction, energy, ebin, scatter, alive and pending (~30 B). About 1.2 MB
// a sub-phase at 65,536 lanes (22,937 slots, ~19,000 events). The
// arithmetic (a Compton slot's ~14 shells x (rsqrt + exp) per trip, 8
// shell trips at most, 16 tau trips at most without the table) stays
// below the fp32 peak at that rate: like flight_resolve, a slot's dependent
// chain bounds it.
//
// Design: a thread per slot, so only events pay for the samplers and a
// warp's 32 slots are 32 events (the warp diverges only between Compton,
// Rayleigh and photoelectric); the batch's size is static (a grid sized by
// the budget, so the whole iteration is recorded into a CUDA graph), the
// slots past the last event do nothing. -fmad=false and no fast math, as
// the other engine kernels: a slot computes what the plain version computes
// for it, operation for operation.

#include "samplers.cuh"

struct SlotArrays {
  float* energy;   // [c_e] the slot's energy after its event (Compton's new energy)
  float* costh;    // [c_e] cos theta of a Compton slot, else 1
  uint8_t* code;   // [c_e] 0 empty, 1 Compton, 2 Rayleigh wanted, 3 photoelectric
};

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

template <bool kTauTable>
__global__ void __launch_bounds__(PHASE_THREADS)
resolve_branch_kernel(Lanes L, const int32_t* __restrict__ idx_e, int c_e,
                      const float* __restrict__ event_pair, int n_rows,
                      const float* __restrict__ icdf, const float* __restrict__ shells,
                      int shell_len, SlotArrays S, uint8_t* __restrict__ rayleigh,
                      int32_t* __restrict__ rayleigh_count, int32_t* ctrl,
                      const PhaseParams* __restrict__ phase, int angle_row, int shell_row) {
  extern __shared__ float s_shell[];
  __shared__ PhaseParams s_phase;
  __shared__ int s_ctrl[5], s_buf[32];
  for (int j = threadIdx.x; j < shell_len; j += blockDim.x) s_shell[j] = shells[j];
  stage_struct(&s_phase, phase);
  const Ctrl ctrl_in = read_ctrl(ctrl, s_ctrl);  // also orders s_shell and s_phase
  if (!ctrl_in.run) return;
  const PhaseParams& Q = s_phase;
  const int n = Q.n;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  int want_r = 0;
  if (j < c_e) {
    const int lane = idx_e[j];
    float energy = 0.0f, costh = 1.0f;
    uint8_t code = 0;
    if (lane < n) {
      int mat;
      const float* e6 = event_row(L, lane, event_pair, n_rows, Q, mat);
      energy = L.energy[lane];
      const float xi = L.xi[lane];
      const float inv_com = __ldg(e6) + energy * __ldg(e6 + 1);
      const float inv_ray = __ldg(e6 + 2) + energy * __ldg(e6 + 3);
      if (xi < inv_com) {
        code = 1;
        Rng rng = rng_for_lane(ctrl_in.k0, ctrl_in.k1, ctrl_in.iteration, (uint32_t)lane);
        const float* sh = s_shell + mat * Q.s_max;
        const int plane = Q.n_mats * Q.s_max;
        float cdt1;
        if constexpr (kTauTable) {
          const float u0 = u_open(rng, angle_row);
          const float u1 = u_open(rng, angle_row + 1);
          cdt1 = sample_icdf_cdt1(u0, u1, logf(energy), 0, mat, icdf, Q);
          energy = compton_shell_energy(energy, cdt1, sh, plane, Q.s_max, rng, shell_row);
        } else {
          float tau;
          compton_tau_gcoa(energy, __ldg(e6 + 4), sh, plane, Q.s_max, rng, angle_row, tau,
                           cdt1);
          energy = compton_shell_energy_tau(energy, tau, cdt1, sh, plane, Q.s_max, rng,
                                            shell_row);
        }
        costh = 1.0f - cdt1;
      } else if (xi < inv_com + inv_ray) {
        code = 2;
        want_r = 1;
      } else {
        code = 3;
      }
    }
    S.energy[j] = energy;
    S.costh[j] = costh;
    S.code[j] = code;
    rayleigh[j] = (uint8_t)want_r;
  }
  want_r = block_sum(want_r, s_buf);
  if (threadIdx.x == 0) rayleigh_count[blockIdx.x] = want_r;
  count_launch(ctrl, CTRL_LAUNCHES_RESOLVE_COMPACTED);
}

template <bool kDose>
__global__ void __launch_bounds__(PHASE_THREADS)
resolve_scatter_kernel(Lanes L, const int32_t* __restrict__ idx_e, int c_e,
                       const float* __restrict__ event_pair, int n_rows,
                       const float* __restrict__ rita, int rita_plane, SlotArrays S,
                       const int32_t* __restrict__ rayleigh_order, int c_r, int32_t* ctrl,
                       unsigned long long* counters, const PhaseParams* __restrict__ phase,
                       int rita_row, int phi_row, const OptionTables opt) {
  extern __shared__ float s_mdose[];  // kDose: [n_mats][2] of this block
  __shared__ PhaseParams s_phase;
  __shared__ int s_ctrl[5], s_buf[32];
  if constexpr (kDose) {
    for (int k = threadIdx.x; k < opt.dose_len; k += blockDim.x) s_mdose[k] = 0.0f;
  }
  stage_struct(&s_phase, phase);
  const Ctrl ctrl_in = read_ctrl(ctrl, s_ctrl);
  if (!ctrl_in.run) return;
  const PhaseParams& Q = s_phase;
  const int n = Q.n;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  int n_compton = 0, n_rayleigh = 0, n_photo = 0;
  if (j < c_e) {
    const int lane = idx_e[j];
    if (lane < n) {
      int code = S.code[j];
      const float e_slot = S.energy[j];
      float costh = S.costh[j];
      Rng rng = rng_for_lane(ctrl_in.k0, ctrl_in.k1, ctrl_in.iteration, (uint32_t)lane);
      if (code == 2) {
        if (rayleigh_order[j] < c_r) {
          int mat;
          const float* e6 = event_row(L, lane, event_pair, n_rows, Q, mat);
          costh = rayleigh_rita_costh(e_slot, mat, __ldg(e6 + 5), rita, rita_plane, rng,
                                      rita_row);
        } else {  // over the Rayleigh budget: the event stays pending
          code = 0;
          costh = 1.0f;
        }
      }
      // the staging round trip: (energy + code * 2e6) decoded on the lane
      const float enc = e_slot + (float)code * 2.0e6f;
      const int got = (int)rintf(enc * 5.0e-7f);
      const float energy = enc - (float)got * 2.0e6f;
      const bool took_c = got == 1, took_r = got == 2, took_p = got == 3;
      const float energy_before = L.energy[lane];
      if (took_c || took_r) {
        const float phi = u_open(rng, phi_row) * TWO_PI_F;
        float dx = L.dx[lane], dy = L.dy[lane], dz = L.dz[lane];
        rotate_direction(dx, dy, dz, costh, phi);
        L.dx[lane] = dx;
        L.dy[lane] = dy;
        L.dz[lane] = dz;
        const int scatter = L.scatter[lane];
        L.scatter[lane] = scatter == 0 ? (took_c ? 1 : 2) : 3;
      }
      if (took_c || took_r || took_p) L.pending[lane] = 0;
      L.energy[lane] = energy;
      if (took_c) {
        const int new_ebin = ebin_of(energy, Q);
        L.ebin[lane] = new_ebin;
        if (new_ebin < 0) L.alive[lane] = 0;  // below the energy grid: absorbed
      }
      if (took_p) L.alive[lane] = 0;
      if constexpr (kDose) {
        if (took_c || took_p) {
          const float edep = took_p ? energy : energy_before - energy;
          const int m = L.mat_evt[lane];
          atomicAdd(opt.voxel_dose + L.vox[lane], edep);
          atomicAdd(s_mdose + 2 * m, edep);
          atomicAdd(s_mdose + 2 * m + 1, edep * edep);
        }
      }
      n_compton = took_c;
      n_rayleigh = took_r;
      n_photo = took_p;
    }
  }
  n_compton = block_sum(n_compton, s_buf);
  n_rayleigh = block_sum(n_rayleigh, s_buf);
  n_photo = block_sum(n_photo, s_buf);
  if (threadIdx.x == 0) {
    count(counters, COUNT_COMPTON, n_compton);
    count(counters, COUNT_RAYLEIGH, n_rayleigh);
    count(counters, COUNT_PHOTO, n_photo);
  }
  count_launch(ctrl, CTRL_LAUNCHES_RESOLVE_COMPACTED);
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

extern "C" int resolve_compacted_launch(const Lanes* lanes, const int32_t* idx_e, int c_e,
                                        const float* event_pair, int n_rows,
                                        const float* icdf, const float* shells, int shell_len,
                                        float* slot_energy, float* slot_costh,
                                        uint8_t* slot_code, uint8_t* rayleigh,
                                        int32_t* rayleigh_count, int32_t* ctrl,
                                        const PhaseParams* phase, int angle_row, int shell_row,
                                        int tau_table, void* stream) {
  if (c_e > 0) {
    const SlotArrays S = {slot_energy, slot_costh, slot_code};
    const size_t shared = shell_len * sizeof(float);
    if (tau_table) {
      resolve_branch_kernel<true><<<blocks_of(c_e), PHASE_THREADS, shared,
                                    (cudaStream_t)stream>>>(
          *lanes, idx_e, c_e, event_pair, n_rows, icdf, shells, shell_len, S, rayleigh,
          rayleigh_count, ctrl, phase, angle_row, shell_row);
    } else {
      resolve_branch_kernel<false><<<blocks_of(c_e), PHASE_THREADS, shared,
                                     (cudaStream_t)stream>>>(
          *lanes, idx_e, c_e, event_pair, n_rows, icdf, shells, shell_len, S, rayleigh,
          rayleigh_count, ctrl, phase, angle_row, shell_row);
    }
  }
  return (int)cudaGetLastError();
}

extern "C" int resolve_scatter_launch(const Lanes* lanes, const int32_t* idx_e, int c_e,
                                      const float* event_pair, int n_rows, const float* rita,
                                      int rita_plane, float* slot_energy, float* slot_costh,
                                      uint8_t* slot_code, const int32_t* rayleigh_order,
                                      int c_r, int32_t* ctrl, unsigned long long* counters,
                                      const PhaseParams* phase, int rita_row, int phi_row,
                                      const OptionTables* opt, int dose, void* stream) {
  if (c_e > 0) {
    const SlotArrays S = {slot_energy, slot_costh, slot_code};
    if (dose) {
      resolve_scatter_kernel<true><<<blocks_of(c_e), PHASE_THREADS,
                                     opt->dose_len * sizeof(float), (cudaStream_t)stream>>>(
          *lanes, idx_e, c_e, event_pair, n_rows, rita, rita_plane, S, rayleigh_order, c_r,
          ctrl, counters, phase, rita_row, phi_row, *opt);
    } else {
      resolve_scatter_kernel<false><<<blocks_of(c_e), PHASE_THREADS, 0, (cudaStream_t)stream>>>(
          *lanes, idx_e, c_e, event_pair, n_rows, rita, rita_plane, S, rayleigh_order, c_r,
          ctrl, counters, phase, rita_row, phi_row, *opt);
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
