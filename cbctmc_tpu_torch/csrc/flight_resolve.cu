// flight_resolve: one Woodcock flight of every active lane followed, in the
// same launch and with the lane's state still in registers, by the in-place
// resolve of every pending real event (Compton / Rayleigh from the tabulated
// angle inverse CDFs, photoelectric absorption).
//
// Replaces: the flight and `resolve_inplace` stages of the JAX engine's loop
// body (cbctmc_tpu/engine/transport.py run_projection: flight,
// resolve_inplace; samplers.py sample_icdf_rows_cdt1,
// compton_scatter_rows_tab, rotate_direction; tables.py
// eval_sigma_partials). The flight's planned TPU kernel is
// cbctmc_tpu/engine/pallas_kernels.py::_flight_kernel; the two knot reads of
// the angle sampler are the per-lane gather of ::_gather_kernel, here two
// __ldg in the sampler's body instead of launches of their own. This kernel
// is the card's redesign of flight_step.cu + gather_probe.cu + the some
// thousand eager operations that ran between them.
//
// The launch that ends an outer iteration also carries the tally (the
// JAX loop body's tally stage and the while_loop's condition, tally.cu as a
// kernel of its own): the lane's escape record is scored from the registers
// the flight just left it in, and the launch's last block settles the
// control words of the loop.
//
// Bound on the H100: bytes. An alive lane reads its 21 state words, one
// 32-byte sector of the voxel volume and, when it resolves a scattering, two
// of the angle table, and writes its state back: ~170 B per lane, ~10 MB per
// launch at 65,536 lanes; a tallying launch adds the flags of the dead lanes
// and one 4-byte atomic per record. Random numbers cost no bytes (Philox
// words made in registers, philox.cuh: one call for the flight, one to
// seven for a resolving lane). The arithmetic (6 Clenshaw recurrences of 23
// steps, three Horner sums, ~14 transcendentals, for a Compton lane 14
// shells x (rsqrt + exp) and up to 8 rejection trips) stays below the fp32
// peak at that rate; at this width the kernel is bound by the latency of one
// lane's dependent chain.
//
// Design: one thread per lane; the lane is loaded once, flown (flight.cuh),
// resolved (samplers.cuh), tallied when the iteration ends (flight.cuh
// tally_lane) and stored once. The sigma coefficient rows (~7 KB), the shell
// table (~3.7 KB) and the two parameter structs sit in shared memory; the
// angle table (~720 KB) and the volume are read through the read-only cache
// and live in L2. Only lanes with a pending event enter the resolve and only
// Compton lanes the shell loop, so warps diverge there: a warp pays for its
// slowest lane (14 shells + up to 8 trips), while the plain version pays
// that for every lane. Every block reads the control words as the previous
// launch left them (the adoption guard remaining >= n_lanes; CTRL_RUN = 0
// ends the launch at once); adoptions are summed per block and the block
// that finishes last takes them off the budget. Counters go out as one
// atomic per block and slot. Each block also leaves its count of refillable
// lanes for the refill kernel's ordered tail. With the tally, a lane that
// was dead at entry is read only where it holds a record, and then only the
// record's fields (flight.cuh tally_stored_lane);
// records and tallied energy (float64) are summed per block, each block ORs
// whether it holds a live lane or a waiting record, and the last block
// writes the live word, the iteration number and CTRL_RUN after the budget:
// the loop condition never leaves the device.
//
// The engine's v4 options (the JAX engine's EngineConfig) are compile-time
// parameters of the kernel, the launch picks the instantiation, and the
// production one (all false) is the code it was:
// - kTableSigma (sigma_mode "table"): the flight's total inverse MFP is one
//   float2 __ldg of the ~4 MB fused (energy bin, material) pair table
//   (flight.cuh) in place of the three Chebyshev channels; the resolve
//   still branches on the Chebyshev partials, as the JAX engine's does;
// - kRita (rayleigh_mode "rita"): a Rayleigh lane samples its angle by RITA
//   with Thomson rejection (samplers.cuh rayleigh_rita_costh: bisection over
//   the material's 128-point p row, the interval's values by __ldg, up to 12
//   trips of 3 uniforms from the rows after the azimuth's) with pmax of the
//   next energy bin, instead of the Rayleigh inverse CDF; Compton keeps its
//   tabulated angle;
// - kDose (tally_dose): each photoelectric and Compton deposit (KERMA: the
//   photon's energy, or what the Compton event took from it) goes into
//   voxel_dose by one atomicAdd, and into the block's per-material sums of
//   energy and energy squared in shared memory (all lanes hit some 22
//   addresses, so lane-wise global atomics would serialise); the block adds
//   each non-zero sum to material_dose with one atomicAdd. Float32 sums, in
//   an order that changes from run to run.

#include "flight.cuh"
#include "samplers.cuh"

template <bool kTableSigma, bool kRita, bool kDose>
__global__ void __launch_bounds__(PHASE_THREADS)
flight_resolve_kernel(Lanes L, Candidates C, int flight_row, int resolve_row, int with_tally,
                      const uint32_t* __restrict__ packed,
                      const float* __restrict__ coeffs, int coeff_len,
                      const float* __restrict__ icdf, const float* __restrict__ shells,
                      int shell_len, float* __restrict__ image, int32_t* ctrl,
                      unsigned long long* counters, double* energy_sum, int32_t* block_dead,
                      const Params* __restrict__ params,
                      const PhaseParams* __restrict__ phase, const OptionTables opt) {
  extern __shared__ float s_tab[];
  __shared__ Params s_params;
  __shared__ PhaseParams s_phase;
  __shared__ int s_ctrl[5], s_buf[32];
  __shared__ double s_dbuf[32];
  float* s_coeff = s_tab;
  float* s_shell = s_tab + coeff_len;
  float* s_mdose = s_shell + shell_len;  // kDose: [n_mats][2] of this block
  for (int j = threadIdx.x; j < coeff_len; j += blockDim.x) s_coeff[j] = coeffs[j];
  for (int j = threadIdx.x; j < shell_len; j += blockDim.x) s_shell[j] = shells[j];
  if constexpr (kDose) {
    for (int j = threadIdx.x; j < opt.dose_len; j += blockDim.x) s_mdose[j] = 0.0f;
  }
  stage_struct(&s_params, params);
  stage_struct(&s_phase, phase);
  const Ctrl ctrl_in = read_ctrl(ctrl, s_ctrl);  // also orders the tables
  if (!ctrl_in.run) return;
  const Params& P = s_params;
  const PhaseParams& Q = s_phase;

  const int n = P.n;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int adopted = 0, was_active = 0, n_compton = 0, n_rayleigh = 0, n_photo = 0;
  int refillable = 0, tallied = 0, live = 0;
  double tallied_energy = 0.0;
  if (i < n) {
    if (!L.alive[i]) {
      // a dead lane is left alone unless it holds a record to tally
      const bool escaped = L.escaped[i];
      refillable = with_tally || !escaped;
      if (with_tally) {
        float val;
        bool waits;
        if (tally_stored_lane(L, i, image, P, val, waits)) {
          tallied = 1;
          tallied_energy = (double)val;
        }
        live = waits;
      }
    } else {
      LaneRegs s = load_lane(L, i);
      Rng rng = rng_for_lane(ctrl_in.k0, ctrl_in.k1, ctrl_in.iteration, (uint32_t)i);
      if (!s.pending) {
        was_active = 1;
        const float u_step = u_open(rng, flight_row);
        const float u_int = u_open(rng, flight_row + 1);
        adopted = flight_lane<kTableSigma>(s, C, i, u_step, u_int, packed, s_coeff,
                                           ctrl_in.remaining >= n, P, opt.pair, opt.n_pair);
      }
      if (resolve_row >= 0 && s.alive && s.pending) {
        const float energy = s.energy;
        const float log_e = logf(energy);
        const int mat = s.mat_evt < 0 ? 0 : (s.mat_evt < P.n_mats ? s.mat_evt : P.n_mats - 1);
        const float* row = s_coeff + mat * (3 * P.cheb_d + 6);
        const float sa = sigma_arg(log_e, P);
        const float inv_com = sigma_channel(row, P.cheb_d, 0, sa);
        const float inv_ray = sigma_channel(row, P.cheb_d, 1, sa);
        const bool want_c = s.xi < inv_com;
        const bool want_r = !want_c && s.xi < inv_com + inv_ray;
        if (want_c || want_r) {
          float cdt1 = 0.0f, costh;
          if (kRita && want_r) {
            // pmax of the next energy bin, the bin clipped into the grid
            const int pb = s.ebin + 1 < 0 ? 0 : (s.ebin + 1 > Q.n_bins - 1 ? Q.n_bins - 1
                                                                          : s.ebin + 1);
            int pi = pb * Q.n_mats + mat;
            pi = pi < 0 ? 0 : (pi > opt.n_pmax - 1 ? opt.n_pmax - 1 : pi);
            costh = rayleigh_rita_costh(energy, mat, __ldg(opt.pmax + pi), opt.rita,
                                        opt.rita_plane, rng, resolve_row + RESOLVE_ROWS);
          } else {
            const float u0 = u_open(rng, resolve_row);
            const float u1 = u_open(rng, resolve_row + 1);
            cdt1 = sample_icdf_cdt1(u0, u1, log_e, want_r ? Q.n_icdf_rows : 0, mat, icdf, Q);
            costh = 1.0f - cdt1;
          }
          if (want_c) {
            n_compton = 1;
            s.energy = compton_shell_energy(energy, cdt1, s_shell + mat * Q.s_max,
                                            Q.n_mats * Q.s_max, Q.s_max, rng,
                                            resolve_row + 2);
            s.ebin = ebin_of(s.energy, Q);
            if (s.ebin < 0) s.alive = false;  // below the energy grid: absorbed
            if constexpr (kDose) {
              const float edep = energy - s.energy;
              atomicAdd(opt.voxel_dose + s.vox, edep);
              atomicAdd(s_mdose + 2 * mat, edep);
              atomicAdd(s_mdose + 2 * mat + 1, edep * edep);
            }
          } else {
            n_rayleigh = 1;
          }
          const float phi = u_open(rng, resolve_row + RESOLVE_ROWS - 1) * TWO_PI_F;
          rotate_direction(s.dx, s.dy, s.dz, costh, phi);
          s.scatter = s.scatter == 0 ? (want_c ? 1 : 2) : 3;
        } else {
          n_photo = 1;
          s.alive = false;
          if constexpr (kDose) {
            atomicAdd(opt.voxel_dose + s.vox, energy);
            atomicAdd(s_mdose + 2 * mat, energy);
            atomicAdd(s_mdose + 2 * mat + 1, energy * energy);
          }
        }
        s.pending = false;
      }
      if (with_tally) {
        float val;
        bool waits;
        if (tally_lane(s, image, P, val, waits)) {
          tallied = 1;
          tallied_energy = (double)val;
        }
        live = s.alive || waits;
      }
      store_lane(L, i, s);
      refillable = !s.alive && (with_tally || !s.escaped);
    }
  }

  adopted = block_sum(adopted, s_buf);
  was_active = block_sum(was_active, s_buf);
  n_compton = block_sum(n_compton, s_buf);
  n_rayleigh = block_sum(n_rayleigh, s_buf);
  n_photo = block_sum(n_photo, s_buf);
  refillable = block_sum(refillable, s_buf);
  if (with_tally) {
    tallied = block_sum(tallied, s_buf);
    live = block_sum(live, s_buf);
    tallied_energy = block_sum(tallied_energy, s_dbuf);
  }
  if (threadIdx.x == 0) {
    block_dead[blockIdx.x] = refillable;
    count(counters, COUNT_ADOPTIONS, adopted);
    count(counters, COUNT_ACTIVE, was_active);
    count(counters, COUNT_COMPTON, n_compton);
    count(counters, COUNT_RAYLEIGH, n_rayleigh);
    count(counters, COUNT_PHOTO, n_photo);
    count(counters, COUNT_TALLIED, tallied);
    if (tallied) atomicAdd(energy_sum, tallied_energy);
    settle_launch(ctrl, adopted, CTRL_LAUNCHES_FLIGHT_RESOLVE, with_tally != 0, live);
  }
  if constexpr (kDose) {
    __syncthreads();  // every lane's deposit is in s_mdose
    for (int j = threadIdx.x; j < opt.dose_len; j += blockDim.x) {
      const float v = s_mdose[j];
      if (v != 0.0f) atomicAdd(opt.material_dose + j, v);
    }
  }
}

template <bool kTableSigma, bool kRita, bool kDose>
static void launch_variant(int blocks, size_t shared, cudaStream_t stream, const Lanes& lanes,
                           const Candidates& cands, int flight_row, int resolve_row,
                           int with_tally, const uint32_t* packed, const float* coeffs,
                           int coeff_len, const float* icdf, const float* shells,
                           int shell_len, float* image, int32_t* ctrl,
                           unsigned long long* counters, double* energy_sum,
                           int32_t* block_dead, const Params* params,
                           const PhaseParams* phase, const OptionTables& opt) {
  flight_resolve_kernel<kTableSigma, kRita, kDose><<<blocks, PHASE_THREADS, shared, stream>>>(
      lanes, cands, flight_row, resolve_row, with_tally, packed, coeffs, coeff_len, icdf,
      shells, shell_len, image, ctrl, counters, energy_sum, block_dead, params, phase, opt);
}

extern "C" int flight_resolve_launch(const Lanes* lanes, const Candidates* cands,
                                     int flight_row, int resolve_row, int with_tally,
                                     const uint32_t* packed, const float* coeffs,
                                     int coeff_len, const float* icdf, const float* shells,
                                     int shell_len, int n, float* image, int32_t* ctrl,
                                     unsigned long long* counters, double* energy_sum,
                                     int32_t* block_dead, const Params* params,
                                     const PhaseParams* phase, const OptionTables* opt,
                                     int variant, void* stream) {
  // variant: bit 0 sigma_mode "table", bit 1 rayleigh_mode "rita", bit 2 tally_dose
  if (n > 0) {
    const int blocks = (n + PHASE_THREADS - 1) / PHASE_THREADS;
    const size_t shared =
        (coeff_len + shell_len + ((variant & 4) ? opt->dose_len : 0)) * sizeof(float);
#define FLIGHT_RESOLVE_VARIANT(T, R, D)                                                  \
  launch_variant<T, R, D>(blocks, shared, (cudaStream_t)stream, *lanes, *cands, flight_row, \
                          resolve_row, with_tally, packed, coeffs, coeff_len, icdf, shells,  \
                          shell_len, image, ctrl, counters, energy_sum, block_dead, params,  \
                          phase, *opt)
    switch (variant & 7) {
      case 0: FLIGHT_RESOLVE_VARIANT(false, false, false); break;
      case 1: FLIGHT_RESOLVE_VARIANT(true, false, false); break;
      case 2: FLIGHT_RESOLVE_VARIANT(false, true, false); break;
      case 3: FLIGHT_RESOLVE_VARIANT(true, true, false); break;
      case 4: FLIGHT_RESOLVE_VARIANT(false, false, true); break;
      case 5: FLIGHT_RESOLVE_VARIANT(true, false, true); break;
      case 6: FLIGHT_RESOLVE_VARIANT(false, true, true); break;
      default: FLIGHT_RESOLVE_VARIANT(true, true, true); break;
    }
#undef FLIGHT_RESOLVE_VARIANT
  }
  return (int)cudaGetLastError();
}
