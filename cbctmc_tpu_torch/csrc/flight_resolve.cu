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
// Bound on the H100: bytes. An alive lane reads its 21 state words and 2 to
// 29 rows of the random block (8 B each: 2 for the flight, 2 angle + 1
// azimuth + up to 24 shell uniforms for a resolving lane), one 32-byte
// sector of the voxel volume and two of the angle table, and writes its
// state back: ~250 B per lane, ~16 MB per launch at 65,536 lanes. The
// arithmetic (6 Clenshaw recurrences of 23 steps, three Horner sums, ~14
// transcendentals, for a Compton lane 14 shells x (rsqrt + exp) and up to 8
// rejection trips) stays below the fp32 peak at that rate; at this width
// the kernel is bound by the latency of one lane's dependent chain.
//
// Design: one thread per lane; the lane is loaded once, flown (flight.cuh),
// resolved (samplers.cuh) and stored once. The sigma coefficient rows
// (~7 KB) and the shell table (~3.7 KB) sit in shared memory; the angle
// table (~720 KB) and the volume are read through the read-only cache and
// live in L2. Only lanes with a pending event enter the resolve and only
// Compton lanes the shell loop, so warps diverge there: a warp pays for its
// slowest lane (14 shells + up to 8 trips), while the plain version pays
// that for every lane. Every block reads the budget as the previous launch
// left it (the adoption guard remaining >= n_lanes); adoptions are summed
// per block and the block that finishes last takes them off the budget.
// Counters go out as one atomic per block and slot. Each block also leaves
// its count of refillable lanes for the refill kernel's ordered tail.

#include "flight.cuh"
#include "samplers.cuh"

__global__ void __launch_bounds__(PHASE_THREADS)
flight_resolve_kernel(Lanes L, Candidates C, const long long* __restrict__ bits,
                      int flight_row, int resolve_row,
                      const uint32_t* __restrict__ packed,
                      const float* __restrict__ coeffs, int coeff_len,
                      const float* __restrict__ icdf, const float* __restrict__ shells,
                      int32_t* ctrl, unsigned long long* counters, int32_t* block_dead,
                      Params P, PhaseParams Q) {
  extern __shared__ float s_tab[];
  __shared__ int s_word, s_buf[32];
  float* s_coeff = s_tab;
  float* s_shell = s_tab + coeff_len;
  const int shell_len = 3 * Q.n_mats * Q.s_max;
  for (int j = threadIdx.x; j < coeff_len; j += blockDim.x) s_coeff[j] = coeffs[j];
  for (int j = threadIdx.x; j < shell_len; j += blockDim.x) s_shell[j] = shells[j];
  const int remaining = read_remaining(ctrl, &s_word);  // also orders the tables

  const int n = P.n;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int adopted = 0, was_active = 0, n_compton = 0, n_rayleigh = 0, n_photo = 0;
  int refillable = 0;
  if (i < n) {
    if (!L.alive[i]) {
      refillable = !L.escaped[i];
    } else {
      LaneRegs s = load_lane(L, i);
      if (!s.pending) {
        was_active = 1;
        adopted = flight_lane(s, C, i, u_open(bits, flight_row, n, i),
                              u_open(bits, flight_row + 1, n, i), packed, s_coeff,
                              remaining >= n, P);
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
          const float cdt1 = sample_icdf_cdt1(
              u_open(bits, resolve_row, n, i), u_open(bits, resolve_row + 1, n, i), log_e,
              want_r ? Q.n_icdf_rows : 0, mat, icdf, Q);
          const float costh = 1.0f - cdt1;
          if (want_c) {
            n_compton = 1;
            s.energy = compton_shell_energy(energy, cdt1, s_shell + mat * Q.s_max,
                                            Q.n_mats * Q.s_max, Q.s_max, bits,
                                            resolve_row + 2, n, i);
            s.ebin = ebin_of(s.energy, Q);
            if (s.ebin < 0) s.alive = false;  // below the energy grid: absorbed
          } else {
            n_rayleigh = 1;
          }
          const float phi = u_open(bits, resolve_row + RESOLVE_ROWS - 1, n, i) * TWO_PI_F;
          rotate_direction(s.dx, s.dy, s.dz, costh, phi);
          s.scatter = s.scatter == 0 ? (want_c ? 1 : 2) : 3;
        } else {
          n_photo = 1;
          s.alive = false;
        }
        s.pending = false;
      }
      store_lane(L, i, s);
      refillable = !s.alive && !s.escaped;
    }
  }

  adopted = block_sum(adopted, s_buf);
  was_active = block_sum(was_active, s_buf);
  n_compton = block_sum(n_compton, s_buf);
  n_rayleigh = block_sum(n_rayleigh, s_buf);
  n_photo = block_sum(n_photo, s_buf);
  refillable = block_sum(refillable, s_buf);
  if (threadIdx.x == 0) {
    block_dead[blockIdx.x] = refillable;
    count(counters, COUNT_ADOPTIONS, adopted);
    count(counters, COUNT_ACTIVE, was_active);
    count(counters, COUNT_COMPTON, n_compton);
    count(counters, COUNT_RAYLEIGH, n_rayleigh);
    count(counters, COUNT_PHOTO, n_photo);
    settle_budget(ctrl, adopted);
  }
}

extern "C" int flight_resolve_launch(const Lanes* lanes, const Candidates* cands,
                                     const long long* bits, int flight_row,
                                     int resolve_row, const uint32_t* packed,
                                     const float* coeffs, int coeff_len, const float* icdf,
                                     const float* shells, int32_t* ctrl,
                                     unsigned long long* counters, int32_t* block_dead,
                                     const Params* params, const PhaseParams* phase,
                                     void* stream) {
  if (phase->s_max > MAX_SHELLS) return (int)cudaErrorInvalidValue;
  if (params->n > 0) {
    const int blocks = (params->n + PHASE_THREADS - 1) / PHASE_THREADS;
    const size_t shared =
        (coeff_len + 3 * phase->n_mats * phase->s_max) * sizeof(float);
    flight_resolve_kernel<<<blocks, PHASE_THREADS, shared, (cudaStream_t)stream>>>(
        *lanes, *cands, bits, flight_row, resolve_row, packed, coeffs, coeff_len, icdf,
        shells, ctrl, counters, block_dead, *params, *phase);
  }
  return (int)cudaGetLastError();
}
