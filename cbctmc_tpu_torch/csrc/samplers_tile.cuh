// samplers_tile.cuh: the Compton and RITA samplers of samplers.cuh for a
// tile of G threads (a power of two, at most 32, inside one warp) that
// share one event: the per-shell terms spread over the tile and the
// rejection trips taken G at a time. resolve_compacted.cu runs them (a tile
// per event slot); flight_resolve keeps samplers.cuh's one-thread forms.
//
// Same words, same choice, same result as the one-thread forms, bit for bit:
// - the shell terms rn[k] = profile_cdf(shell_pzomc(...)) and f[k] * rn[k]
//   are computed by thread k % G, each exactly as the one-thread form does;
//   the running sum cum[k] is the same left fold in shell order (acc = w0,
//   then + w1, ...), each term handed round the tile by a shuffle;
// - the rejection trips are independent given their counter-addressed
//   Philox rows (philox.cuh: a word is a function of lane, row and
//   iteration), so thread g evaluates trip round * G + g whole, exactly as
//   the one-thread loop's body does, and a ballot takes the lowest trip that
//   accepts (or, after the last round, the last trip's proposal, by the
//   one-thread form's own rule); a round runs only if the ones before
//   accepted nothing. Only which words are computed changes (a round may
//   evaluate trips past the accepted one), not which are used.
// A trip's shell search reads the tile's cum / rn rows, which the tile
// keeps in shared memory (`s_cum`, `s_rn`: MAX_SHELLS floats each): each
// thread of a round searches for its own trip's target, so the search is
// the thread's own walk, as in the one-thread form.
// The RITA sampler of a Rayleigh slot keeps its trips one after another
// (they mostly accept at once) and spreads each trip's interval search over
// the tile instead: the count of the material's knots at or below the
// proposal, which the one-thread form finds by a bisection of 7 dependent
// reads, is G strided counts of independent reads summed by shuffles (the
// JAX sampler's own compare-count; the row is non-decreasing, so both give
// the same index).

#pragma once

#include "samplers.cuh"

template <int G>
struct Tile {
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "a tile is a power of two <= 32");
  unsigned mask;  // the tile's lanes in the warp
  int base;       // its first lane
  int rank;       // this thread's rank in the tile
  __device__ __forceinline__ Tile() {
    const int lane = threadIdx.x & 31;
    base = lane & ~(G - 1);
    rank = lane & (G - 1);
    mask = (G == 32 ? 0xffffffffu : ((1u << G) - 1u)) << base;
  }
  // bit g set where thread g of the tile passes `p`
  __device__ __forceinline__ unsigned ballot(bool p) const {
    return __ballot_sync(mask, p) >> base;
  }
  __device__ __forceinline__ float shfl(float v, int src) const {
    return __shfl_sync(mask, v, src, G);
  }
  __device__ __forceinline__ int shfl(int v, int src) const {
    return __shfl_sync(mask, v, src, G);
  }
  __device__ __forceinline__ int sum(int v) const {
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) v += __shfl_xor_sync(mask, v, off, G);
    return v;
  }
  __device__ __forceinline__ void sync() const { __syncwarp(mask); }
};

// compton_shell_energy_tau by a tile (every thread gets the result)
template <int G>
__device__ __forceinline__ float compton_shell_energy_tau_tile(
    const Tile<G>& tile, float energy, float tau, float cdt1, const float* sh, int plane,
    int s_max, Rng& rng, int row, float* s_cum, float* s_rn) {
  constexpr int kPer = (MAX_SHELLS + G - 1) / G;
  const float* sh_f = sh;
  const float* sh_ui = sh + plane;
  const float* sh_j0 = sh + 2 * plane;
  const float costh = 1.0f - cdt1;
  const int g = tile.rank;

  float w[kPer];
  int n_open = 0;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int k = q * G + g;
    w[q] = 0.0f;
    if (k < s_max) {
      const bool open = sh_ui[k] < energy;
      const float ui = open ? sh_ui[k] : 0.0f;
      const float r = profile_cdf(shell_pzomc(energy, ui, sh_j0[k], cdt1));
      w[q] = open ? sh_f[k] * r : 0.0f;
      s_rn[k] = r;
      n_open += open ? 1 : 0;
    }
  }
  float acc = 0.0f;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
#pragma unroll
    for (int src = 0; src < G; ++src) {
      const int k = q * G + src;
      if (k < s_max) {  // the same in every thread of the tile
        const float wk = tile.shfl(w[q], src);
        acc = k == 0 ? wk : acc + wk;
        if (g == src) s_cum[k] = acc;
      }
    }
  }
  n_open = tile.sum(n_open);
  tile.sync();  // s_cum and s_rn are written
  const float s_tot = acc;
  const int last_open = n_open > 0 ? n_open - 1 : 0;

  const float xqc = 1.0f + tau * (tau - 2.0f * costh);
  const float xq = fmaxf(xqc, 1e-30f);
  const float af = xqc > 1.0e-20f ? sqrtf(xq) * (tau * (tau - costh) / xq + 1.0f) : 0.002f;
  const float fpzmax = af > 0.0f ? 1.0f + af * 0.2f : 1.0f - af * 0.2f;

  float pzomc = 0.0f;
  for (int first = 0; first < COMPTON_SHELL_TRIPS; first += G) {
    const int trip = first + g;
    float pz_prop = 0.0f;
    bool physical = false, accept = false;
    if (trip < COMPTON_SHELL_TRIPS) {
      const float u1 = u_open(rng, row + 3 * trip);
      const float u2 = u_open(rng, row + 3 * trip + 1);
      const float u3 = u_open(rng, row + 3 * trip + 2);
      const float target = s_tot * u1;
      // first open shell whose cumulative f*rn exceeds target; default last
      int idx = last_open;
      for (int k = 0; k < s_max; ++k) {
        if (s_cum[k] > target && sh_ui[k] < energy) {
          idx = k;
          break;
        }
      }
      const float j0_i = sh_j0[idx];
      const float t = fminf(fmaxf(u2 * s_rn[idx], 1e-12f), (float)(1.0 - 1e-7));
      pz_prop = t < 0.5f ? (SQRT_HALF - sqrtf(0.5f - logf(t + t))) / (j0_i * SQRT_TWO)
                         : (sqrtf(0.5f - logf(2.0f - 2.0f * t)) - SQRT_HALF) / (j0_i * SQRT_TWO);
      physical = pz_prop >= -1.0f;
      // F(E') rejection
      const float fpz = 1.0f + af * fminf(fmaxf(pz_prop, -0.2f), 0.2f);
      accept = physical && (u3 * fpzmax <= fpz);
    }
    const unsigned accepted = tile.ballot(accept);
    if (accepted) {
      pzomc = tile.shfl(pz_prop, __ffs(accepted) - 1);
      break;
    }
    if (first + G >= COMPTON_SHELL_TRIPS) {  // none accepted: the last trip, if physical
      const int last = COMPTON_SHELL_TRIPS - 1 - first;
      const float pz_last = tile.shfl(pz_prop, last);
      if (tile.ballot(physical) & (1u << last)) pzomc = pz_last;
    }
  }

  const float t = pzomc * pzomc;
  const float b1 = 1.0f - t * tau * tau;
  const float b2 = 1.0f - t * tau * costh;
  float root = sqrtf(fabsf(b2 * b2 - b1 * (1.0f - t)));
  root = pzomc < 0.0f ? -root : root;
  const float factor = fminf((tau / b1) * (b2 + root), 1.0f);
  return energy * factor;
}

// compton_shell_energy (tau from the tabulated angle) by a tile
template <int G>
__device__ __forceinline__ float compton_shell_energy_tile(
    const Tile<G>& tile, float energy, float cdt1, const float* sh, int plane, int s_max,
    Rng& rng, int row, float* s_cum, float* s_rn) {
  const float ek = energy * INV_MEC2;
  const float tau = 1.0f / (1.0f + ek * cdt1);
  return compton_shell_energy_tau_tile(tile, energy, tau, cdt1, sh, plane, s_max, rng, row,
                                       s_cum, s_rn);
}

// compton_tau_gcoa by a tile: thread g evaluates trip round * G + g, each
// trip's sum over the material's shells its own, in shell order, as the
// one-thread form writes it (every thread gets tau, cdt1 and the result)
template <int G>
__device__ __forceinline__ bool compton_tau_gcoa_tile(const Tile<G>& tile, float energy,
                                                      float s0, const float* sh, int plane,
                                                      int s_max, Rng& rng, int row,
                                                      float& tau, float& cdt1) {
  const float* sh_f = sh;
  const float* sh_ui = sh + plane;
  const float* sh_j0 = sh + 2 * plane;
  const float ek = energy * INV_MEC2;
  const float ek2 = ek * 2.0f + 1.0f;
  const float ek3 = ek * ek;
  const float ek1 = ek3 - ek2 - 1.0f;
  const float taumin = 1.0f / ek2;
  const float a1 = logf(ek2);
  const float a2 = a1 + 2.0f * ek * (ek + 1.0f) * taumin * taumin;
  tau = 1.0f;
  cdt1 = 1.0f;
  for (int first = 0; first < COMPTON_TAU_TRIPS; first += G) {
    const int trip = first + tile.rank;
    float tau_prop = 1.0f, cdt1_prop = 1.0f;
    bool accept = false;
    if (trip < COMPTON_TAU_TRIPS) {
      const float u1 = u_open(rng, row + 3 * trip);
      const float u2 = u_open(rng, row + 3 * trip + 1);
      const float u3 = u_open(rng, row + 3 * trip + 2);
      tau_prop = u1 * a2 < a1 ? (float)pow((double)taumin, (double)u2)
                              : sqrtf(1.0f + u2 * (taumin * taumin - 1.0f));
      // the JAX sampler's cap float32(1.99999999), which is 2.0
      cdt1_prop = fminf((1.0f - tau_prop) / (tau_prop * ek), 2.0f);
      float s_prop = 0.0f;
      for (int k = 0; k < s_max; ++k) {
        const bool open = sh_ui[k] < energy;
        const float ui = open ? sh_ui[k] : 0.0f;
        const float w = (open ? sh_f[k] : 0.0f) *
                        profile_cdf(shell_pzomc(energy, ui, sh_j0[k], cdt1_prop));
        s_prop = k == 0 ? w : s_prop + w;
      }
      const float t_kn =
          s_prop * (1.0f + tau_prop * (ek1 + tau_prop * (ek2 + tau_prop * ek3))) /
          (ek3 * tau_prop * (tau_prop * tau_prop + 1.0f));
      accept = u3 * s0 <= t_kn;
    }
    const unsigned accepted = tile.ballot(accept);
    if (accepted || first + G >= COMPTON_TAU_TRIPS) {
      // the lowest trip that accepted, else the last trip's proposal
      const int src = accepted ? __ffs(accepted) - 1 : COMPTON_TAU_TRIPS - 1 - first;
      tau = tile.shfl(tau_prop, src);
      cdt1 = tile.shfl(cdt1_prop, src);
      return accepted != 0;
    }
  }
  return false;
}

// rayleigh_rita_costh by a tile: each trip's knot count over the tile, the
// rest as the one-thread form computes it (every thread gets the result)
template <int G>
__device__ __forceinline__ float rayleigh_rita_costh_tile(const Tile<G>& tile, float energy,
                                                          int mat, float pmax,
                                                          const float* __restrict__ rita,
                                                          int plane, Rng& rng, int row) {
  const float* xr = rita + mat * NP_RAYLEIGH;
  const float* pr = xr + plane;
  const float* ar = pr + plane;
  const float* br = ar + plane;
  const float xmax = energy * RAYLEIGH_X_FACTOR_F;
  const float x2max = fminf(xmax * xmax, __ldg(xr + NP_RAYLEIGH - 1));
  const bool small = xmax < 0.01f;
  float costh = 1.0f;
  for (int trip = 0; trip < RAYLEIGH_TRIPS; ++trip) {
    const float u1 = u_open(rng, row + 3 * trip);
    const float u2 = u_open(rng, row + 3 * trip + 1);
    const float u3 = u_open(rng, row + 3 * trip + 2);
    float prop;
    bool accept;
    if (small) {
      prop = 1.0f - 2.0f * u1;
      accept = u2 <= (prop * prop + 1.0f) * 0.5f;
    } else {
      const float ru = u1 * pmax;
      int lo = 0;  // #{k : p[k] <= ru}
#pragma unroll
      for (int k = tile.rank; k < NP_RAYLEIGH; k += G) lo += __ldg(pr + k) <= ru ? 1 : 0;
      lo = tile.sum(lo);
      const int idx = lo - 1 < 0 ? 0 : (lo - 1 > NP_RAYLEIGH - 2 ? NP_RAYLEIGH - 2 : lo - 1);
      const float p_i = __ldg(pr + idx);
      const float x_i = __ldg(xr + idx);
      const float rr = ru - p_i;
      float xx = x_i;
      if (rr > 1e-16f) {
        const float p_n = __ldg(pr + idx + 1), x_n = __ldg(xr + idx + 1);
        const float a_i = __ldg(ar + idx), b_i = __ldg(br + idx);
        const float d = p_n - p_i;
        xx = x_i + (a_i + 1.0f + b_i) * d * rr / (d * d + (a_i * d + b_i * rr) * rr) *
                       (x_n - x_i);
      }
      prop = 1.0f - 2.0f * xx / fmaxf(x2max, 1e-30f);
      accept = xx < x2max && u3 <= (prop * prop + 1.0f) * 0.5f;
    }
    if (accept || trip == RAYLEIGH_TRIPS - 1) {
      costh = fminf(fmaxf(prop, -1.0f), 1.0f);
      break;
    }
  }
  return costh;
}
