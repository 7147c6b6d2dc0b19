// samplers.cuh: the per-lane source and interaction samplers of the
// transport engine as __device__ functions: counterparts of the JAX
// package's cbctmc_tpu/engine/samplers.py (sample_spectrum_energy_cdf,
// sample_spectrum_energy (Walker alias), sample_source_direction,
// sample_icdf_rows_cdt1, rayleigh_scatter_rows (RITA), compton_scatter_rows
// (the GCOa tau rejection), compton_scatter_rows_tab /
// _shell_doppler_and_energy, rotate_direction) and of
// cbctmc_tpu/engine/transport.py (_move_to_bbox, ebin_of). On the TPU these
// are whole-batch XLA operations with one-hot selects in place of gathers;
// here each is what one thread does for its lane, in the operation order of
// the plain PyTorch versions (cbctmc_tpu_torch/engine/samplers.py), so both
// round alike.
//
// sample_icdf_cdt1 reads its two inverse-CDF knots with __ldg from the flat
// Compton|Rayleigh table in its own body: this is the gather of
// gather_probe.cu without a launch of its own.

#pragma once

#include "engine.cuh"

#define SOURCE_DIR_TRIPS 2
#define COMPTON_TAU_TRIPS 16
#define COMPTON_SHELL_TRIPS 8
#define RAYLEIGH_TRIPS 12
#define NP_RAYLEIGH 128
#define PHOTON_ROWS (2 + 2 * SOURCE_DIR_TRIPS)
#define RESOLVE_ROWS (2 + 3 * COMPTON_SHELL_TRIPS + 1)
#define RAYLEIGH_X_FACTOR_F ((float)8.065535669099010e-5)

#define MEC2 510998.918f                    // electron rest energy [eV]
#define INV_MEC2 ((float)1.956951306108245e-6)
#define SQRT_HALF ((float)0.70710678118654502)
#define SQRT_TWO ((float)1.4142135623731)
#define TWO_PI_F ((float)6.283185307179586)

__device__ __forceinline__ int ebin_of(float energy, const PhaseParams& Q) {
  // trunc((E - e0) * ide) clamped to [-1, n_bins - 1]; clamping the float
  // first gives the same bin and keeps the conversion in range
  float b = (energy - Q.e0) * Q.ide;
  b = fminf(fmaxf(b, -2.0f), (float)Q.n_bins);
  const int k = (int)b;
  return k < -1 ? -1 : (k > Q.n_bins - 1 ? Q.n_bins - 1 : k);
}

// ---- source ---------------------------------------------------------------
// `s_spec` = [inner CDF (nb - 1) | bin low edge (nb) | bin width (nb)]
__device__ __forceinline__ float sample_spectrum_energy(float u0, float u1,
                                                        const float* s_spec, int nb) {
  // b = #{k : cdf_inner[k] <= u0}
  int lo = 0, hi = nb - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_spec[mid] <= u0) lo = mid + 1; else hi = mid;
  }
  return s_spec[nb - 1 + lo] + u1 * s_spec[2 * nb - 1 + lo];
}

// Walker alias (spectrum_mode "alias"): `rows` = [nb][5] (cutoff, bin low
// edge, bin width, the alias bin's low edge, its width), staged in shared
// memory like the CDF table; u0 picks the bin and whether its alias is
// taken, u1 the energy within the bin
__device__ __forceinline__ float sample_spectrum_energy_alias(float u0, float u1,
                                                              const float* rows, int nb) {
  const float rn = u0 * (float)nb;
  int ip = (int)rn;  // u0 in (0, 1): rn in (0, nb)
  ip = ip < 0 ? 0 : (ip > nb - 1 ? nb - 1 : ip);
  const float frac = rn - (float)ip;
  const float* row = rows + 5 * ip;
  const bool use_alias = frac >= row[0];
  const float e_lo = use_alias ? row[3] : row[1];
  const float de = use_alias ? row[4] : row[2];
  return e_lo + u1 * de;
}

// fan-beam direction by the square-field rejection, SOURCE_DIR_TRIPS trips
// from rows row .. row + 2 * SOURCE_DIR_TRIPS - 1; false when none accepted
__device__ __forceinline__ bool sample_source_direction(
    Rng& rng, int row, const PhaseParams& Q, float& ox, float& oy, float& oz) {
  float dx = 0.0f, dy = 1.0f, dz = 0.0f;
  bool accepted = false;
  for (int trip = 0; trip < SOURCE_DIR_TRIPS; ++trip) {
    const float u1 = u_open(rng, row + 2 * trip);
    const float u2 = u_open(rng, row + 2 * trip + 1);
    const float w = Q.cos_theta_low + u1 * Q.d_cos_theta;
    const float phi = Q.phi_low + u2 * Q.d_phi;
    const float sin_theta = sqrtf(fmaxf(1.0f - w * w, 0.0f));
    const float x = sin_theta * cosf(phi);
    const float y = sin_theta * sinf(phi);
    const bool ok = fabsf(w / (y + 1.0e-7f)) <= Q.max_height;
    if (ok && !accepted) {
      dx = x;
      dy = y;
      dz = w;
    }
    accepted = accepted || ok;
  }
  const float* r = Q.rot_fan;
  ox = r[0] * dx + r[1] * dy + r[2] * dz;
  oy = r[3] * dx + r[4] * dy + r[5] * dz;
  oz = r[6] * dx + r[7] * dy + r[8] * dz;
  return accepted;
}

__device__ __forceinline__ float bbox_axis_dist(float p, float d, float size) {
  const float dist_pos = p > 0.0f ? 0.0f : EPS_SOURCE + (-p) / d;
  const float dist_neg = p < size ? 0.0f : EPS_SOURCE + (size - p) / d;
  return d > EPS_SOURCE ? dist_pos : (d < -EPS_SOURCE ? dist_neg : -1.0e9f);
}

// translate a photon from the focal spot onto the bbox surface (slightly
// inside); a ray that misses the box stays at the focal spot
__device__ __forceinline__ void move_to_bbox(float& px, float& py, float& pz, float dx,
                                             float dy, float dz, const float* bbox) {
  float t = fmaxf(fmaxf(bbox_axis_dist(px, dx, bbox[0]), bbox_axis_dist(py, dy, bbox[1])),
                  bbox_axis_dist(pz, dz, bbox[2]));
  t = fmaxf(t, 0.0f);
  const float nx = px + t * dx, ny = py + t * dy, nz = pz + t * dz;
  const bool inside = nx >= 0.0f && nx <= bbox[0] && ny >= 0.0f && ny <= bbox[1] &&
                      nz >= 0.0f && nz <= bbox[2];
  if (inside) {
    px = nx;
    py = ny;
    pz = nz;
  }
}

struct Photon {
  float px, py, pz, dx, dy, dz, energy;
  int ebin;
  bool ok;  // the direction rejection accepted
};

// one source photon from the pool of PHOTON_ROWS rows starting at `pool`;
// `s_spec` is the CDF table, or with kAlias the alias rows
template <bool kAlias = false>
__device__ __forceinline__ Photon sample_photon(Rng& rng, int pool, const float* s_spec,
                                                const PhaseParams& Q) {
  Photon p;
  const float u0 = u_open(rng, pool);
  const float u1 = u_open(rng, pool + 1);
  if constexpr (kAlias) {
    p.energy = sample_spectrum_energy_alias(u0, u1, s_spec, Q.n_spec_bins);
  } else {
    p.energy = sample_spectrum_energy(u0, u1, s_spec, Q.n_spec_bins);
  }
  p.ebin = ebin_of(p.energy, Q);
  p.ok = sample_source_direction(rng, pool + 2, Q, p.dx, p.dy, p.dz);
  p.px = Q.src_pos[0];
  p.py = Q.src_pos[1];
  p.pz = Q.src_pos[2];
  move_to_bbox(p.px, p.py, p.pz, p.dx, p.dy, p.dz, Q.bbox);
  return p;
}

// ---- interactions ---------------------------------------------------------
// 1 - cos(theta) from the tabulated inverse CDF: stochastic interpolation
// between the two bracketing log-energy rows, linear interpolation between
// two equal-probability knots. `first_row` is 0 for Compton, n_icdf_rows for
// Rayleigh in the concatenated table.
__device__ __forceinline__ float sample_icdf_cdt1(float u0, float u1, float log_e,
                                                  int first_row, int mat,
                                                  const float* __restrict__ icdf,
                                                  const PhaseParams& Q) {
  const float top = (float)(Q.n_ie - 1);
  const float pos = fminf(fmaxf((log_e - Q.icdf_log_lo) * Q.icdf_scale, 0.0f), top);
  int j_e = (int)floorf(pos);
  j_e = j_e + (u0 < pos - (float)j_e ? 1 : 0);
  j_e = j_e > Q.n_ie - 1 ? Q.n_ie - 1 : j_e;
  const int row = first_row + j_e * Q.n_mats + mat;
  const int k = Q.k_knots;
  const float sk = u1 * (float)(k - 1);
  const int jk = (int)floorf(sk);
  const float fk = sk - (float)jk;
  const int size = 2 * Q.n_icdf_rows * k;
  int i0 = row * k + jk;
  int i1 = row * k + (jk + 1 > k - 1 ? k - 1 : jk + 1);
  i0 = i0 < 0 ? 0 : (i0 > size - 1 ? size - 1 : i0);
  i1 = i1 < 0 ? 0 : (i1 > size - 1 ? size - 1 : i1);
  const float v0 = __ldg(icdf + i0);
  const float v1 = __ldg(icdf + i1);
  return v0 * (1.0f - fk) + v1 * fk;
}

// maximum projected electron momentum (units of m_e c) transferable to a
// shell with ionisation energy ui at 1 - cos(theta) = cdt1
__device__ __forceinline__ float shell_pzomc(float energy, float ui, float j0, float cdt1) {
  const float aux = energy * (energy - ui) * cdt1;
  const bool safe = (aux > 1.0e-12f) || (ui > 1.0e-12f);
  const float denom = rsqrtf(fmaxf(aux + aux + ui * ui, 1.0e-30f));
  const float pz = j0 * (aux - ui * MEC2) * denom * INV_MEC2;
  return safe ? pz : 0.002f;
}

// the analytic one-electron Compton profile integral n(pz)
__device__ __forceinline__ float profile_cdf(float pz) {
  const float a = pz > 0.0f ? SQRT_HALF + pz * SQRT_TWO : SQRT_HALF - pz * SQRT_TWO;
  const float t = a * a;
  const float val = 0.5f * expf(fminf(0.5f - t, 0.0f));
  return pz > 0.0f ? 1.0f - val : val;
}

// Compton with a pre-sampled angle (tau = E'/E of the unbroadened line and
// cdt1 = 1 - cos(theta)): target shell + Doppler-broadened scattered
// energy. `sh` points at the material's shell rows, laid out
// [3][n_mats][s_max] (f, ui, j0) with `plane` = n_mats * s_max. The shell
// sums run shell by shell, as the plain version's; a lane walks only its
// own material's shells and leaves the rejection loop when it accepts, so
// the warp pays for its slowest lane; it draws (one Philox call per four
// rows) only the trips it takes.
__device__ __forceinline__ float compton_shell_energy_tau(
    float energy, float tau, float cdt1, const float* sh, int plane, int s_max, Rng& rng,
    int row) {
  const float* sh_f = sh;
  const float* sh_ui = sh + plane;
  const float* sh_j0 = sh + 2 * plane;
  const float costh = 1.0f - cdt1;

  float cum[MAX_SHELLS], rn[MAX_SHELLS];
  float acc = 0.0f;
  int n_open = 0;
  for (int k = 0; k < s_max; ++k) {
    const bool open = sh_ui[k] < energy;
    const float ui = open ? sh_ui[k] : 0.0f;
    const float r = profile_cdf(shell_pzomc(energy, ui, sh_j0[k], cdt1));
    const float w = open ? sh_f[k] * r : 0.0f;
    acc = k == 0 ? w : acc + w;
    cum[k] = acc;
    rn[k] = r;
    n_open += open ? 1 : 0;
  }
  const float s_tot = acc;
  const int last_open = n_open > 0 ? n_open - 1 : 0;

  const float xqc = 1.0f + tau * (tau - 2.0f * costh);
  const float xq = fmaxf(xqc, 1e-30f);
  const float af = xqc > 1.0e-20f ? sqrtf(xq) * (tau * (tau - costh) / xq + 1.0f) : 0.002f;
  const float fpzmax = af > 0.0f ? 1.0f + af * 0.2f : 1.0f - af * 0.2f;

  float pzomc = 0.0f;
  for (int trip = 0; trip < COMPTON_SHELL_TRIPS; ++trip) {
    const float u1 = u_open(rng, row + 3 * trip);
    const float u2 = u_open(rng, row + 3 * trip + 1);
    const float u3 = u_open(rng, row + 3 * trip + 2);
    const float target = s_tot * u1;
    // first open shell whose cumulative f*rn exceeds target; default last
    int idx = last_open;
    for (int k = 0; k < s_max; ++k) {
      if (cum[k] > target && sh_ui[k] < energy) {
        idx = k;
        break;
      }
    }
    const float j0_i = sh_j0[idx];
    const float t = fminf(fmaxf(u2 * rn[idx], 1e-12f), (float)(1.0 - 1e-7));
    const float pz_prop =
        t < 0.5f ? (SQRT_HALF - sqrtf(0.5f - logf(t + t))) / (j0_i * SQRT_TWO)
                 : (sqrtf(0.5f - logf(2.0f - 2.0f * t)) - SQRT_HALF) / (j0_i * SQRT_TWO);
    const bool physical = pz_prop >= -1.0f;
    // F(E') rejection
    const float fpz = 1.0f + af * fminf(fmaxf(pz_prop, -0.2f), 0.2f);
    const bool accept = physical && (u3 * fpzmax <= fpz);
    if (accept || (physical && trip == COMPTON_SHELL_TRIPS - 1)) pzomc = pz_prop;
    if (accept) break;
  }

  const float t = pzomc * pzomc;
  const float b1 = 1.0f - t * tau * tau;
  const float b2 = 1.0f - t * tau * costh;
  float root = sqrtf(fabsf(b2 * b2 - b1 * (1.0f - t)));
  root = pzomc < 0.0f ? -root : root;
  const float factor = fminf((tau / b1) * (b2 + root), 1.0f);
  return energy * factor;
}

// the same with tau from the tabulated angle: tau = 1 / (1 + E / mc^2 * cdt1)
__device__ __forceinline__ float compton_shell_energy(
    float energy, float cdt1, const float* sh, int plane, int s_max, Rng& rng, int row) {
  const float ek = energy * INV_MEC2;
  const float tau = 1.0f / (1.0f + ek * cdt1);
  return compton_shell_energy_tau(energy, tau, cdt1, sh, plane, s_max, rng, row);
}

// The Compton angle by PENELOPE-2006's GCOa (engine v3, tau_table=False):
// tau from the Klein-Nishina composition scheme, accepted against
// S(E, theta) / S(E, pi) (s0 = S(E, pi)), the incoherent scattering
// function summed over the material's open shells at each proposal, in at
// most COMPTON_TAU_TRIPS trips of 3 rows from `row`; a lane that accepts no
// trip commits its last proposal (below 1e-5 of the lanes). Sets tau and
// cdt1 = 1 - cos(theta) and returns whether a trip accepted. taumin^u2 is
// taken in double precision and rounded once (the plain version does the
// same, so both agree to the bit; the JAX sampler's float32 power is rounded
// correctly in all but a few lanes in 10^4).
__device__ __forceinline__ bool compton_tau_gcoa(float energy, float s0, const float* sh,
                                                 int plane, int s_max, Rng& rng, int row,
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
  for (int trip = 0; trip < COMPTON_TAU_TRIPS; ++trip) {
    const float u1 = u_open(rng, row + 3 * trip);
    const float u2 = u_open(rng, row + 3 * trip + 1);
    const float u3 = u_open(rng, row + 3 * trip + 2);
    const float tau_prop = u1 * a2 < a1 ? (float)pow((double)taumin, (double)u2)
                                        : sqrtf(1.0f + u2 * (taumin * taumin - 1.0f));
    // the JAX sampler's cap float32(1.99999999), which is 2.0
    const float cdt1_prop = fminf((1.0f - tau_prop) / (tau_prop * ek), 2.0f);
    float s_prop = 0.0f;
    for (int k = 0; k < s_max; ++k) {
      const bool open = sh_ui[k] < energy;
      const float ui = open ? sh_ui[k] : 0.0f;
      const float w =
          (open ? sh_f[k] : 0.0f) * profile_cdf(shell_pzomc(energy, ui, sh_j0[k], cdt1_prop));
      s_prop = k == 0 ? w : s_prop + w;
    }
    const float t_kn = s_prop * (1.0f + tau_prop * (ek1 + tau_prop * (ek2 + tau_prop * ek3))) /
                       (ek3 * tau_prop * (tau_prop * tau_prop + 1.0f));
    const bool accept = u3 * s0 <= t_kn;
    if (accept || trip == COMPTON_TAU_TRIPS - 1) {
      tau = tau_prop;
      cdt1 = cdt1_prop;
      return accept;
    }
  }
  return false;
}

// Rayleigh cos(theta) by RITA (rayleigh_mode "rita"): rational
// inverse-transform sampling of the squared molecular form factor with
// Thomson (1 + cos^2) / 2 rejection, RAYLEIGH_TRIPS trips of 3 rows from
// `row`, the last proposal kept when none accepts; pure Thomson where
// xmax < 0.01. `rita` = [4][plane] (x, p, a, b), the material's 128-point
// rows read with __ldg. The interval is found by bisection over the
// non-decreasing p row: the count of knots at or below the proposal, as the
// JAX sampler's compare-count (tests hold the rows non-decreasing). A lane
// draws only the trips it takes.
__device__ __forceinline__ float rayleigh_rita_costh(float energy, int mat, float pmax,
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
      int lo = 0, hi = NP_RAYLEIGH;  // lo = #{k : p[k] <= ru}
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(pr + mid) <= ru) lo = mid + 1; else hi = mid;
      }
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

// rotate a unit vector by polar angle acos(costh) and azimuth phi in its own
// frame (PENELOPE's DIRECT); renormalises the input when needed
__device__ __forceinline__ void rotate_direction(float& dx, float& dy, float& dz,
                                                 float costh, float phi) {
  float dxy = dx * dx + dy * dy;
  const float norm2 = dxy + dz * dz;
  const float inv_norm =
      fabsf(norm2 - 1.0f) > 1.0e-7f ? rsqrtf(fmaxf(norm2, 1e-30f)) : 1.0f;
  const float x = dx * inv_norm, y = dy * inv_norm, z = dz * inv_norm;
  dxy = x * x + y * y;
  const float sinphi = sinf(phi), cosphi = cosf(phi);
  const float sin2 = fmaxf(1.0f - costh * costh, 0.0f);
  if (dxy <= 1.0e-28f) {  // dz ~ +-1
    const float sdt0 = sqrtf(sin2);
    const float sign = z > 0.0f ? 1.0f : (z < 0.0f ? -1.0f : 0.0f);
    dx = sign * sdt0 * cosphi;
    dy = sdt0 * sinphi;
    dz = sign * costh;
  } else {
    const float sdt = sqrtf(sin2 / fmaxf(dxy, 1e-28f));
    dx = x * costh + sdt * (x * z * cosphi - y * sinphi);
    dy = y * costh + sdt * (y * z * cosphi + x * sinphi);
    dz = z * costh - dxy * sdt * cosphi;
  }
}
