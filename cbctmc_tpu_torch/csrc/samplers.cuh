// samplers.cuh: the per-lane source and interaction samplers of the
// transport engine as __device__ functions: counterparts of the JAX
// package's cbctmc_tpu/engine/samplers.py (sample_spectrum_energy_cdf,
// sample_source_direction, sample_icdf_rows_cdt1, compton_scatter_rows_tab /
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
#define COMPTON_SHELL_TRIPS 8
#define PHOTON_ROWS (2 + 2 * SOURCE_DIR_TRIPS)
#define RESOLVE_ROWS (2 + 3 * COMPTON_SHELL_TRIPS + 1)

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

// one source photon from the pool of PHOTON_ROWS rows starting at `pool`
__device__ __forceinline__ Photon sample_photon(Rng& rng, int pool, const float* s_spec,
                                                const PhaseParams& Q) {
  Photon p;
  const float u0 = u_open(rng, pool);
  const float u1 = u_open(rng, pool + 1);
  p.energy = sample_spectrum_energy(u0, u1, s_spec, Q.n_spec_bins);
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

// Compton with a pre-sampled angle: target shell + Doppler-broadened
// scattered energy. `sh` points at the material's shell rows, laid out
// [3][n_mats][s_max] (f, ui, j0) with `plane` = n_mats * s_max. The shell
// sums run shell by shell, as the plain version's; a lane walks only its
// own material's shells and leaves the rejection loop when it accepts, so
// the warp pays for its slowest lane; it draws (one Philox call per four
// rows) only the trips it takes.
__device__ __forceinline__ float compton_shell_energy(
    float energy, float cdt1, const float* sh, int plane, int s_max, Rng& rng, int row) {
  const float* sh_f = sh;
  const float* sh_ui = sh + plane;
  const float* sh_j0 = sh + 2 * plane;
  const float ek = energy * INV_MEC2;
  const float tau = 1.0f / (1.0f + ek * cdt1);
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
