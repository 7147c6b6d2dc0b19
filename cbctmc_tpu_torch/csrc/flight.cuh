// flight.cuh: one Woodcock flight of one photon lane, on the lane's state in
// registers: the per-lane body of the JAX engine's flight closure
// (cbctmc_tpu/engine/transport.py run_projection::flight; planned TPU kernel
// cbctmc_tpu/engine/pallas_kernels.py::_flight_kernel). Shared by
// flight_step.cu (one flight per launch, state in device memory between
// flights) and flight_resolve.cu (flight and event resolve in one launch).
// Also the per-lane body of the tally (tally_lane on a lane in registers,
// tally_stored_lane on one still in memory), shared by tally.cu and by the
// flight_resolve launch that ends an iteration.
//
// Per lane: the three majorant tiers (full Woodcock, air, soft) from their
// conservative log-polynomials, the clearance-bounded tier choice and the
// analytic air flight outside the non-air box; the step clamp; the voxel
// lookup (each axis clamped to shape-1) and ONE packed-word gather
// (material | air level | soft level | density); the total inverse MFP from
// the per-material Chebyshev rows (Clenshaw, in the JAX package's order) and
// the real-event test, which sets pending / vox / mat_evt / xi; the
// detector-plane pixel of an escaping photon, the depth-1 stash of its
// record and the adoption of the lane's pre-sampled candidate photon while
// the history budget allows.

#pragma once

#include "engine.cuh"

__device__ __forceinline__ float horner(const float* c, int len, float t) {
  float acc = c[0];
  for (int k = 1; k < len; ++k) acc = acc * t + c[k];
  return acc;
}

__device__ __forceinline__ float clamped_advance(float mfp, float bound) {
  return mfp * -expm1f(-bound / mfp);
}

__device__ __forceinline__ int axis_cell(float p, float size, int n) {
  // trunc(p / size) clamped to [0, n-1]; clamping the float first is the
  // same for every finite p and keeps the conversion in range
  float c = p / size;
  c = fminf(fmaxf(c, 0.0f), (float)(n - 1));
  return (int)c;
}

// the Chebyshev argument of the sigma fits at log-energy log_e
__device__ __forceinline__ float sigma_arg(float log_e, const Params& P) {
  const float s = 2.0f * (log_e - P.sigma_log_lo) / P.sigma_range - 1.0f;
  return fminf(fmaxf(s, -1.0f), 1.0f);
}

// exp(cheb(s) + step * 1[s >= s_edge]) of one channel (Compton, Rayleigh,
// photoelectric) of a material's coefficient row [3*d Chebyshev | 3 x
// (s_edge, step)]
__device__ __forceinline__ float sigma_channel(const float* row, int d, int ci, float s) {
  const float two_s = 2.0f * s;
  const float* c = row + ci * d;
  float b1 = 0.0f, b2 = 0.0f;
  for (int k = d - 1; k > 0; --k) {
    const float nb1 = c[k] + two_s * b1 - b2;
    b2 = b1;
    b1 = nb1;
  }
  const float val = c[0] + s * b1 - b2;
  const float s_edge = row[3 * d + 2 * ci];
  const float step = row[3 * d + 2 * ci + 1];
  return expf(val + (s >= s_edge ? step : 0.0f));
}

// detector-plane intersection of a ray; the pixel (x + z * npix_x) when it
// hits the detector moving towards it, else -1
__device__ __forceinline__ int detector_pixel(float px, float py, float pz, float dx,
                                              float dy, float dz, const Params& P) {
  const float cos_angle = dx * P.sdir[0] + dy * P.sdir[1] + dz * P.sdir[2];
  const bool moving_towards = cos_angle >= TALLY_MIN_COS;
  const float safe_cos = moving_towards ? cos_angle : 1.0f;
  const float dist = (P.sdir[0] * (P.det_center[0] - px) +
                      P.sdir[1] * (P.det_center[1] - py) +
                      P.sdir[2] * (P.det_center[2] - pz)) / safe_cos;
  const float hx = px + dist * dx, hy = py + dist * dy, hz = pz + dist * dz;
  const float rx = P.rot0[0] * hx + P.rot0[1] * hy + P.rot0[2] * hz;
  const float rz = P.rot2[0] * hx + P.rot2[1] * hy + P.rot2[2] * hz;
  const float fx = floorf((rx - P.corner_x) * P.inv_pix_x);
  const float fz = floorf((rz - P.corner_z) * P.inv_pix_z);
  const bool hit = moving_towards && fx >= 0.0f && fx < (float)P.npix_x &&
                   fz >= 0.0f && fz < (float)P.npix_z;
  // convert only in-range values (float -> int of a far miss is undefined)
  return hit ? (int)fx + (int)fz * P.npix_x : -1;
}

// One flight of an active lane (alive, not pending). `s_coeff` is the
// [n_mats, 3*cheb_d + 6] coefficient table (in shared memory);
// `budget_covers_lanes` the adoption guard remaining >= n_lanes as the
// launch read it. Returns true when the lane adopted its candidate.
__device__ __forceinline__ bool flight_lane(LaneRegs& s, const Candidates& C, int i,
                                            float u_step, float u_int,
                                            const uint32_t* __restrict__ packed,
                                            const float* s_coeff,
                                            bool budget_covers_lanes, const Params& P) {
  float px = s.px, py = s.py, pz = s.pz;
  const float dx = s.dx, dy = s.dy, dz = s.dz;
  const float energy = s.energy;
  const int k_air = s.k_air, k_soft = s.k_soft;

  // ---- majorant tiers --------------------------------------------------
  const float log_e = logf(energy);
  float t = (log_e - P.log_e_lo) * P.inv_log_range;
  t = fminf(fmaxf(t, 0.0f), 1.0f);
  const float mfp_wc = expf(horner(P.wc_poly, P.poly_len, t));
  const float mfp_air = expf(horner(P.air_poly, P.poly_len, t)) * P.inv_air_den;
  const float mfp_soft = P.soft_skip ? expf(horner(P.soft_poly, P.poly_len, t)) : mfp_wc;

  float mfp_samp = mfp_wc, bound = BIG;
  if (P.air_skip) {
    const bool outside = (px < P.nonair_lo[0]) || (px > P.nonair_hi[0]) ||
                         (py < P.nonair_lo[1]) || (py > P.nonair_hi[1]) ||
                         (pz < P.nonair_lo[2]) || (pz > P.nonair_hi[2]);
    const float p3[3] = {px, py, pz};
    const float d3[3] = {dx, dy, dz};
    float tmin = -BIG, tmax = BIG;
    for (int a = 0; a < 3; ++a) {
      const float inv_d = 1.0f / (fabsf(d3[a]) > 1e-12f ? d3[a] : 1e-12f);
      const float t1 = (P.nonair_lo[a] - p3[a]) * inv_d;
      const float t2 = (P.nonair_hi[a] - p3[a]) * inv_d;
      tmin = fmaxf(tmin, fminf(t1, t2));
      tmax = fminf(tmax, fmaxf(t1, t2));
    }
    float t_box = (tmax >= tmin && tmax > 0.0f) ? tmin : BIG;
    t_box = fmaxf(t_box, 0.0f) + 1.0e-4f;

    const float b_air = (float)((1 << k_air) - 1) * P.voxmin;
    const float adv_air = k_air >= 1 ? clamped_advance(mfp_air, b_air) : 0.0f;
    float b_soft = 0.0f, adv_soft = 0.0f;
    if (P.soft_skip) {
      b_soft = (float)((1 << k_soft) - 1) * P.voxmin;
      adv_soft = k_soft >= 1 ? clamped_advance(mfp_soft, b_soft) : 0.0f;
    }
    const bool use_air = (adv_air > mfp_wc) && (adv_air >= adv_soft);
    const bool use_soft = (adv_soft > mfp_wc) && !use_air;
    const float mfp_in = use_air ? mfp_air : (use_soft ? mfp_soft : mfp_wc);
    const float b_in = use_air ? b_air : (use_soft ? b_soft : BIG);
    mfp_samp = outside ? mfp_air : mfp_in;
    bound = outside ? t_box : b_in;
  }

  const float raw = -mfp_samp * logf(u_step);
  const float step = fminf(raw, bound);
  const bool clamped = raw > bound;
  px = px + step * dx;
  py = py + step * dy;
  pz = pz + step * dz;

  // ---- voxel lookup + the packed-word gather ---------------------------
  const bool in_bbox = (px >= EPS_SOURCE) && (px <= P.bbox_hi[0]) &&
                       (py >= EPS_SOURCE) && (py <= P.bbox_hi[1]) &&
                       (pz >= EPS_SOURCE) && (pz <= P.bbox_hi[2]);
  const int vx = axis_cell(px, P.voxel_size[0], P.nx);
  const int vy = axis_cell(py, P.voxel_size[1], P.ny);
  const int vz = axis_cell(pz, P.voxel_size[2], P.nz);
  const int nvox = vx + vy * P.nx + vz * (P.nx * P.ny);
  const int cvox = nvox < 0 ? 0 : (nvox > P.n_voxels - 1 ? P.n_voxels - 1 : nvox);
  const uint32_t word = __ldg(packed + cvox);
  const int mat = (int)(word >> 27);
  const int k_new = (int)((word >> 24) & 7u);
  const int ks_new = (int)((word >> 21) & 7u);
  const float den = (float)(word & 0x1FFFFFu) * P.den_scale;

  // ---- total inverse MFP from the Chebyshev rows -----------------------
  const int mrow = mat < P.n_mats ? mat : P.n_mats - 1;
  const float* row = s_coeff + mrow * (3 * P.cheb_d + 6);
  const float sa = sigma_arg(log_e, P);
  const float s_c = sigma_channel(row, P.cheb_d, 0, sa);
  const float s_r = sigma_channel(row, P.cheb_d, 1, sa);
  const float s_p = sigma_channel(row, P.cheb_d, 2, sa);
  const float inv_tot = s_c + s_r + s_p;
  const float mfp_den = mfp_samp * den;
  const float p_delta = 1.0f - mfp_den * inv_tot;

  const bool real = in_bbox && !clamped && (u_int >= p_delta);
  if (real) {
    s.pending = true;
    s.vox = nvox;
    s.mat_evt = mat;
    s.xi = (u_int - p_delta) / fmaxf(mfp_den, 1e-30f);
  }

  // ---- stash the detector record, adopt the candidate ------------------
  bool adopted = false;
  s.k_air = k_new;
  s.k_soft = ks_new;
  if (!in_bbox) {
    const int pix = detector_pixel(px, py, pz, dx, dy, dz, P);
    const int npix = P.npix_x * P.npix_z;
    const int rec = pix >= 0 ? s.scatter * npix + pix : 4 * npix;
    const bool do_stash = !s.stash_valid;
    if (do_stash) {
      s.stash_idx = rec;
      s.stash_energy = energy;
      s.stash_valid = true;
    } else {
      s.escaped = true;
    }
    adopted = do_stash && s.cand_free && budget_covers_lanes;
    if (adopted) {
      s.cand_free = false;
      px = C.px[i];
      py = C.py[i];
      pz = C.pz[i];
      s.dx = C.dx[i];
      s.dy = C.dy[i];
      s.dz = C.dz[i];
      s.energy = C.energy[i];
      s.ebin = C.ebin[i];
      s.scatter = 0;
      s.k_air = 0;
      s.k_soft = 0;
    } else {
      s.alive = false;
    }
  }
  s.px = px;
  s.py = py;
  s.pz = pz;
  return adopted;
}

// The tally of one lane, on its state in registers: the lane's stashed
// record, or else its parked one (an escape while the stash was taken), goes
// into the 4-class image by one atomicAdd; a lane holding both tallies the
// stash and keeps the parked record as its next stash. Returns true when a
// record was added (`val` then holds its energy) and sets `waits` when a
// record stays for the next tally. The JAX engine's tally stage
// (cbctmc_tpu/engine/transport.py run_projection: _tally_pixel, the
// stash / doubles logic and the scatter-add).
__device__ __forceinline__ bool tally_lane(LaneRegs& s, float* __restrict__ image,
                                           const Params& P, float& val, bool& waits) {
  const int npix = P.npix_x * P.npix_z;
  int parked_idx = 4 * npix;  // the dropped sentinel
  float parked_energy = 0.0f;
  if (s.escaped) {
    const int pix = detector_pixel(s.px, s.py, s.pz, s.dx, s.dy, s.dz, P);
    if (pix >= 0) {
      parked_idx = s.scatter * npix + pix;
      parked_energy = s.energy;
    }
  }
  int idx = parked_idx;
  val = parked_energy;
  waits = false;
  if (s.stash_valid) {
    if (s.stash_idx < 4 * npix) {
      idx = s.stash_idx;
      val = s.stash_energy;
      waits = parked_idx < 4 * npix;  // the parked record waits for the next tally
    }
    if (waits) {
      s.stash_idx = parked_idx;
      s.stash_energy = parked_energy;
    } else {
      s.stash_valid = false;
    }
  }
  if (idx >= 4 * npix) return false;
  atomicAdd(image + (idx < 0 ? 0 : idx), val);
  return true;
}

// The tally of a lane whose state is still in device memory (a lane that was
// dead when the launch began; every lane of the tally kernel). It reads the
// lane's two record flags and only what its record needs: position,
// direction, energy and scatter class of a parked record (32 B), the two
// words of a stashed one (8 B); it writes back only the stash words or the
// stash flag that changed. Returns and sets what tally_lane does.
__device__ __forceinline__ bool tally_stored_lane(const Lanes& L, int i,
                                                  float* __restrict__ image,
                                                  const Params& P, float& val,
                                                  bool& waits) {
  val = 0.0f;
  waits = false;
  const bool escaped = L.escaped[i], stashed = L.stash_valid[i];
  if (!escaped && !stashed) return false;
  LaneRegs s = {};
  s.escaped = escaped;
  s.stash_valid = stashed;
  if (escaped) {
    s.px = L.px[i]; s.py = L.py[i]; s.pz = L.pz[i];
    s.dx = L.dx[i]; s.dy = L.dy[i]; s.dz = L.dz[i];
    s.energy = L.energy[i]; s.scatter = L.scatter[i];
  }
  if (stashed) {
    s.stash_idx = L.stash_idx[i];
    s.stash_energy = L.stash_energy[i];
  }
  const bool added = tally_lane(s, image, P, val, waits);
  if (stashed) {
    if (waits) {
      L.stash_idx[i] = s.stash_idx;
      L.stash_energy[i] = s.stash_energy;
    } else {
      L.stash_valid[i] = false;
    }
  }
  return added;
}
