// flight_step: one Woodcock flight of every photon lane of the engine-v4
// transport loop, over the packed u32 voxel word.
//
// Replaces: the JAX engine's flight closure
// (cbctmc_tpu/engine/transport.py run_projection::flight), whose planned
// TPU kernel is cbctmc_tpu/engine/pallas_kernels.py::_flight_kernel. This is
// the production form of that computation: per lane
//   - the three majorant tiers (full Woodcock, air, soft) from their
//     conservative log-polynomials, the clearance-bounded tier choice and
//     the analytic air flight outside the non-air box; the step clamp;
//   - the voxel lookup (each axis clamped to shape-1) and ONE packed-word
//     gather, unpacked into material | air level | soft level | density;
//   - the total inverse MFP from the per-material Chebyshev rows (Clenshaw,
//     degree 23, in the JAX package's order) and the real-event test, which
//     sets pending / vox / mat_evt / xi;
//   - the detector-plane pixel of an escaping photon, the depth-1 stash of
//     its record and the adoption of the lane's pre-sampled candidate photon
//     while the history budget allows (remaining >= n_lanes, read on the
//     device at launch).
// Inactive lanes (dead or pending) are left untouched.
//
// Bound on the H100: bytes. A lane reads ~31 state and candidate words and
// writes up to 21, plus one 32-byte sector for the voxel gather: about
// 240 B per lane, 15.7 MB per launch at 65,536 lanes, i.e. ~4.7 us at
// 3.35 TB/s. The arithmetic (~3 Clenshaw recurrences of 23 steps, three
// Horner polynomials and ~8 transcendentals, some 400 flops) is ~0.4 us of
// the card's fp32 peak at that width.
//
// Design: one thread per lane with structure-of-arrays lane state, so every
// state word is a coalesced load/store. The [n_mats, 3*24+6] coefficient
// table (~7 KB) is staged in shared memory once per block; lanes of one
// material read the same row (broadcast). The voxel word is a single
// 4-byte __ldg (no paired layout: that was a TPU gather-pricing trick). The
// adoptions and active lanes of the launch are summed with a warp-shuffle
// block reduction and ONE atomicAdd per block; the wrapper then decrements
// the device-side history budget, so every launch of a sub-phase sees the
// budget its predecessors left, as the JAX loop does.
//
// Built without --use_fast_math (the physics needs logf/expf/expm1f to
// full accuracy) and with -fmad=false, so each product and sum rounds on its
// own, as the plain PyTorch version's separate operations do.

#include <cstdint>
#include <cuda_runtime.h>

#define MAX_POLY 16

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
  const float *px, *py, *pz, *dx, *dy, *dz, *energy;
  const int32_t *ebin;
};

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

#define EPS_SOURCE 1.5e-5f
#define TALLY_MIN_COS 0.025f
#define BIG 1.0e30f

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

// exp(cheb(s) + step * 1[s >= s_edge]) of one channel of a coefficient row
__device__ __forceinline__ float sigma_channel(const float* row, int d, int ci,
                                               float s, float two_s) {
  const float* c = row + ci * d;
  float b1 = 0.0f, b2 = 0.0f;
  for (int k = d - 1; k > 0; --k) {
    float nb1 = c[k] + two_s * b1 - b2;
    b2 = b1;
    b1 = nb1;
  }
  float val = c[0] + s * b1 - b2;
  float s_edge = row[3 * d + 2 * ci];
  float step = row[3 * d + 2 * ci + 1];
  return expf(val + (s >= s_edge ? step : 0.0f));
}

__global__ void flight_step_kernel(Lanes L, Candidates C,
                                   const float* __restrict__ u_step_all,
                                   const float* __restrict__ u_int_all,
                                   const uint32_t* __restrict__ packed,
                                   const float* __restrict__ coeffs, int coeff_len,
                                   const int32_t* __restrict__ remaining,
                                   int32_t* __restrict__ counts, Params P) {
  extern __shared__ float s_coeff[];
  for (int j = threadIdx.x; j < coeff_len; j += blockDim.x) s_coeff[j] = coeffs[j];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int adopted = 0, was_active = 0;
  if (i < P.n && L.alive[i] && !L.pending[i]) {
    was_active = 1;
    float px = L.px[i], py = L.py[i], pz = L.pz[i];
    float dx = L.dx[i], dy = L.dy[i], dz = L.dz[i];
    const float energy = L.energy[i];
    const int k_air = L.k_air[i], k_soft = L.k_soft[i];
    const float u_step = u_step_all[i], u_int = u_int_all[i];

    // ---- majorant tiers ------------------------------------------------
    const float log_e = logf(energy);
    float t = (log_e - P.log_e_lo) * P.inv_log_range;
    t = fminf(fmaxf(t, 0.0f), 1.0f);
    const float mfp_wc = expf(horner(P.wc_poly, P.poly_len, t));
    const float mfp_air = expf(horner(P.air_poly, P.poly_len, t)) * P.inv_air_den;
    const float mfp_soft =
        P.soft_skip ? expf(horner(P.soft_poly, P.poly_len, t)) : mfp_wc;

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

    // ---- voxel lookup + the packed-word gather -------------------------
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

    // ---- total inverse MFP from the Chebyshev rows ---------------------
    const int mrow = mat < P.n_mats ? mat : P.n_mats - 1;
    const float* row = s_coeff + mrow * (3 * P.cheb_d + 6);
    float s = 2.0f * (log_e - P.sigma_log_lo) / P.sigma_range - 1.0f;
    s = fminf(fmaxf(s, -1.0f), 1.0f);
    const float two_s = 2.0f * s;
    const float s_c = sigma_channel(row, P.cheb_d, 0, s, two_s);
    const float s_r = sigma_channel(row, P.cheb_d, 1, s, two_s);
    const float s_p = sigma_channel(row, P.cheb_d, 2, s, two_s);
    const float inv_tot = s_c + s_r + s_p;
    const float mfp_den = mfp_samp * den;
    const float p_delta = 1.0f - mfp_den * inv_tot;

    const bool newly_escaped = !in_bbox;
    const bool real = in_bbox && !clamped && (u_int >= p_delta);
    if (real) {
      L.pending[i] = 1;
      L.vox[i] = nvox;
      L.mat_evt[i] = mat;
      L.xi[i] = (u_int - p_delta) / fmaxf(mfp_den, 1e-30f);
    }

    // ---- stash the detector record, adopt the candidate ----------------
    int k_air_out = k_new, k_soft_out = ks_new;
    if (newly_escaped) {
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
      const int npix = P.npix_x * P.npix_z;
      const int rec = hit ? L.scatter[i] * npix + (int)fx + (int)fz * P.npix_x
                          : 4 * npix;
      const bool do_stash = !L.stash_valid[i];
      if (do_stash) {
        L.stash_idx[i] = rec;
        L.stash_energy[i] = energy;
        L.stash_valid[i] = 1;
      } else {
        L.escaped[i] = 1;
      }
      const bool adopt = do_stash && L.cand_free[i] && (remaining[0] >= P.n);
      if (adopt) {
        adopted = 1;
        L.cand_free[i] = 0;
        px = C.px[i];
        py = C.py[i];
        pz = C.pz[i];
        L.dx[i] = C.dx[i];
        L.dy[i] = C.dy[i];
        L.dz[i] = C.dz[i];
        L.energy[i] = C.energy[i];
        L.ebin[i] = C.ebin[i];
        L.scatter[i] = 0;
        k_air_out = 0;
        k_soft_out = 0;
      } else {
        L.alive[i] = 0;
      }
    }
    L.px[i] = px;
    L.py[i] = py;
    L.pz[i] = pz;
    L.k_air[i] = k_air_out;
    L.k_soft[i] = k_soft_out;
  }

  // ---- block reduction of (adopted, active), one atomic per block -------
  const unsigned full = 0xffffffffu;
  for (int off = 16; off > 0; off >>= 1) {
    adopted += __shfl_down_sync(full, adopted, off);
    was_active += __shfl_down_sync(full, was_active, off);
  }
  __shared__ int s_adopt[32], s_active[32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    s_adopt[warp] = adopted;
    s_active[warp] = was_active;
  }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    adopted = lane < n_warps ? s_adopt[lane] : 0;
    was_active = lane < n_warps ? s_active[lane] : 0;
    for (int off = 16; off > 0; off >>= 1) {
      adopted += __shfl_down_sync(full, adopted, off);
      was_active += __shfl_down_sync(full, was_active, off);
    }
    if (lane == 0) {
      if (adopted) atomicAdd(counts, adopted);
      if (was_active) atomicAdd(counts + 1, was_active);
    }
  }
}

extern "C" int flight_step_launch(const Lanes* lanes, const Candidates* cands,
                                  const float* u_step, const float* u_int,
                                  const uint32_t* packed, const float* coeffs,
                                  int coeff_len, const int32_t* remaining,
                                  int32_t* counts, const Params* params, void* stream) {
  if (params->n > 0) {
    const int threads = 256;
    const int blocks = (params->n + threads - 1) / threads;
    flight_step_kernel<<<blocks, threads, coeff_len * sizeof(float),
                         (cudaStream_t)stream>>>(*lanes, *cands, u_step, u_int, packed,
                                                 coeffs, coeff_len, remaining, counts,
                                                 *params);
  }
  return (int)cudaGetLastError();
}
