// joseph_project: the ray-marched cone-beam forward projection of a volume
// onto a batch of views.
//
// Replaces: the XLA program cbctmc_tpu/recon/joseph.py::_project_one (with
// _ray_box_entry and _trilinear): a fori_loop over n_steps, each step a
// full-detector gather of eight trilinear corners. The JAX package has no
// Pallas kernel for it; this is a hand kernel of the port. Plain version:
// cbctmc_tpu_torch/recon/joseph.py::project_one_reference.
//
// For every detector pixel (u, v) of every view: the ray from the source
// through the pixel, its entry t_near into the support box, then n_steps
// samples at t_near + (i + 0.5) step_mm, each the trilinear interpolation of
// the eight corners (zero outside the volume), summed and times step_mm.
//
// Bound on the H100: operations. At the production shapes (a 464 x 464 x
// 250 volume of 215 MB, 768 x 1024 rays a view, 1,002 or 1,402 steps) the
// function reads the volume once and writes 3 MB a view, against 31
// floating-point operations for every sample inside the volume (floors,
// offsets, the three-level interpolation and the sum) and 21 for placing it
// (its position and the face tests), and 49 per ray (its direction and box
// entry); ~61 % of the steps of a view lie inside.
//
// What held the first version back, and the design's answer (joseph.cuh):
// - its warps held 32 rays of a detector row, spread across x-y, so each of
//   the eight corner loads of a step touched ~32 sectors and the kernel ran
//   at the L1's sector rate. A warp now holds 32 rays along v, the volume's
//   contiguous z: a load touches one or two sectors;
// - it ran all n_steps of every ray. A ray now runs only its run of steps
//   inside the volume (step_range), found exactly, so the sum is the same
//   sum, bit for bit, without the steps at which the reference adds 0.
// What is left is issue: per sample three correctly rounded divisions (the
// reference's positions), the floors, the eight __ldg and the
// interpolation, one thread per ray with the sum in a register. Warps of
// 8 v x 4 u or 16 v x 2 u rays, and blocks of 8 warps, time the same.

#include "joseph.cuh"

__global__ void __launch_bounds__(joseph::kThreads)
    joseph_project_kernel(joseph::Args a, const float* __restrict__ vol,
                          float* __restrict__ out) {
  int iu, iv;
  joseph::ray_of_thread(iu, iv);
  const int p = blockIdx.z;
  if (iu >= a.nu || iv >= a.nv) return;
  const joseph::Ray r = joseph::make_ray(a, p, iu, iv);
  int first, last;
  joseph::step_range(a, r, first, last);
  const int sy = a.nz, sx = a.ny * a.nz;
  float acc = 0.0f;
  for (int i = first; i <= last; ++i) {
    const joseph::Sample s = joseph::sample_at(a, r, i);
    const float* c = vol + s.base;
    const float c000 = __ldg(c), c001 = __ldg(c + 1);
    const float c010 = __ldg(c + sy), c011 = __ldg(c + sy + 1);
    const float c100 = __ldg(c + sx), c101 = __ldg(c + sx + 1);
    const float c110 = __ldg(c + sx + sy), c111 = __ldg(c + sx + sy + 1);
    const float gz = 1.0f - s.fz, gy = 1.0f - s.fy, gx = 1.0f - s.fx;
    const float c00 = c000 * gz + c001 * s.fz;
    const float c01 = c010 * gz + c011 * s.fz;
    const float c10 = c100 * gz + c101 * s.fz;
    const float c11 = c110 * gz + c111 * s.fz;
    const float c0 = c00 * gy + c01 * s.fy;
    const float c1 = c10 * gy + c11 * s.fy;
    acc = acc + (c0 * gx + c1 * s.fx);
  }
  out[((int64_t)p * a.nv + iv) * a.nu + iu] = acc * a.step_mm;
}

extern "C" int joseph_project_launch(const float* vol, int nx, int ny, int nz, float ox,
                                     float oy, float oz, float sx, float sy, float sz, float lox,
                                     float loy, float loz, float hix, float hiy, float hiz,
                                     float evx, float evy, float evz, const float* views,
                                     const float* pixel_u, const float* pixel_v, int P, int nv,
                                     int nu, int n_steps, float step_mm, float* out,
                                     void* stream) {
  if (P > 0 && nv > 0 && nu > 0) {
    if (P > 65535 || nv > 65535 * joseph::kWarpV) return (int)cudaErrorInvalidValue;
    joseph::Args a{nx, ny, nz, ox, oy, oz, sx, sy, sz, lox, loy, loz, hix, hiy, hiz,
                   evx, evy, evz, views, pixel_u, pixel_v, P, nv, nu, n_steps, step_mm};
    joseph_project_kernel<<<joseph::grid_of(P, nv, nu), joseph::kThreads, 0,
                            (cudaStream_t)stream>>>(a, vol, out);
  }
  return (int)cudaGetLastError();
}
