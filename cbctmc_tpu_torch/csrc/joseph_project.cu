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
// function reads the volume once and writes 3 MB a view, against 21
// floating-point operations for every step of every ray (the sample's
// position and the inside test), 31 more for every step inside the volume
// (floors, offsets, the three-level interpolation and the sum) and 49 per
// ray (its direction and box entry).
//
// Design (simple first): one thread per ray with its sum in a register; a
// warp holds 32 consecutive u of one detector row, a block 4 rows, and
// blockIdx.z is the view, so one launch covers a batch of views. The eight
// corners are __ldg loads of the volume (read-only path). Every step runs,
// also for rays that miss the volume, as in the reference. The volume does
// not fit the 50 MB L2; neighbouring rays of a warp sample neighbouring
// voxels, so most corners come from L1 and L2.

#include "joseph.cuh"

__global__ void joseph_project_kernel(joseph::Args a, const float* __restrict__ vol,
                                      float* __restrict__ out) {
  const int iu = blockIdx.x * joseph::kRaysX + threadIdx.x;
  const int iv = blockIdx.y * joseph::kRaysY + threadIdx.y;
  const int p = blockIdx.z;
  if (iu >= a.nu || iv >= a.nv) return;
  const joseph::Ray r = joseph::make_ray(a, p, iu, iv);
  const int64_t sy = a.nz, sx = (int64_t)a.ny * a.nz;
  float acc = 0.0f;
  for (int i = 0; i < a.n_steps; ++i) {
    joseph::Sample s;
    if (!joseph::sample_at(a, r, i, s)) continue;  // the reference adds 0 there
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
    if (P > 65535 || nv > 65535 * joseph::kRaysY) return (int)cudaErrorInvalidValue;
    joseph::Args a{nx, ny, nz, ox, oy, oz, sx, sy, sz, lox, loy, loz, hix, hiy, hiz,
                   evx, evy, evz, views, pixel_u, pixel_v, P, nv, nu, n_steps, step_mm};
    const dim3 block(joseph::kRaysX, joseph::kRaysY);
    const dim3 grid((nu + joseph::kRaysX - 1) / joseph::kRaysX,
                    (nv + joseph::kRaysY - 1) / joseph::kRaysY, P);
    joseph_project_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(a, vol, out);
  }
  return (int)cudaGetLastError();
}
