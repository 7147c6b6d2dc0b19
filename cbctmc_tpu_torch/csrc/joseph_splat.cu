// joseph_splat: the exact transpose of joseph_project with respect to the
// volume: every detector value of a batch of views, times step_mm, is
// scatter-added into the volume through the same ray march and the same
// trilinear weights (a "splat" backprojection).
//
// Replaces: the XLA program cbctmc_tpu/recon/joseph.py::_splat_one (a
// fori_loop over n_steps, each step a scatter-add of 8 x rays values). The
// JAX package has no Pallas kernel for it; this is a hand kernel of the
// port. Plain version: cbctmc_tpu_torch/recon/joseph.py::splat_one_reference
// (index_add_ over the same 8 x rays indices per step).
//
// Bound on the H100: operations. At the production shapes the function reads
// 3 MB of detector values a view and reads and writes the 215 MB volume
// once, against the march's 21 operations for every step of every ray and
// 41 more for every step inside the volume (floors and offsets, the eight
// weights, their products with the ray's value and the eight additions into
// the volume).
//
// Design (simple first): the same thread per ray and the same grid as
// joseph_project; each sample inside the volume issues eight
// atomicAdd(float*) of weight x value. The order in which the additions
// reach a voxel is neither the reference's nor the same from run to run, so
// the result is held to its plain version by a tolerance and to
// joseph_project by the adjoint identity <A x, y> = <x, A^T y>. A ray whose
// value is 0 adds nothing and is skipped whole (adding +0 or -0 leaves
// every voxel as it is).

#include "joseph.cuh"

__global__ void joseph_splat_kernel(joseph::Args a, const float* __restrict__ g,
                                    float* __restrict__ vol) {
  const int iu = blockIdx.x * joseph::kRaysX + threadIdx.x;
  const int iv = blockIdx.y * joseph::kRaysY + threadIdx.y;
  const int p = blockIdx.z;
  if (iu >= a.nu || iv >= a.nv) return;
  const float value = g[((int64_t)p * a.nv + iv) * a.nu + iu] * a.step_mm;
  if (value == 0.0f) return;
  const joseph::Ray r = joseph::make_ray(a, p, iu, iv);
  const int64_t sy = a.nz, sx = (int64_t)a.ny * a.nz;
  for (int i = 0; i < a.n_steps; ++i) {
    joseph::Sample s;
    if (!joseph::sample_at(a, r, i, s)) continue;
    const float gx0 = 1.0f - s.fx, gx1 = s.fx;
    const float gy0 = 1.0f - s.fy, gy1 = s.fy;
    const float gz0 = 1.0f - s.fz, gz1 = s.fz;
    float* c = vol + s.base;
    atomicAdd(c, ((gx0 * gy0) * gz0) * value);
    atomicAdd(c + 1, ((gx0 * gy0) * gz1) * value);
    atomicAdd(c + sy, ((gx0 * gy1) * gz0) * value);
    atomicAdd(c + sy + 1, ((gx0 * gy1) * gz1) * value);
    atomicAdd(c + sx, ((gx1 * gy0) * gz0) * value);
    atomicAdd(c + sx + 1, ((gx1 * gy0) * gz1) * value);
    atomicAdd(c + sx + sy, ((gx1 * gy1) * gz0) * value);
    atomicAdd(c + sx + sy + 1, ((gx1 * gy1) * gz1) * value);
  }
}

extern "C" int joseph_splat_launch(const float* g, int nx, int ny, int nz, float ox, float oy,
                                   float oz, float sx, float sy, float sz, float lox, float loy,
                                   float loz, float hix, float hiy, float hiz, float evx,
                                   float evy, float evz, const float* views,
                                   const float* pixel_u, const float* pixel_v, int P, int nv,
                                   int nu, int n_steps, float step_mm, float* vol,
                                   void* stream) {
  if (P > 0 && nv > 0 && nu > 0) {
    if (P > 65535 || nv > 65535 * joseph::kRaysY) return (int)cudaErrorInvalidValue;
    joseph::Args a{nx, ny, nz, ox, oy, oz, sx, sy, sz, lox, loy, loz, hix, hiy, hiz,
                   evx, evy, evz, views, pixel_u, pixel_v, P, nv, nu, n_steps, step_mm};
    const dim3 block(joseph::kRaysX, joseph::kRaysY);
    const dim3 grid((nu + joseph::kRaysX - 1) / joseph::kRaysX,
                    (nv + joseph::kRaysY - 1) / joseph::kRaysY, P);
    joseph_splat_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(a, g, vol);
  }
  return (int)cudaGetLastError();
}
