// joseph.cuh: the ray march shared by joseph_project.cu and joseph_splat.cu.
//
// The JAX package's cbctmc_tpu/recon/joseph.py marches every detector ray
// of a view from its entry into the volume's support box
// (_ray_box_entry) in n_steps fixed steps of step_mm and samples the volume
// trilinearly at each step, zero outside (_trilinear). These functions
// compute each quantity of one ray and one sample by the same operations on
// the same operands, in the same order, as the plain versions
// (cbctmc_tpu_torch/recon/joseph.py project_one_reference /
// splat_one_reference), which follow _project_one / _splat_one op for op;
// built with -fmad=false and without fast math, so nothing is contracted
// into a fused multiply-add and every division and square root is rounded
// correctly.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace joseph {

constexpr int kRaysX = 32;  // rays of a block along u: one warp, 32 consecutive u of a row
constexpr int kRaysY = 4;   // rows of a block along v

struct Args {
  int nx, ny, nz;
  float ox, oy, oz;  // centre of voxel 0 [mm]
  float sx, sy, sz;  // voxel spacing [mm]
  float lox, loy, loz, hix, hiy, hiz;  // the support box, float32 as the plain version forms it
  float evx, evy, evz;                 // the detector's v axis
  const float* views;                  // [P, 9]: source, detector origin point, u axis
  const float* pixel_u;                // [nu]
  const float* pixel_v;                // [nv]
  int P, nv, nu;
  int n_steps;
  float step_mm;
};

// torch.minimum / torch.maximum: a NaN operand gives NaN
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : (b < a ? b : a));
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : (a < b ? b : a));
}

struct Ray {
  float sx, sy, sz;  // source
  float dx, dy, dz;  // unit direction
  float t_near;      // entry distance into the support box, >= 0
};

// the ray of detector pixel (iu, iv) of view p
__device__ __forceinline__ Ray make_ray(const Args& a, int p, int iu, int iv) {
  const float* g = a.views + 9 * p;
  const float uu = a.pixel_u[iu], vv = a.pixel_v[iv];
  // det_origin_point + uu * e_u + vv * e_v
  const float px = (g[3] + uu * g[6]) + vv * a.evx;
  const float py = (g[4] + uu * g[7]) + vv * a.evy;
  const float pz = (g[5] + uu * g[8]) + vv * a.evz;
  const float rx = px - g[0], ry = py - g[1], rz = pz - g[2];
  const float len = sqrtf((rx * rx + ry * ry) + rz * rz);
  Ray r;
  r.sx = g[0];
  r.sy = g[1];
  r.sz = g[2];
  r.dx = rx / len;
  r.dy = ry / len;
  r.dz = rz / len;
  const float mx = nan_min((a.lox - r.sx) / r.dx, (a.hix - r.sx) / r.dx);
  const float my = nan_min((a.loy - r.sy) / r.dy, (a.hiy - r.sy) / r.dy);
  const float mz = nan_min((a.loz - r.sz) / r.dz, (a.hiz - r.sz) / r.dz);
  r.t_near = nan_max(nan_max(nan_max(mx, my), mz), 0.0f);
  return r;
}

struct Sample {
  int64_t base;      // flat index of the lower corner, z fastest
  float fx, fy, fz;  // fractional offsets from it
};

// step i of the ray: false where the sample lies outside the volume (the
// reference's zero there); else the lower corner and the offsets
__device__ __forceinline__ bool sample_at(const Args& a, const Ray& r, int i, Sample& s) {
  const float t = r.t_near + ((float)i + 0.5f) * a.step_mm;
  const float x = ((r.sx + r.dx * t) - a.ox) / a.sx;
  const float y = ((r.sy + r.dy * t) - a.oy) / a.sy;
  const float z = ((r.sz + r.dz * t) - a.oz) / a.sz;
  if (!((x >= 0.0f) && (x <= (float)(a.nx - 1)) && (y >= 0.0f) && (y <= (float)(a.ny - 1)) &&
        (z >= 0.0f) && (z <= (float)(a.nz - 1))))
    return false;
  // inside the box, so the reference's clip of x, y, z changes nothing
  int x0 = __float2int_rz(floorf(x)), y0 = __float2int_rz(floorf(y)),
      z0 = __float2int_rz(floorf(z));
  x0 = x0 > a.nx - 2 ? a.nx - 2 : x0;
  y0 = y0 > a.ny - 2 ? a.ny - 2 : y0;
  z0 = z0 > a.nz - 2 ? a.nz - 2 : z0;
  s.fx = x - (float)x0;
  s.fy = y - (float)y0;
  s.fz = z - (float)z0;
  s.base = ((int64_t)x0 * a.ny + y0) * a.nz + z0;
  return true;
}

}  // namespace joseph
