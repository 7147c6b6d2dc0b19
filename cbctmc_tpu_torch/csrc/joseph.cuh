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
//
// The march is cut to each ray's run inside the volume (step_range). Every
// coordinate of a sample, ((s + d * t) - o) / spacing with t = t_near +
// (i + 0.5) * step_mm, is monotone in the step i in float32: each operation
// is correctly rounded, and rounding is monotone. So each of the six face
// tests holds on a prefix or a suffix of the steps, the samples inside form
// one run [first, last], and bisection with the same expressions finds its
// ends exactly. The steps outside it are exactly those at which the
// reference adds 0; a kernel runs none of them (the plain version of the
// rule is recon/joseph.py step_range_reference).
//
// Thread layout (ray_of_thread): the 32 lanes of a warp are 32 rays that
// neighbour each other in v, rows of one detector column. The detector's v
// axis is the volume's z, its contiguous axis, so at one step a warp's
// samples lie on a short run of z (neighbouring rows are ~0.26 voxel apart
// at the isocentre on the reference panel) in one or two x-y columns: each
// of the eight corner loads touches one or two 32-byte sectors, where 32
// rays of a detector row, spread across x-y, touched about 32. A block holds
// kWarps warps on neighbouring columns; blockIdx.z is the view.
//
// The flat volume is indexed with 32-bit integers, as the JAX package's
// march indexes it; the wrappers refuse volumes of 2^31 voxels or more.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace joseph {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpV = 32;                  // a warp's rays along v (the rest of its 32 along u)
constexpr int kWarps = 4;                   // warps of a block
constexpr int kThreads = 32 * kWarps;       // rays of a block
constexpr int kBlockU = kThreads / kWarpV;  // a block's rays along u

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

// the detector pixel (iu, iv) of this thread: a warp is kWarpV rows x
// 32 / kWarpV columns, a block kWarpV rows x kBlockU columns; the grid is
// (columns / kBlockU, rows / kWarpV, views)
__device__ __forceinline__ void ray_of_thread(int& iu, int& iv) {
  iv = blockIdx.y * kWarpV + threadIdx.x % kWarpV;
  iu = blockIdx.x * kBlockU + threadIdx.x / kWarpV;
}

inline dim3 grid_of(int P, int nv, int nu) {
  return dim3((nu + kBlockU - 1) / kBlockU, (nv + kWarpV - 1) / kWarpV, P);
}

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

// the index-space coordinate of step i on one axis (source s, direction d,
// first voxel centre o, spacing sp)
__device__ __forceinline__ float coord(const Args& a, const Ray& r, float s, float d, float o,
                                       float sp, int i) {
  const float t = r.t_near + ((float)i + 0.5f) * a.step_mm;
  return ((s + d * t) - o) / sp;
}

// narrows [first, last] to the steps of [0, n) at which `holds`, true on a
// prefix or a suffix of them, is true
template <class Holds>
__device__ __forceinline__ void narrow(int n, Holds holds, int& first, int& last) {
  const bool at_0 = holds(0), at_end = holds(n - 1);
  if (at_0 && at_end) return;
  if (!at_0 && !at_end) {
    last = -1;
    return;
  }
  int lo = 0, hi = n - 1;  // holds(lo) == at_0 != holds(hi)
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (holds(mid) == at_0)
      lo = mid;
    else
      hi = mid;
  }
  if (at_0)
    last = last < lo ? last : lo;
  else
    first = first > hi ? first : hi;
}

// the ray's run of steps inside the volume, [first, last]; (n_steps, -1)
// when it has none
__device__ __forceinline__ void step_range(const Args& a, const Ray& r, int& first, int& last) {
  first = 0;
  last = a.n_steps - 1;
  auto axis = [&](float s, float d, float o, float sp, int n_vox) {
    const float top = (float)(n_vox - 1);
    narrow(a.n_steps, [&](int i) { return coord(a, r, s, d, o, sp, i) >= 0.0f; }, first, last);
    narrow(a.n_steps, [&](int i) { return coord(a, r, s, d, o, sp, i) <= top; }, first, last);
  };
  if (last >= 0) axis(r.sx, r.dx, a.ox, a.sx, a.nx);
  if (last >= first) axis(r.sy, r.dy, a.oy, a.sy, a.ny);
  if (last >= first) axis(r.sz, r.dz, a.oz, a.sz, a.nz);
  if (last < first) {
    first = a.n_steps;
    last = -1;
  }
}

struct Sample {
  int base;          // flat index of the lower corner, z fastest
  float fx, fy, fz;  // fractional offsets from it
};

// step i of the ray, a step of its run inside the volume: inside, so the
// reference's clip of x, y, z changes nothing and the corner is >= 0
__device__ __forceinline__ Sample sample_at(const Args& a, const Ray& r, int i) {
  const float x = coord(a, r, r.sx, r.dx, a.ox, a.sx, i);
  const float y = coord(a, r, r.sy, r.dy, a.oy, a.sy, i);
  const float z = coord(a, r, r.sz, r.dz, a.oz, a.sz, i);
  int x0 = __float2int_rz(floorf(x)), y0 = __float2int_rz(floorf(y)),
      z0 = __float2int_rz(floorf(z));
  x0 = x0 > a.nx - 2 ? a.nx - 2 : x0;
  y0 = y0 > a.ny - 2 ? a.ny - 2 : y0;
  z0 = z0 > a.nz - 2 ? a.nz - 2 : z0;
  Sample s;
  s.fx = x - (float)x0;
  s.fy = y - (float)y0;
  s.fz = z - (float)z0;
  s.base = (x0 * a.ny + y0) * a.nz + z0;
  return s;
}

}  // namespace joseph
