// backproject: FDK's voxel-driven cone-beam backprojection of one chunk of
// filtered views into the volume.
//
// Replaces: the XLA program cbctmc_tpu/recon/fdk.py::_backproject_into (a
// fori_loop over the chunk's views, each a full-volume gather of the
// bilinear sample). The JAX package has no Pallas kernel for it; this is a
// hand kernel of the port. Plain version:
// cbctmc_tpu_torch/recon/fdk.py::backproject_into_reference.
//
// For every voxel (x, y, z) of the [nx, ny, nz] grid (z fastest) and every
// view of the chunk, in view order: the voxel's cone-beam detector
// coordinates (pu, pv), the bilinear sample of the filtered view there,
// weighted by (sad / depth)^2 where the coordinates fall on the detector;
// the sum over the chunk then goes into the volume by one multiply-add:
// vol = vol + acc * angular_weight.
//
// Bound on the H100: operations. At the production shapes (464 x 464 x 250
// voxels, 64 views of 768 x 1024) the chunk's filtered views are 201 MB and
// the volume 215 MB read and written, against 23 floating-point
// operations per voxel-view that depend on z (3.4e9 voxel-views) and 21 per
// column-view for the rest.
//
// Design: column-hoisted and tiled in x-y. The beam direction has no z
// part, so the depth, sdd / depth, (sad / depth)^2 and the whole u half of
// the detector coordinate (u, pu, the u half of the inside test, iu, fu)
// are the same for every voxel of an (x, y) column: one thread owns one
// column and a segment of kZs = 8 consecutive z voxels (16 took 56
// registers and measured slower on the H100), computes that prologue once
// per view (two divisions per column-view instead of per voxel-view) and
// keeps the segment's 8 sums in registers. A block is a tile of 8 (y) x 16
// (x) columns and one z segment; the 32 threads of a warp sit on an 8 x 4
// patch of neighbouring columns, which for one z project to neighbouring
// detector columns on one to three rows, so a tap load touches a few
// sectors (a warp along z touched ~32 rows, one per voxel). The chunk's
// per-view geometry (source, beam direction, u axis: 9 floats per view) is
// staged in shared memory; the volume is read and written once per chunk,
// two words at a time where the segment is 8-byte aligned. Every hoisted
// quantity is computed by the same operations on the same operands as the
// JAX order (depth clamp, sdd / depth, the inside test before the clip, the
// truncating integer conversion, the four terms summed in order), built
// with -fmad=false and without fast math, so the plain version agrees to
// the bit. No texture filtering: its 8-bit weights are not the bilinear.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kZs = 8;       // z voxels per thread
constexpr int kBlockY = 8;   // threads of a block along y (threadIdx.x)
constexpr int kBlockX = 16;  // and along x (threadIdx.y)

struct BackprojectArgs {
  const float* filtered;  // [P, nv, nu]
  int P, nv, nu;
  float u0, inv_du, v0, inv_dv;
  int nx, ny, nz;
  float ox, oy, oz;  // centre of voxel 0 [mm]
  float sx, sy, sz;  // voxel spacing [mm]
  float sad, sdd, angular_weight;
  float* vol;  // [nx, ny, nz], updated in place
};

}  // namespace

// at global scope: the profiler reports the kernel under this name.
// threadIdx.x runs along y, threadIdx.y along x, blockIdx.z over the z
// segments of kZs voxels
__global__ void backproject_kernel(BackprojectArgs a, const float* __restrict__ views) {
  extern __shared__ float geo[];  // [P, 9]: source, direction, u axis
  const int tid = threadIdx.y * kBlockY + threadIdx.x;
  for (int k = tid; k < 9 * a.P; k += kBlockY * kBlockX) geo[k] = views[k];
  __syncthreads();

  const int iy = blockIdx.x * kBlockY + threadIdx.x;
  const int ix = blockIdx.y * kBlockX + threadIdx.y;
  const int z0 = blockIdx.z * kZs;
  if (ix >= a.nx || iy >= a.ny) return;
  const int nzs = a.nz - z0 < kZs ? a.nz - z0 : kZs;  // the ragged last segment
  const float X = a.ox + a.sx * (float)ix;
  const float Y = a.oy + a.sy * (float)iy;
  const float nu_1 = (float)(a.nu - 1), nv_1 = (float)(a.nv - 1);
  float Z[kZs], acc[kZs];
#pragma unroll
  for (int j = 0; j < kZs; ++j) {
    Z[j] = a.oz + a.sz * (float)(z0 + j);
    acc[j] = 0.0f;
  }

  for (int p = 0; p < a.P; ++p) {
    const float* g9 = geo + 9 * p;
    // the column's prologue: everything that does not depend on z
    const float rx = X - g9[0], ry = Y - g9[1];
    float depth = rx * g9[3] + ry * g9[4];  // the beam direction has no z part
    depth = fmaxf(depth, 1e-3f);
    const float scale = a.sdd / depth;
    const float u = (rx * g9[6] + ry * g9[7]) * scale;
    float pu = (u - a.u0) * a.inv_du;
    const bool inside_u = (pu >= 0.0f) && (pu <= nu_1);
    pu = fminf(fmaxf(pu, 0.0f), nu_1);
    int iu = __float2int_rz(pu);
    iu = iu < 0 ? 0 : (iu > a.nu - 2 ? a.nu - 2 : iu);
    const float fu = pu - (float)iu;
    const float gu = 1.0f - fu;
    float w = a.sad / depth;
    w = w * w;
    const float sz0 = g9[2];
    const float* col = a.filtered + (size_t)p * a.nv * a.nu + iu;

#pragma unroll
    for (int j = 0; j < kZs; ++j) {
      if (j < nzs) {
        const float rz = Z[j] - sz0;
        const float v = rz * scale;
        float pv = (v - a.v0) * a.inv_dv;
        const bool inside = inside_u && (pv >= 0.0f) && (pv <= nv_1);
        pv = fminf(fmaxf(pv, 0.0f), nv_1);
        int iv = __float2int_rz(pv);
        iv = iv < 0 ? 0 : (iv > a.nv - 2 ? a.nv - 2 : iv);
        const float fv = pv - (float)iv;
        const float gv = 1.0f - fv;
        const float* t = col + (size_t)iv * a.nu;
        const float g00 = __ldg(t), g01 = __ldg(t + 1);
        const float g10 = __ldg(t + a.nu), g11 = __ldg(t + a.nu + 1);
        const float sample = g00 * gu * gv + g01 * fu * gv + g10 * gu * fv + g11 * fu * fv;
        acc[j] = acc[j] + (inside ? sample * w : 0.0f);
      }
    }
  }

  float* out = a.vol + ((size_t)ix * a.ny + iy) * a.nz + z0;
  if (nzs == kZs && (reinterpret_cast<uintptr_t>(out) & 7u) == 0) {
    float2* out2 = reinterpret_cast<float2*>(out);
#pragma unroll
    for (int j = 0; j < kZs / 2; ++j) {
      float2 o = out2[j];
      o.x = o.x + acc[2 * j] * a.angular_weight;
      o.y = o.y + acc[2 * j + 1] * a.angular_weight;
      out2[j] = o;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kZs; ++j)
      if (j < nzs) out[j] = out[j] + acc[j] * a.angular_weight;
  }
}

extern "C" int backproject_launch(const float* filtered, int P, int nv, int nu,
                                  const float* views, float u0, float inv_du, float v0,
                                  float inv_dv, int nx, int ny, int nz, float ox, float oy,
                                  float oz, float sx, float sy, float sz, float sad, float sdd,
                                  float angular_weight, float* vol, void* stream) {
  if ((long long)nx * ny * nz > 0 && P > 0) {
    BackprojectArgs a{filtered, P, nv, nu, u0, inv_du, v0, inv_dv, nx, ny, nz, ox, oy, oz,
                      sx, sy, sz, sad, sdd, angular_weight, vol};
    const size_t shared = sizeof(float) * 9 * (size_t)P;
    if (shared > 48 * 1024) return (int)cudaErrorInvalidValue;
    const dim3 block(kBlockY, kBlockX);
    const dim3 grid((ny + kBlockY - 1) / kBlockY, (nx + kBlockX - 1) / kBlockX,
                    (nz + kZs - 1) / kZs);
    backproject_kernel<<<grid, block, shared, (cudaStream_t)stream>>>(a, views);
  }
  return (int)cudaGetLastError();
}
