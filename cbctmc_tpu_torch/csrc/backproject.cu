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
// the volume 215 MB read and written, against ~45 floating-point operations
// per voxel-view (3.4e9 voxel-views). The four taps of a sample are
// neighbours of the voxels next to it along z, which project to
// neighbouring detector rows, so the gathers are served by L1/L2.
//
// Design: one thread per voxel, consecutive threads on consecutive z (the
// volume's contiguous axis: coalesced read and write of the volume, and
// taps that neighbouring threads share); the chunk's per-view geometry
// (source, beam direction, u axis: 9 floats per view) staged in shared
// memory; the sum kept in a register. The operation sequence is the JAX
// one (depth clamp, sdd / depth, the inside test before the clip, the
// truncating integer conversion, the four terms summed in order), built
// with -fmad=false and without fast math, so the plain version agrees to
// the bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

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

// at global scope: the profiler reports the kernel under this name
__global__ void backproject_kernel(BackprojectArgs a, const float* __restrict__ views) {
  extern __shared__ float geo[];  // [P, 9]: source, direction, u axis
  for (int k = threadIdx.x; k < 9 * a.P; k += blockDim.x) geo[k] = views[k];
  __syncthreads();

  const long long n_vox = (long long)a.nx * a.ny * a.nz;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_vox) return;
  const int iz = (int)(i % a.nz);
  const int iy = (int)((i / a.nz) % a.ny);
  const int ix = (int)(i / ((long long)a.nz * a.ny));
  const float X = a.ox + a.sx * (float)ix;
  const float Y = a.oy + a.sy * (float)iy;
  const float Z = a.oz + a.sz * (float)iz;
  const float nu_1 = (float)(a.nu - 1), nv_1 = (float)(a.nv - 1);

  float acc = 0.0f;
  for (int p = 0; p < a.P; ++p) {
    const float* g9 = geo + 9 * p;
    const float* g = a.filtered + (size_t)p * a.nv * a.nu;
    float rx = X - g9[0], ry = Y - g9[1], rz = Z - g9[2];
    float depth = rx * g9[3] + ry * g9[4];  // the beam direction has no z part
    depth = fmaxf(depth, 1e-3f);
    float scale = a.sdd / depth;
    float u = (rx * g9[6] + ry * g9[7]) * scale;
    float v = rz * scale;
    float pu = (u - a.u0) * a.inv_du;
    float pv = (v - a.v0) * a.inv_dv;
    bool inside = (pu >= 0.0f) && (pu <= nu_1) && (pv >= 0.0f) && (pv <= nv_1);
    pu = fminf(fmaxf(pu, 0.0f), nu_1);
    pv = fminf(fmaxf(pv, 0.0f), nv_1);
    int iu = __float2int_rz(pu), iv = __float2int_rz(pv);
    iu = iu < 0 ? 0 : (iu > a.nu - 2 ? a.nu - 2 : iu);
    iv = iv < 0 ? 0 : (iv > a.nv - 2 ? a.nv - 2 : iv);
    float fu = pu - (float)iu, fv = pv - (float)iv;
    const float* t = g + (size_t)iv * a.nu + iu;
    float g00 = __ldg(t), g01 = __ldg(t + 1), g10 = __ldg(t + a.nu), g11 = __ldg(t + a.nu + 1);
    float sample = g00 * (1.0f - fu) * (1.0f - fv) + g01 * fu * (1.0f - fv)
                   + g10 * (1.0f - fu) * fv + g11 * fu * fv;
    float w = a.sad / depth;
    w = w * w;
    acc = acc + (inside ? sample * w : 0.0f);
  }
  a.vol[i] = a.vol[i] + acc * a.angular_weight;
}

extern "C" int backproject_launch(const float* filtered, int P, int nv, int nu,
                                  const float* views, float u0, float inv_du, float v0,
                                  float inv_dv, int nx, int ny, int nz, float ox, float oy,
                                  float oz, float sx, float sy, float sz, float sad, float sdd,
                                  float angular_weight, float* vol, void* stream) {
  const long long n_vox = (long long)nx * ny * nz;
  if (n_vox > 0 && P > 0) {
    BackprojectArgs a{filtered, P, nv, nu, u0, inv_du, v0, inv_dv, nx, ny, nz, ox, oy, oz,
                      sx, sy, sz, sad, sdd, angular_weight, vol};
    const int threads = 256;
    const long long blocks = (n_vox + threads - 1) / threads;
    const size_t shared = sizeof(float) * 9 * (size_t)P;
    if (shared > 48 * 1024) return (int)cudaErrorInvalidValue;
    backproject_kernel<<<(unsigned)blocks, threads, shared, (cudaStream_t)stream>>>(a, views);
  }
  return (int)cudaGetLastError();
}
