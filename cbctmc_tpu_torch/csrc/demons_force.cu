// demons_force: the force of one demons iteration. The moving image is pulled
// through the displacement field (trilinear, edge-clamped), its difference
// from the fixed image is taken inside the mask, and the Thirion force gives
// the update field:
//   warped = moving(x + dvf(x)),  diff = (warped - fixed) * mask,
//   scale = -tau * diff / (grad_sq + diff * diff + 1e-9),
//   update = (gx, gy, gz) * scale.
// A second entry point, warp_volume, is the pull alone.
//
// Replaces: the XLA code of cbctmc_tpu/registration/demons.py:
// _trilinear_sample (:54), warp_volume (:78) and the force in _demons_level's
// body (:130-134). The JAX package has no Pallas kernel for it; this is a
// hand kernel of the port. Plain versions:
// cbctmc_tpu_torch/registration/demons.py::demons_force_reference and
// ::warp_volume_reference. Every value is the plain version's to the bit: the
// same operations in the same order, each rounded on its own (-fmad=false),
// the division correctly rounded, the flat index in int32 as the JAX code's.
//
// Bound on the H100: bytes. A voxel reads the field (12 B), the fixed image,
// the mask, the three gradients and grad_sq of the level (24 B), the moving
// image's eight corners (4 B once each over the volume: neighbouring threads
// share them through L1) and writes the update (12 B): 52 B, 0.20 ms at
// (350, 260, 142) and 3.35 TB/s; 13 operations for the sample's weights
// and 16 for the sums and the force, far under the byte time.
//
// Design: one thread a voxel, 256 a block, consecutive threads along the
// contiguous z axis, so every stream is read coalesced and the gather of the
// corners stays inside a few cache lines per warp (the field is smooth).
// The level's gradients are computed once per level in plain PyTorch
// (jnp.gradient's arithmetic), as the JAX code computes them outside its loop.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// jnp.clip / torch.clamp: the lower bound first, then the upper; NaN stays NaN
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

__device__ __forceinline__ int clip(int x, int lo, int hi) {
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

// _trilinear_sample at voxel (i, j, k) + (d0, d1, d2), op for op
__device__ __forceinline__ float sample(const float* __restrict__ vol, int nx, int ny, int nz,
                                        int i, int j, int k, float d0, float d1, float d2) {
  const float x = clip((float)i + d0, 0.f, (float)nx - 1.f);
  const float y = clip((float)j + d1, 0.f, (float)ny - 1.f);
  const float z = clip((float)k + d2, 0.f, (float)nz - 1.f);
  const int x0 = clip((int)floorf(x), 0, nx - 2);
  const int y0 = clip((int)floorf(y), 0, ny - 2);
  const int z0 = clip((int)floorf(z), 0, nz - 2);
  const float fx = x - (float)x0, fy = y - (float)y0, fz = z - (float)z0;
  const int sx = ny * nz, sy = nz;
  const float* c = vol + (x0 * sx + y0 * sy + z0);
  const float gz = 1.f - fz, gy = 1.f - fy, gx = 1.f - fx;
  const float c00 = c[0] * gz + c[1] * fz;
  const float c01 = c[sy] * gz + c[sy + 1] * fz;
  const float c10 = c[sx] * gz + c[sx + 1] * fz;
  const float c11 = c[sx + sy] * gz + c[sx + sy + 1] * fz;
  const float c0 = c00 * gy + c01 * fy;
  const float c1 = c10 * gy + c11 * fy;
  return c0 * gx + c1 * fx;
}

__global__ void __launch_bounds__(kThreads)
demons_force_kernel(const float* __restrict__ moving, const float* __restrict__ fixed,
                    const float* __restrict__ mask, const float* __restrict__ dvf,
                    const float* __restrict__ grads, int nx, int ny, int nz, float neg_tau,
                    float* __restrict__ update) {
  const int n = nx * ny * nz;
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= n) return;
  const int k = v % nz, t = v / nz, j = t % ny, i = t / ny;
  const float warped = sample(moving, nx, ny, nz, i, j, k, dvf[v], dvf[n + v], dvf[2 * n + v]);
  const float diff = (warped - fixed[v]) * mask[v];
  const float denom = (grads[3 * n + v] + diff * diff) + static_cast<float>(1e-9);
  const float scale = (neg_tau * diff) / denom;
  update[v] = grads[v] * scale;
  update[n + v] = grads[n + v] * scale;
  update[2 * n + v] = grads[2 * n + v] * scale;
}

__global__ void __launch_bounds__(kThreads)
warp_volume_kernel(const float* __restrict__ vol, const float* __restrict__ dvf, int nx, int ny,
                   int nz, float* __restrict__ out) {
  const int n = nx * ny * nz;
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= n) return;
  const int k = v % nz, t = v / nz, j = t % ny, i = t / ny;
  out[v] = sample(vol, nx, ny, nz, i, j, k, dvf[v], dvf[n + v], dvf[2 * n + v]);
}

// the wrapper refuses the rest; repeated here so a direct call cannot overrun
bool valid(int nx, int ny, int nz) {
  return nx >= 2 && ny >= 2 && nz >= 2 && (long long)nx * ny * nz * 4 <= 0x7fffffffLL;
}

}  // namespace

extern "C" int demons_force_launch(const float* moving, const float* fixed, const float* mask,
                                   const float* dvf, const float* grads, int nx, int ny, int nz,
                                   float neg_tau, float* update, void* stream) {
  if (!valid(nx, ny, nz)) return (int)cudaErrorInvalidValue;
  const int n = nx * ny * nz;
  demons_force_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      moving, fixed, mask, dvf, grads, nx, ny, nz, neg_tau, update);
  return (int)cudaGetLastError();
}

extern "C" int warp_volume_launch(const float* vol, const float* dvf, int nx, int ny, int nz,
                                  float* out, void* stream) {
  if (!valid(nx, ny, nz)) return (int)cudaErrorInvalidValue;
  const int n = nx * ny * nz;
  warp_volume_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      vol, dvf, nx, ny, nz, out);
  return (int)cudaGetLastError();
}
