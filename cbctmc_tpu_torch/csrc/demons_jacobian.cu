// demons_jacobian: the demons' fold check. For the new field of an iteration
// it forms the Jacobian determinant of the transform x + new(x) by central
// differences (one-sided at the volume's faces, as jnp.gradient) and keeps
// the old field's value wherever the determinant falls below jac_min:
//   out[c] = det(I + grad new) < jac_min ? old[c] : new[c]   (c = 0, 1, 2).
//
// Replaces: the XLA code of cbctmc_tpu/registration/demons.py::
// jacobian_determinant (:102) and the select in _demons_level's body
// (:138-141). The JAX package has no Pallas kernel for it; this is a hand
// kernel of the port. Plain version:
// cbctmc_tpu_torch/registration/demons.py::jacobian_select_reference, the
// same differences, products and sums in the same order, each rounded on its
// own (-fmad=false), so every value is the plain version's to the bit.
//
// Bound on the H100: bytes. A voxel reads the new field (12 B; its six
// neighbours per channel come from L1 and L2), the old field (12 B) and
// writes the result (12 B): 36 B, 0.14 ms at (350, 260, 142); 9 differences,
// 9 halvings and 17 operations for the determinant are under it.
//
// Design: one thread a voxel, 256 a block, consecutive threads along the
// contiguous z axis; the z differences overlap inside a warp's cache lines,
// the x and y ones are coalesced rows one plane or one row away.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// d f / d axis at the voxel v whose coordinate along the axis is pos
__device__ __forceinline__ float gradient(const float* __restrict__ f, int v, int pos, int len,
                                          int stride) {
  if (pos == 0) return f[v + stride] - f[v];
  if (pos == len - 1) return f[v] - f[v - stride];
  return (f[v + stride] - f[v - stride]) * 0.5f;
}

__global__ void __launch_bounds__(kThreads)
demons_jacobian_kernel(const float* __restrict__ nw, const float* __restrict__ old, int nx, int ny,
                       int nz, float jac_min, float* __restrict__ out) {
  const int n = nx * ny * nz;
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= n) return;
  const int k = v % nz, t = v / nz, j = t % ny, i = t / ny;
  float m[3][3];  // m[c][a] = d new_c / d axis_a + (c == a)
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float* f = nw + (long long)c * n;
    m[c][0] = gradient(f, v, i, nx, ny * nz) + (c == 0 ? 1.f : 0.f);
    m[c][1] = gradient(f, v, j, ny, nz) + (c == 1 ? 1.f : 0.f);
    m[c][2] = gradient(f, v, k, nz, 1) + (c == 2 ? 1.f : 0.f);
  }
  const float a = m[1][1] * m[2][2] - m[1][2] * m[2][1];
  const float b = m[1][0] * m[2][2] - m[1][2] * m[2][0];
  const float d = m[1][0] * m[2][1] - m[1][1] * m[2][0];
  const float det = (m[0][0] * a - m[0][1] * b) + m[0][2] * d;
  const float* src = det < jac_min ? old : nw;
  out[v] = src[v];
  out[n + v] = src[n + v];
  out[2 * n + v] = src[2 * n + v];
}

}  // namespace

extern "C" int demons_jacobian_launch(const float* nw, const float* old, int nx, int ny, int nz,
                                      float jac_min, float* out, void* stream) {
  if (nx < 2 || ny < 2 || nz < 2 || (long long)nx * ny * nz * 3 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int n = nx * ny * nz;
  demons_jacobian_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      nw, old, nx, ny, nz, jac_min, out);
  return (int)cudaGetLastError();
}
