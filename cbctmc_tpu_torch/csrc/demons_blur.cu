// demons_blur: one pass of the demons' separable Gaussian blur, along one axis
// of C volumes [C, nx, ny, nz] (C = 1 for the mask, 3 for a field), with the
// edge replicated:
//   out[.., p, ..] = sum_j src[.., clamp(p + j - r, 0, len - 1), ..] * w[j],
// the taps summed in order j = 0 .. 2r. The first pass of the diffusion blur
// takes the field and the update and blurs their sum (src = in + addend),
// which saves the sum's own pass over the field.
//
// Replaces: the XLA code of cbctmc_tpu/registration/demons.py::_blur3d (:36):
// per axis an edge pad and a one-channel conv_general_dilated; the JAX package
// has no Pallas kernel for it; this is a hand kernel of the port. Plain
// version: cbctmc_tpu_torch/registration/demons.py::blur_axis_reference, the
// same products summed in the same order, each rounded on its own
// (-fmad=false), so every value is the plain version's to the bit.
//
// Bound on the H100: bytes. A pass reads each value once and writes it once:
// 8 B a voxel and channel (12 more a voxel for the folded addend), 24 B a
// voxel at C = 3, 0.093 ms at (350, 260, 142); 2r + 1 products and 2r sums a
// value (17 at radius 4) are far under it.
//
// Design: one thread a value, 256 a block, consecutive threads along the
// contiguous z axis (grid.y the channel), so the taps of the x and y passes are
// coalesced rows and those of the z pass overlap inside a warp's cache lines;
// the radius is a template parameter, so the taps unroll into registers.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRadius = 8;

struct Taps {
  float w[2 * kMaxRadius + 1];
};

template <int R, bool kAdd>
__global__ void __launch_bounds__(kThreads)
demons_blur_kernel(const float* __restrict__ in, const float* __restrict__ addend, int n, int len,
                   int stride, Taps taps, float* __restrict__ out) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= n) return;
  const long long base = (long long)blockIdx.y * n;
  const float* src = in + base;
  const float* add = kAdd ? addend + base : nullptr;
  const int pos = (v / stride) % len;
  const int row = v - pos * stride;
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j <= 2 * R; ++j) {
    int q = pos + j - R;
    q = q < 0 ? 0 : (q > len - 1 ? len - 1 : q);
    const int idx = row + q * stride;
    float x = src[idx];
    if (kAdd) x = x + add[idx];
    const float t = x * taps.w[j];
    acc = j == 0 ? t : acc + t;
  }
  out[base + v] = acc;
}

template <int R>
void launch(const float* in, const float* addend, int channels, int n, int len, int stride,
            const Taps& taps, float* out, cudaStream_t s) {
  const dim3 grid((n + kThreads - 1) / kThreads, channels);
  if (addend)
    demons_blur_kernel<R, true><<<grid, kThreads, 0, s>>>(in, addend, n, len, stride, taps, out);
  else
    demons_blur_kernel<R, false><<<grid, kThreads, 0, s>>>(in, addend, n, len, stride, taps, out);
}

}  // namespace

extern "C" int demons_blur_launch(const float* in, const float* addend, int channels, int nx,
                                  int ny, int nz, int axis, const float* taps, int n_taps,
                                  float* out, void* stream) {
  const int radius = n_taps / 2;
  if (n_taps % 2 != 1 || radius < 1 || radius > kMaxRadius || channels < 1 || channels > 65535 ||
      axis < 0 || axis > 2 || nx < 1 || ny < 1 || nz < 1 ||
      (long long)nx * ny * nz * channels > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Taps t{};
  for (int j = 0; j < n_taps; ++j) t.w[j] = taps[j];
  const int n = nx * ny * nz;
  const int len = axis == 0 ? nx : (axis == 1 ? ny : nz);
  const int stride = axis == 0 ? ny * nz : (axis == 1 ? nz : 1);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (radius) {
#define DEMONS_BLUR_CASE(R) \
  case R:                   \
    launch<R>(in, addend, channels, n, len, stride, t, out, s); \
    break;
    DEMONS_BLUR_CASE(1) DEMONS_BLUR_CASE(2) DEMONS_BLUR_CASE(3) DEMONS_BLUR_CASE(4)
    DEMONS_BLUR_CASE(5) DEMONS_BLUR_CASE(6) DEMONS_BLUR_CASE(7) DEMONS_BLUR_CASE(8)
#undef DEMONS_BLUR_CASE
  }
  return (int)cudaGetLastError();
}
