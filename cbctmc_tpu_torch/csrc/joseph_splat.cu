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
// once, against the march's 21 operations for placing every sample inside
// the volume and 41 more for it (floors and offsets, the eight weights,
// their products with the ray's value and the eight additions into the
// volume).
//
// What held the first version back, and the design's answer (joseph.cuh):
// each sample issued eight global atomicAdd from 32 rays of a detector row,
// ~32 sectors a warp instruction, 3.85e9 a view: the L2's atomic units set
// its pace, not its arithmetic. Now
// - a warp holds 32 rays along v (the volume's contiguous z) and runs the
//   union of its rays' runs inside the volume (step_range) together, so at
//   a step its lanes' corners lie on a short run of z;
// - neighbouring lanes whose samples share a lower corner (~4 at the
//   reference's pixel pitch) sum their eight weighted values with shuffles
//   (sum_runs) before one lane of the run carries them to the volume: eight
//   atomicAdd a run instead of eight a ray.
// What is left is issue: the march's (as in joseph_project: three correctly
// rounded divisions a sample) and the sums' shuffles; the atomics that
// remain are a small part. Summing into a shared-memory brick of the volume
// per block, and handing a run's upper-z sums to the next run one z above,
// were slower (scripts/compare_joseph_kernels.py, PERF.md).
// The order in which the additions reach a voxel is neither the
// reference's nor the same from run to run, so the result is held to its
// plain version by a tolerance and to joseph_project by the adjoint identity
// <A x, y> = <x, A^T y>. A ray whose value is 0 adds nothing and runs no
// step (adding +0 or -0 leaves every voxel as it is).

#include "joseph.cuh"

namespace {

// Sums w over each run of neighbouring lanes with equal `cell` (a
// segmented suffix sum: lane l ends with the sum over l .. the run's last
// lane); true on the run's first lane, which then holds the run's sums.
__device__ __forceinline__ bool sum_runs(int cell, float (&w)[8]) {
  const int lane = threadIdx.x & 31;
  const int before = __shfl_up_sync(joseph::kFull, cell, 1);  // every lane takes part
  const bool head = lane == 0 || before != cell;
  const unsigned heads = __ballot_sync(joseph::kFull, head);
  const unsigned later = lane == 31 ? 0u : heads >> (lane + 1);  // heads above this lane
  const int end = later ? lane + __ffs(later) - 1 : 31;           // the run's last lane
  const int longest = __reduce_max_sync(joseph::kFull, end - lane + 1);
  for (int off = 1; off < longest; off <<= 1) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float o = __shfl_down_sync(joseph::kFull, w[k], off);
      if (lane + off <= end) w[k] += o;
    }
  }
  return head;
}

}  // namespace

__global__ void __launch_bounds__(joseph::kThreads)
    joseph_splat_kernel(joseph::Args a, const float* __restrict__ g, float* __restrict__ vol) {
  int iu, iv;
  joseph::ray_of_thread(iu, iv);
  const int p = blockIdx.z;
  // every lane stays to the end (the shuffles need the whole warp); a lane
  // off the panel or of value 0 runs no step
  const float value =
      iu < a.nu && iv < a.nv ? g[((int64_t)p * a.nv + iv) * a.nu + iu] * a.step_mm : 0.0f;
  joseph::Ray r{};
  int first = a.n_steps, last = -1;
  if (value != 0.0f) {
    r = joseph::make_ray(a, p, iu, iv);
    joseph::step_range(a, r, first, last);
  }
  const int sy = a.nz, sx = a.ny * a.nz;
  const int lane = threadIdx.x & 31;
  const int w_first = __reduce_min_sync(joseph::kFull, first);
  const int w_last = __reduce_max_sync(joseph::kFull, last);
  for (int i = w_first; i <= w_last; ++i) {
    const bool live = i >= first && i <= last;
    float w[8];
    int cell = -1 - lane;  // a run of its own
    if (live) {
      const joseph::Sample s = joseph::sample_at(a, r, i);
      const float gx0 = 1.0f - s.fx, gx1 = s.fx;
      const float gy0 = 1.0f - s.fy, gy1 = s.fy;
      const float gz0 = 1.0f - s.fz, gz1 = s.fz;
      w[0] = ((gx0 * gy0) * gz0) * value;
      w[1] = ((gx0 * gy0) * gz1) * value;
      w[2] = ((gx0 * gy1) * gz0) * value;
      w[3] = ((gx0 * gy1) * gz1) * value;
      w[4] = ((gx1 * gy0) * gz0) * value;
      w[5] = ((gx1 * gy0) * gz1) * value;
      w[6] = ((gx1 * gy1) * gz0) * value;
      w[7] = ((gx1 * gy1) * gz1) * value;
      cell = s.base;
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) w[k] = 0.0f;
    }
    if (sum_runs(cell, w) && live) {
      float* c = vol + cell;
      atomicAdd(c, w[0]);
      atomicAdd(c + 1, w[1]);
      atomicAdd(c + sy, w[2]);
      atomicAdd(c + sy + 1, w[3]);
      atomicAdd(c + sx, w[4]);
      atomicAdd(c + sx + 1, w[5]);
      atomicAdd(c + sx + sy, w[6]);
      atomicAdd(c + sx + sy + 1, w[7]);
    }
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
    if (P > 65535 || nv > 65535 * joseph::kWarpV) return (int)cudaErrorInvalidValue;
    joseph::Args a{nx, ny, nz, ox, oy, oz, sx, sy, sz, lox, loy, loz, hix, hiy, hiz,
                   evx, evy, evz, views, pixel_u, pixel_v, P, nv, nu, n_steps, step_mm};
    joseph_splat_kernel<<<joseph::grid_of(P, nv, nu), joseph::kThreads, 0,
                          (cudaStream_t)stream>>>(a, g, vol);
  }
  return (int)cudaGetLastError();
}
