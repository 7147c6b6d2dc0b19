// primary_trace: relative-density path lengths of detector rays through the
// packed voxel scene (Amanatides-Woo traversal with clearance-box jumps).
//
// Replaces: the XLA loop cbctmc_tpu/engine/primary.py::_trace_chunk (a
// jax.lax.while_loop that steps every active ray once per trip, carrying
// the [n, n_mat] accumulator through device memory on every trip). The JAX
// package has no Pallas kernel for it; this is a hand kernel of the port.
// Plain version: cbctmc_tpu_torch/engine/primary.py::primary_trace_reference.
//
// Computes, for every ray i from src along dirs[i], L[i, m] = sum over the
// crossed cells of seg * rho * inv_rho[m] for the cell's (remapped)
// material m. A cell is one voxel, or the 2^k box of a voxel whose word
// carries clearance level k (every voxel of the box shares its word), so a
// uniform region is crossed in one step.
//
// Bound on the H100: operations, narrowly, at the full view (1,419,264 rays
// through the 500^3 CatPhan, ~5.6e7 steps): ~50 floating-point operations
// per step against 12 B of direction and n_mat * 4 B of L per ray and 4 B
// per distinct voxel word the rays cross (the two bounds are 0.042 and
// 0.027 ms). What the kernel cannot avoid is one dependent chain per ray
// (position, division, gather, next boundary), so it runs bound by
// latency: the design keeps enough rays in flight and lets the cache serve
// the words neighbouring rays share.
//
// Design: one thread per ray walking its ray to the end, so the JAX loop's
// global trip counter becomes a per-ray step cap (max_iters) with the same
// result: the JAX loop steps a ray on every trip until it leaves or the
// trip count reaches the cap. The operation sequence is the JAX one, op for
// op (multiplication by 1/d, true divisions by the voxel size and the span,
// the 1e-4 nudges, the 1e-5 exit test), built with -fmad=false and without
// fast math, so the plain version agrees to the bit. Each ray adds into its
// own row of L (zeroed here), in step order, as the JAX one-hot sum does.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMatShift = 27;
constexpr int kAirShift = 24;
constexpr uint32_t kDenMask = (1u << 21) - 1u;

struct TraceArgs {
  const uint32_t* packed;
  int nx, ny, nz;
  float vsx, vsy, vsz;    // voxel size [cm]
  float den_scale;
  const float* inv_rho;   // [n_mat]
  const int32_t* remap;   // [n_all] material -> column of L
  int n_all, n_mat;
  float sx, sy, sz;       // source [cm]
  const float* dirs;      // [n, 3]
  int n, max_iters;
  float* L;               // [n, n_mat]
  int32_t* steps;         // [n] gathers per ray, or null
};

__device__ __forceinline__ float safe_dir(float d) {
  return fabsf(d) < 1e-9f ? 1e-9f : d;
}

__device__ __forceinline__ int cell(float p, float vs, int n) {
  // floor(p / vs) as int32 (cvt saturates), clipped to [0, n - 1]
  int i = __float2int_rz(floorf(p / vs));
  return i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
}

__device__ __forceinline__ float axis_step(float p, float d, float inv_d, float span) {
  float base = floorf(p / span) * span;
  float up = (base + span - p) * inv_d;
  float dn = (base - p) * inv_d;
  return d > 0.0f ? up : dn;
}

}  // namespace

// at global scope: the profiler reports the kernel under this name
__global__ void primary_trace_kernel(TraceArgs a) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  float* row = a.L + (size_t)i * a.n_mat;
  for (int m = 0; m < a.n_mat; ++m) row[m] = 0.0f;

  const float dx = a.dirs[3 * i], dy = a.dirs[3 * i + 1], dz = a.dirs[3 * i + 2];
  const float ix = 1.0f / safe_dir(dx), iy = 1.0f / safe_dir(dy), iz = 1.0f / safe_dir(dz);
  const float bx = a.vsx * (float)a.nx, by = a.vsy * (float)a.ny, bz = a.vsz * (float)a.nz;

  // slab entry / exit of the volume's box
  float tax = (0.0f - a.sx) * ix, tbx = (bx - a.sx) * ix;
  float tay = (0.0f - a.sy) * iy, tby = (by - a.sy) * iy;
  float taz = (0.0f - a.sz) * iz, tbz = (bz - a.sz) * iz;
  float t_near = fmaxf(fmaxf(fminf(tax, tbx), fminf(tay, tby)), fminf(taz, tbz));
  float t_far = fminf(fminf(fmaxf(tax, tbx), fmaxf(tay, tby)), fmaxf(taz, tbz));
  float t0 = fmaxf(t_near, 0.0f) + 1e-4f;
  bool active = t_far > t0;
  float t = active ? t0 : t_far;
  const float t_end = t_far - 1e-5f;

  int it = 0;
  for (; active && it < a.max_iters; ++it) {
    float px = a.sx + dx * t, py = a.sy + dy * t, pz = a.sz + dz * t;
    int flat = cell(px, a.vsx, a.nx) + cell(py, a.vsy, a.ny) * a.nx
               + cell(pz, a.vsz, a.nz) * (a.nx * a.ny);
    uint32_t word = __ldg(a.packed + flat);
    int mat = (int)(word >> kMatShift);
    mat = a.remap[mat < a.n_all ? mat : a.n_all - 1];
    mat = mat < 0 ? 0 : (mat >= a.n_mat ? a.n_mat - 1 : mat);
    int k = (int)((word >> kAirShift) & 0x7u);
    float rho = (float)(word & kDenMask) * a.den_scale;

    float scale = (float)(1 << k);
    float dt = fminf(fminf(axis_step(px, dx, ix, scale * a.vsx),
                           axis_step(py, dy, iy, scale * a.vsy)),
                     axis_step(pz, dz, iz, scale * a.vsz));
    dt = fmaxf(dt, 1e-4f);
    float t_next = fminf(t + dt + 1e-4f, t_far);
    float seg = fmaxf(t_next - t, 0.0f);
    row[mat] += seg * rho * __ldg(a.inv_rho + mat);
    t = t_next;
    active = t < t_end;
  }
  if (a.steps) a.steps[i] = it;
}

extern "C" int primary_trace_launch(const uint32_t* packed, int nx, int ny, int nz, float vsx,
                                    float vsy, float vsz, float den_scale, const float* inv_rho,
                                    const int32_t* remap, int n_all, int n_mat, float sx,
                                    float sy, float sz, const float* dirs, int n, int max_iters,
                                    float* L, int32_t* steps, void* stream) {
  if (n > 0) {
    TraceArgs a{packed, nx, ny, nz, vsx, vsy, vsz, den_scale, inv_rho, remap, n_all, n_mat,
                sx, sy, sz, dirs, n, max_iters, L, steps};
    const int threads = 256;
    primary_trace_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
