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
// through the 500^3 CatPhan, ~5.6e7 steps): at most 46 floating-point
// operations per step against 12 B of direction and n_mat * 4 B of L per
// ray and 4 B per distinct voxel word the rays cross. What the kernel
// cannot avoid is one dependent chain per ray (position, division, gather,
// next boundary), so it runs bound by latency and by the instructions of
// each step: the design keeps many rays in flight, keeps the loads of a
// warp's lanes together, and takes off each step whatever is not the chain.
//
// Design: one thread per ray, 256 per block, so a warp walks 32
// consecutive rays (neighbouring pixels of a detector row: rays of similar
// length that read neighbouring voxel words), each to its end. The JAX
// loop's global trip counter becomes a per-ray step cap (max_iters) with
// the same result: the JAX loop steps a ray on every trip until it leaves
// or the trip count reaches the cap. (Persistent warps taking 32 rays at a
// time from a work counter, on a grid that fills the card, measured 4-6 %
// slower on the H100: the block scheduler evens out the rays' lengths as
// well.)
//
// Per step, the chain is one global load (the voxel word): the material's
// column of L and 1 / rho come from a 32-entry table in shared memory
// indexed by the word's raw 5-bit material, and each lane keeps its ray's
// n_mat sums in shared memory; L is written once when the ray ends. One
// IEEE division per axis and step instead of two: q = p / vs gives the
// cell (floor(q)) and, since span = 2^k * vs is exact and rounding commutes
// with scaling by a power of two, floor(p / span) = floor(q * 2^-k) with an
// exact multiplication. The operation sequence is otherwise the JAX one, op
// for op (multiplication by 1/d, the 1e-4 nudges, the 1e-5 exit test, each
// ray's sums in step order), built with -fmad=false and without fast math,
// so the plain version agrees to the bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMatShift = 27;
constexpr int kAirShift = 24;
constexpr uint32_t kDenMask = (1u << 21) - 1u;
constexpr int kRawMats = 32;   // values of the word's 5-bit material field
constexpr int kThreads = 256;  // lanes per block

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

struct __align__(8) MatEntry {
  int col;    // column of L
  float inv;  // 1 / nominal density of that column
};

__device__ __forceinline__ float safe_dir(float d) {
  return fabsf(d) < 1e-9f ? 1e-9f : d;
}

__device__ __forceinline__ int clip_cell(float q, int n) {
  // floor(p / vs) as int32 (cvt saturates), clipped to [0, n - 1]
  int i = __float2int_rz(floorf(q));
  return i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
}

__device__ __forceinline__ float axis_step(float p, float q, float inv_scale, float span,
                                           float d, float inv_d) {
  // floor(p / span) * span, with floor(p / span) == floor((p / vs) * 2^-k)
  float base = floorf(q * inv_scale) * span;
  return d > 0.0f ? (base + span - p) * inv_d : (base - p) * inv_d;
}

// walks ray i to its end; acc holds the lane's n_mat sums (zero on entry)
__device__ void trace_ray(const TraceArgs& a, const MatEntry* mat_table, float* acc,
                          int stride, int i) {
  const float dx = a.dirs[3 * i], dy = a.dirs[3 * i + 1], dz = a.dirs[3 * i + 2];
  const float ix = 1.0f / safe_dir(dx), iy = 1.0f / safe_dir(dy), iz = 1.0f / safe_dir(dz);
  const float bx = a.vsx * (float)a.nx, by = a.vsy * (float)a.ny, bz = a.vsz * (float)a.nz;

  // slab entry / exit of the volume's box
  float tax = (0.0f - a.sx) * ix, tbx = (bx - a.sx) * ix;
  float tay = (0.0f - a.sy) * iy, tby = (by - a.sy) * iy;
  float taz = (0.0f - a.sz) * iz, tbz = (bz - a.sz) * iz;
  float t_near = fmaxf(fmaxf(fminf(tax, tbx), fminf(tay, tby)), fminf(taz, tbz));
  const float t_far = fminf(fminf(fmaxf(tax, tbx), fmaxf(tay, tby)), fmaxf(taz, tbz));
  const float t0 = fmaxf(t_near, 0.0f) + 1e-4f;
  bool active = t_far > t0;
  float t = active ? t0 : t_far;
  const float t_end = t_far - 1e-5f;

  int it = 0;
  for (; active && it < a.max_iters; ++it) {
    const float px = a.sx + dx * t, py = a.sy + dy * t, pz = a.sz + dz * t;
    const float qx = px / a.vsx, qy = py / a.vsy, qz = pz / a.vsz;
    const int flat = clip_cell(qx, a.nx) + clip_cell(qy, a.ny) * a.nx
                     + clip_cell(qz, a.nz) * (a.nx * a.ny);
    const uint32_t word = __ldg(a.packed + flat);
    const MatEntry mat = mat_table[word >> kMatShift];
    const int k = (int)((word >> kAirShift) & 0x7u);
    const float rho = (float)(word & kDenMask) * a.den_scale;

    const float scale = (float)(1 << k);
    const float inv_scale = __int_as_float((127 - k) << 23);  // 2^-k, exact
    float dt = fminf(fminf(axis_step(px, qx, inv_scale, scale * a.vsx, dx, ix),
                           axis_step(py, qy, inv_scale, scale * a.vsy, dy, iy)),
                     axis_step(pz, qz, inv_scale, scale * a.vsz, dz, iz));
    dt = fmaxf(dt, 1e-4f);
    const float t_next = fminf(t + dt + 1e-4f, t_far);
    const float seg = fmaxf(t_next - t, 0.0f);
    acc[mat.col * stride] += seg * rho * mat.inv;
    t = t_next;
    active = t < t_end;
  }
  float* row = a.L + (size_t)i * a.n_mat;
  for (int m = 0; m < a.n_mat; ++m) row[m] = acc[m * stride];
  if (a.steps) a.steps[i] = it;
}

}  // namespace

// at global scope: the profiler reports the kernel under this name
__global__ void __launch_bounds__(kThreads) primary_trace_kernel(TraceArgs a) {
  extern __shared__ float sums[];  // [n_mat][blockDim.x]: each lane's ray sums
  __shared__ MatEntry mat_table[kRawMats];
  if (threadIdx.x < kRawMats) {
    int raw = threadIdx.x < a.n_all ? threadIdx.x : a.n_all - 1;
    int col = a.remap[raw];
    col = col < 0 ? 0 : (col >= a.n_mat ? a.n_mat - 1 : col);
    mat_table[threadIdx.x] = MatEntry{col, a.inv_rho[col]};
  }
  float* acc = sums + threadIdx.x;
  for (int m = 0; m < a.n_mat; ++m) acc[m * blockDim.x] = 0.0f;
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < a.n) trace_ray(a, mat_table, acc, blockDim.x, i);
}

extern "C" int primary_trace_launch(const uint32_t* packed, int nx, int ny, int nz, float vsx,
                                    float vsy, float vsz, float den_scale, const float* inv_rho,
                                    const int32_t* remap, int n_all, int n_mat, float sx,
                                    float sy, float sz, const float* dirs, int n, int max_iters,
                                    float* L, int32_t* steps, void* stream) {
  if (n > 0) {
    if (n_all < 1 || n_mat < 1 || n_mat > kRawMats) return (int)cudaErrorInvalidValue;
    TraceArgs a{packed, nx, ny, nz, vsx, vsy, vsz, den_scale, inv_rho, remap, n_all, n_mat,
                sx, sy, sz, dirs, n, max_iters, L, steps};
    const size_t shared = sizeof(float) * (size_t)n_mat * kThreads;
    const unsigned blocks = (unsigned)(((long long)n + kThreads - 1) / kThreads);
    primary_trace_kernel<<<blocks, kThreads, shared, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
