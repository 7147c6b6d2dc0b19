// tv_spatial: Chambolle's projection algorithm for 3-D total-variation
// denoising of a batch of volumes (ROOSTER's spatial regularisation, every
// respiratory phase in one launch).
//
// Replaces: the XLA program cbctmc_tpu/recon/rooster.py::
// _spatial_tv_chambolle (a fori_loop whose body is grad(div(p) - f / lambda)
// and the dual update, vmapped over the phases). The JAX package has no
// Pallas kernel for it; this is a hand kernel of the port. Plain version:
// cbctmc_tpu_torch/recon/rooster.py::spatial_tv_reference.
//
// One iteration is g = grad(d) with d = div(p) - f / lambda, then
// p <- (p + tau g) / (1 + tau |g|) with tau = 0.125; after the loop the
// result is f - lambda div(p). The boundary rules are the JAX package's:
// grad's forward difference appends the last slice, so its last difference
// is that slice minus itself; div sets index 0 to p[0] and the last index to
// -p[-2]. Each quantity is formed by the same operations in the same order
// as the plain version: div as (dx + dy) + dz, the norm as (gx^2 + gy^2) +
// gz^2, true divisions by lambda and by 1 + tau |g|; d at a neighbour is
// the same expression as d at the voxel.
//
// Bound on the H100: the function reads f once and writes the result once
// (2.15 GB each for 10 phases of 464 x 464 x 250, 1.285 ms) and does 27
// floating-point operations a voxel and iteration (7 for d, 20 for g, its
// norm and the update of p) and 7 in the finish: bytes at one iteration,
// operations (2.2 ms) at ROOSTER's ten. The dual variable p has to cross
// device memory between iterations, so the design's own floor is a stream
// of f and p in and p out: 28 bytes a voxel an iteration, 16 in the first
// (p = 0 is not read), 20 in the finish.
//
// Design: one launch an iteration (tv_spatial_kernel) and one to finish
// (tv_spatial_finish_kernel). The iteration needs d at the +1 neighbours,
// and d needs p at the -1 neighbours. A block owns a (y, z) tile of
// kTY x kTZ columns of one phase (z, the contiguous axis, along a warp) over
// kPlanes planes of x, and each thread marches its column along them,
// carrying in registers what the next plane reads again: px and the old p
// of the plane, and d. d of each plane is formed once a voxel and goes to
// shared memory, where the +y and +z neighbours read it; d at the tile's +1
// halo (the row y0 + kTY, the column z0 + kTZ) is formed by warps 0 and 1.
// One barrier a plane. Neighbours read the old p, so the wrapper ping-pongs
// p between two buffers; the first iteration knows that p is 0, reads none
// and forms d with the plain version's expression on zeros (signed zeros
// agree). The finish is one thread a voxel. Both grids are 3-D (z tiles,
// y tiles, x runs x phases), so a thread divides no index of its own: the
// phase and the x run come from one 32-bit division of blockIdx.z; offsets
// within a phase are 32-bit (3 n < 2^31 is required), a phase's base is
// 64-bit. Layouts: f, out [B, nx, ny, nz]; p [B, 3, nx, ny, nz].

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTZ = 32;     // z of a tile: a warp's lanes
constexpr int kTY = 8;      // y of a tile: a block's warps
constexpr int kPlanes = 4;  // x planes a block of the iteration marches
constexpr float kTau = 0.125f;

struct Dims {
  int nx, ny, nz;
  int n;     // nx * ny * nz, a phase
  int runs;  // runs of x a phase is cut into (x planes each: kPlanes, or 1 in the finish)
};

// One phase's f and p (p null: p = 0)
struct Phase {
  const float* f;
  const float* px;
  const float* py;
  const float* pz;
};

__device__ __forceinline__ Phase phase(const Dims& d, const float* f, const float* p, int b) {
  const float* px = p ? p + (int64_t)b * 3 * d.n : nullptr;
  return Phase{f + (int64_t)b * d.n, px, px ? px + d.n : nullptr, px ? px + 2 * d.n : nullptr};
}

// What d reads at voxel v = (x, y, z) besides px of the plane before: f,
// p, py at y - 1 and pz at z - 1 (read only where they exist)
struct Point {
  float f, px, py, pz, pym, pzm;
};

template <bool kZero>
__device__ __forceinline__ Point load(const Phase& ph, const Dims& d, int v, int y, int z) {
  Point q;
  q.f = __ldg(ph.f + v);
  if (kZero) {
    q.px = q.py = q.pz = q.pym = q.pzm = 0.0f;
  } else {
    q.px = __ldg(ph.px + v);
    q.py = __ldg(ph.py + v);
    q.pz = __ldg(ph.pz + v);
    q.pym = y > 0 ? __ldg(ph.py + v - d.nz) : 0.0f;
    q.pzm = z > 0 ? __ldg(ph.pz + v - 1) : 0.0f;
  }
  return q;
}

// div(p) at (x, y, z), pxm being px of plane x - 1 (read only where x > 0)
__device__ __forceinline__ float divergence(const Point& q, float pxm, const Dims& d, int x,
                                            int y, int z) {
  const float dx = x == d.nx - 1 ? -pxm : (x == 0 ? q.px : q.px - pxm);
  const float dy = y == d.ny - 1 ? -q.pym : (y == 0 ? q.py : q.py - q.pym);
  const float dz = z == d.nz - 1 ? -q.pzm : (z == 0 ? q.pz : q.pz - q.pzm);
  return (dx + dy) + dz;
}

// A column of the march: the thread's own, or a halo column whose d the
// thread forms for its neighbours
struct Column {
  int y, z, v;  // v: the column's offset within a plane
  bool live;
  float pxm;  // px of the plane before
};

// d = div(p) - f / lambda of the column at plane x (p of the plane in q)
template <bool kZero>
__device__ __forceinline__ float d_at(Column& col, Point& q, const Phase& ph, const Dims& d,
                                      int x, float lam) {
  q = load<kZero>(ph, d, x * d.ny * d.nz + col.v, col.y, col.z);
  const float dv = divergence(q, col.pxm, d, x, col.y, col.z) - q.f / lam;
  col.pxm = q.px;
  return dv;
}

}  // namespace

// One Chambolle iteration: p_out = the update of p (p null: the first
// iteration, p = 0, not read). Block (kTZ, kTY); grid (z tiles, y tiles,
// runs of kPlanes x planes x phases). At most 32 registers, so that 8
// blocks (64 warps) fit on an SM.
template <bool kFirst>
__global__ void __launch_bounds__(kTZ * kTY, 8)
    tv_spatial_kernel(Dims d, const float* __restrict__ f, const float* __restrict__ p,
                      float lam, float* __restrict__ p_out) {
  __shared__ float dsh[2][kTY + 1][kTZ + 1];  // d of two planes over the tile and its +1 halo
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int b = blockIdx.z / d.runs;
  const int x0 = (blockIdx.z - b * d.runs) * kPlanes;
  const int x1 = min(x0 + kPlanes, d.nx);  // planes [x0, x1) are updated
  const int y0 = blockIdx.y * kTY, z0 = blockIdx.x * kTZ;
  const Phase ph = phase(d, f, p, b);
  float* ob = p_out + (int64_t)b * 3 * d.n;
  const int sx = d.ny * d.nz;

  Column own{y0 + warp, z0 + lane, 0, false, 0.0f};
  own.live = own.y < d.ny && own.z < d.nz;
  own.v = own.y * d.nz + own.z;
  // the halo: warp 0 the row y0 + kTY, warp 1's first kTY lanes the column z0 + kTZ
  int hr = kTY, hc = lane;
  Column halo{y0 + kTY, own.z, 0, false, 0.0f};
  if (warp == 1) {
    hr = lane;
    hc = kTZ;
    halo.y = y0 + lane;
    halo.z = z0 + kTZ;
  }
  halo.live = (warp == 0 || (warp == 1 && lane < kTY)) && halo.y < d.ny && halo.z < d.nz;
  halo.v = halo.y * d.nz + halo.z;
  if (!kFirst && x0 > 0) {
    if (own.live) own.pxm = __ldg(ph.px + (x0 - 1) * sx + own.v);
    if (halo.live) halo.pxm = __ldg(ph.px + (x0 - 1) * sx + halo.v);
  }

  Point q{}, qn{};  // p of the own column at planes x and x + 1
  Point hq;
  float c = 0.0f;  // d of the own column at plane x
  if (own.live) dsh[x0 & 1][warp][lane] = c = d_at<kFirst>(own, q, ph, d, x0, lam);
  if (halo.live) dsh[x0 & 1][hr][hc] = d_at<kFirst>(halo, hq, ph, d, x0, lam);
  for (int x = x0; x < x1; ++x) {
    __syncthreads();  // d of plane x is in dsh[x & 1]
    const bool next = x + 1 < d.nx, later = x + 1 < x1;  // plane x + 1 exists / is updated here
    float cn = 0.0f;
    if (own.live && next) {
      cn = d_at<kFirst>(own, qn, ph, d, x + 1, lam);
      if (later) dsh[(x + 1) & 1][warp][lane] = cn;
    }
    if (halo.live && later) dsh[(x + 1) & 1][hr][hc] = d_at<kFirst>(halo, hq, ph, d, x + 1, lam);
    if (own.live) {
      const auto& dc = dsh[x & 1];
      const float gx = (next ? cn : c) - c;
      const float gy = (own.y + 1 < d.ny ? dc[warp + 1][lane] : c) - c;
      const float gz = (own.z + 1 < d.nz ? dc[warp][lane + 1] : c) - c;
      const float norm = sqrtf((gx * gx + gy * gy) + gz * gz);
      const float den = 1.0f + kTau * norm;
      const int v = x * sx + own.v;
      ob[v] = (q.px + kTau * gx) / den;
      ob[d.n + v] = (q.py + kTau * gy) / den;
      ob[2 * d.n + v] = (q.pz + kTau * gz) / den;
      c = cn;
      q = qn;
    }
  }
}

// out = f - lambda div(p) (p null: p = 0, not read), one thread a voxel.
// Block (kTZ, kTY); grid (z tiles, y tiles, x planes x phases).
template <bool kZero>
__global__ void __launch_bounds__(kTZ * kTY)
    tv_spatial_finish_kernel(Dims d, const float* __restrict__ f, const float* __restrict__ p,
                             float lam, float* __restrict__ out) {
  const int z = blockIdx.x * kTZ + threadIdx.x, y = blockIdx.y * kTY + threadIdx.y;
  const int b = blockIdx.z / d.nx, x = blockIdx.z - b * d.nx;
  if (y >= d.ny || z >= d.nz) return;
  const Phase ph = phase(d, f, p, b);
  const int v = x * d.ny * d.nz + y * d.nz + z;
  const Point q = load<kZero>(ph, d, v, y, z);
  const float pxm = kZero || x == 0 ? 0.0f : __ldg(ph.px + v - d.ny * d.nz);
  out[(int64_t)b * d.n + v] = q.f - lam * divergence(q, pxm, d, x, y, z);
}

namespace {

// the grid of B phases, each cut into runs of `planes` x planes
int launch_shape(int B, int nx, int ny, int nz, int planes, Dims& d, dim3& grid) {
  const int64_t n = (int64_t)nx * ny * nz;
  const int64_t runs = (nx + planes - 1) / planes;
  const int64_t tiles_y = (ny + kTY - 1) / kTY;
  if (nx < 2 || ny < 2 || nz < 2 || tiles_y > 65535 || runs * B > 65535 ||
      3 * n >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  d = Dims{nx, ny, nz, (int)n, (int)runs};
  grid = dim3((unsigned)((nz + kTZ - 1) / kTZ), (unsigned)tiles_y, (unsigned)(runs * B));
  return 0;
}

}  // namespace

// One iteration: p_out = the update of p (p null: the first iteration, p = 0).
extern "C" int tv_spatial_launch(const float* f, const float* p, int B, int nx, int ny, int nz,
                                 float lam, float* p_out, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  Dims d;
  dim3 grid;
  const int err = launch_shape(B, nx, ny, nz, kPlanes, d, grid);
  if (err) return err;
  const dim3 block(kTZ, kTY);
  const cudaStream_t s = (cudaStream_t)stream;
  if (p)
    tv_spatial_kernel<false><<<grid, block, 0, s>>>(d, f, p, lam, p_out);
  else
    tv_spatial_kernel<true><<<grid, block, 0, s>>>(d, f, p, lam, p_out);
  return (int)cudaGetLastError();
}

// out = f - lambda div(p) (p null: no iteration ran, p = 0).
extern "C" int tv_spatial_finish_launch(const float* f, const float* p, int B, int nx, int ny,
                                        int nz, float lam, float* out, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  Dims d;
  dim3 grid;
  const int err = launch_shape(B, nx, ny, nz, 1, d, grid);
  if (err) return err;
  const dim3 block(kTZ, kTY);
  const cudaStream_t s = (cudaStream_t)stream;
  if (p)
    tv_spatial_finish_kernel<false><<<grid, block, 0, s>>>(d, f, p, lam, out);
  else
    tv_spatial_finish_kernel<true><<<grid, block, 0, s>>>(d, f, p, lam, out);
  return (int)cudaGetLastError();
}
