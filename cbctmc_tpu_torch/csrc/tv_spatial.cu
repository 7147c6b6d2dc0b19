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
// One iteration is g = grad(div(p) - f / lambda), then
// p <- (p + tau g) / (1 + tau |g|) with tau = 0.125; after the loop the
// result is f - lambda div(p). The boundary rules are the JAX package's:
// grad's forward difference appends the last slice, so its last difference
// is that slice minus itself; div sets index 0 to p[0] and the last index to
// -p[-2]. Each quantity is formed by the same operations in the same order
// as the plain version: div as (dx + dy) + dz, the norm as (gx^2 + gy^2) +
// gz^2, true divisions by lambda and by 1 + tau |g|.
//
// Bound on the H100: bytes. The whole function reads f once and writes the
// result once (2.15 GB each for 10 phases of 464 x 464 x 250); an iteration
// does 27 floating-point operations a voxel (7 for d, 20 for g, its norm and
// the update of p) and the last launch 7.
//
// Design (simple first): div needs p at the -1 neighbours and grad needs
// div at the +1 neighbours, so an iteration is two launches of one thread
// per voxel (z fastest, neighbouring threads on neighbouring z):
// tv_spatial_div writes d = div(p) - f / lambda into a scratch volume;
// tv_spatial_update forms g from d's forward differences and updates p in
// place (each thread reads and writes only its own voxel of p). A third
// launch, tv_spatial_finish, writes f - lambda div(p). The phase is
// blockIdx.y. Layouts: f, d, out [B, nx, ny, nz]; p [B, 3, nx, ny, nz].

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Grid {
  int nx, ny, nz;
  int64_t n;  // nx * ny * nz
};

// div(p) at voxel (i, j, k) of one volume's p [3, nx, ny, nz]
__device__ __forceinline__ float divergence(const float* __restrict__ p, const Grid& g, int64_t v,
                                            int i, int j, int k) {
  const float* px = p;
  const float* py = p + g.n;
  const float* pz = p + 2 * g.n;
  const int64_t sx = (int64_t)g.ny * g.nz, sy = g.nz;
  const float dx = i == g.nx - 1 ? -px[v - sx] : (i == 0 ? px[v] : px[v] - px[v - sx]);
  const float dy = j == g.ny - 1 ? -py[v - sy] : (j == 0 ? py[v] : py[v] - py[v - sy]);
  const float dz = k == g.nz - 1 ? -pz[v - 1] : (k == 0 ? pz[v] : pz[v] - pz[v - 1]);
  return (dx + dy) + dz;
}

__device__ __forceinline__ bool voxel(const Grid& g, int64_t& v, int& i, int& j, int& k) {
  v = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (v >= g.n) return false;
  k = (int)(v % g.nz);
  j = (int)((v / g.nz) % g.ny);
  i = (int)(v / ((int64_t)g.ny * g.nz));
  return true;
}

}  // namespace

__global__ void tv_spatial_div_kernel(Grid g, const float* __restrict__ f,
                                      const float* __restrict__ p, float lam,
                                      float* __restrict__ d) {
  int64_t v;
  int i, j, k;
  if (!voxel(g, v, i, j, k)) return;
  const int64_t b = blockIdx.y;
  d[b * g.n + v] = divergence(p + 3 * b * g.n, g, v, i, j, k) - f[b * g.n + v] / lam;
}

__global__ void tv_spatial_update_kernel(Grid g, const float* __restrict__ d,
                                         float* __restrict__ p) {
  int64_t v;
  int i, j, k;
  if (!voxel(g, v, i, j, k)) return;
  const int64_t b = blockIdx.y;
  const float* db = d + b * g.n;
  const int64_t sx = (int64_t)g.ny * g.nz, sy = g.nz;
  const float dc = db[v];
  // forward differences; the appended last slice makes the last one dc - dc
  const float gx = (i + 1 < g.nx ? db[v + sx] : dc) - dc;
  const float gy = (j + 1 < g.ny ? db[v + sy] : dc) - dc;
  const float gz = (k + 1 < g.nz ? db[v + 1] : dc) - dc;
  const float tau = 0.125f;
  const float norm = sqrtf((gx * gx + gy * gy) + gz * gz);
  const float den = 1.0f + tau * norm;
  float* pb = p + 3 * b * g.n;
  pb[v] = (pb[v] + tau * gx) / den;
  pb[g.n + v] = (pb[g.n + v] + tau * gy) / den;
  pb[2 * g.n + v] = (pb[2 * g.n + v] + tau * gz) / den;
}

__global__ void tv_spatial_finish_kernel(Grid g, const float* __restrict__ f,
                                         const float* __restrict__ p, float lam,
                                         float* __restrict__ out) {
  int64_t v;
  int i, j, k;
  if (!voxel(g, v, i, j, k)) return;
  const int64_t b = blockIdx.y;
  out[b * g.n + v] = f[b * g.n + v] - lam * divergence(p + 3 * b * g.n, g, v, i, j, k);
}

namespace {

int launch_shape(int B, int nx, int ny, int nz, Grid& g, dim3& grid) {
  g = Grid{nx, ny, nz, (int64_t)nx * ny * nz};
  const int64_t blocks = (g.n + kThreads - 1) / kThreads;
  if (B > 65535 || blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  grid = dim3((unsigned)blocks, B);
  return 0;
}

}  // namespace

extern "C" int tv_spatial_launch(const float* f, const float* p, int B, int nx, int ny, int nz,
                                 float lam, float* d, void* stream) {
  Grid g;
  dim3 grid;
  if (B > 0 && (int64_t)nx * ny * nz > 0) {
    const int err = launch_shape(B, nx, ny, nz, g, grid);
    if (err) return err;
    tv_spatial_div_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(g, f, p, lam, d);
  }
  return (int)cudaGetLastError();
}

extern "C" int tv_spatial_update_launch(const float* d, float* p, int B, int nx, int ny, int nz,
                                        void* stream) {
  Grid g;
  dim3 grid;
  if (B > 0 && (int64_t)nx * ny * nz > 0) {
    const int err = launch_shape(B, nx, ny, nz, g, grid);
    if (err) return err;
    tv_spatial_update_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(g, d, p);
  }
  return (int)cudaGetLastError();
}

extern "C" int tv_spatial_finish_launch(const float* f, const float* p, int B, int nx, int ny,
                                        int nz, float lam, float* out, void* stream) {
  Grid g;
  dim3 grid;
  if (B > 0 && (int64_t)nx * ny * nz > 0) {
    const int err = launch_shape(B, nx, ny, nz, g, grid);
    if (err) return err;
    tv_spatial_finish_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(g, f, p, lam, out);
  }
  return (int)cudaGetLastError();
}
