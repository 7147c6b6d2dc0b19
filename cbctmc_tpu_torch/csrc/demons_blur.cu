// demons_blur: the demons' separable 3-D Gaussian blur of C volumes
// [C, nx, ny, nz] (C = 1 for the mask, 3 for a field) in one launch: the
// passes along x, y and z in turn, each with the edge replicated,
//   pass[.., p, ..] = sum_j src[.., clamp(p + j - r, 0, len - 1), ..] * w[j],
// the taps summed in order j = 0 .. 2r. The diffusion blur takes the field
// and the update and blurs their sum (src = in + addend, summed at the load).
//
// Replaces: the XLA code of cbctmc_tpu/registration/demons.py::_blur3d (:36):
// per axis an edge pad and a one-channel conv_general_dilated; the JAX package
// has no Pallas kernel for it; this is a hand kernel of the port. Plain
// version: cbctmc_tpu_torch/registration/demons.py::blur3d_reference, three
// passes of blur_axis_reference. Every value is the plain version's to the
// bit: each product rounded on its own (-fmad=false), acc = t0 then acc + t_j
// in tap order, each pass's result a float before the next pass reads it,
// the folded sum in + addend rounded before its products.
//
// Edges: every index is clamped where the input is loaded, and nowhere else.
// That equals the per-pass edge pad: a row or plane clamped to the edge has
// the edge's own pass output (the same inputs in the same order), so a pass
// that reads its input at a clamped index reads what padding the previous
// pass's output would give. A dimension shorter than 2r + 1 (8 at the
// coarse levels) needs nothing more.
//
// Bound on the H100: bytes. The blur reads each value once and writes it
// once: 8 B a voxel and channel, 12 B more for the folded addend; 24 B a voxel
// at C = 3, 0.093 ms at (350, 260, 142), 36 B folded, 0.139 ms. The products
// and sums (3 (4r + 1) a value) are far under it.
//
// Design: a block owns a tile of kTY x kTZ (y, z) columns of one channel (z,
// the contiguous axis, along a warp) and marches along a chunk of x planes
// (the launch picks the chunk from the card's occupancy so that the grid
// fills whole waves). For the tile and its y/z halo of r, each thread holds
// the last 2r + 1 input values of its columns in registers, a ring that the
// march unrolls by 2r + 1 planes so that every slot has a fixed register;
// the next plane's values are loaded before the current plane's passes.
// Each input value is so loaded once per tile (plus the 2r planes before a
// chunk). The x pass of the haloed tile goes to shared memory; the y pass
// forms kYB rows of one z a thread from kYB + 2r words, into a second
// buffer; the z pass forms kZB z of one row a thread from kZB + 2r words and
// writes the output. The passes run as a pipeline, one barrier a plane: the
// x pass of plane x, the y pass of x - 1 and the z pass of x - 2, each plane's
// buffers chosen by its parity. The shared-memory accesses of a warp fall in
// distinct banks (consecutive words; the z pass's rows at an odd stride).
// Indices are int32 (C nx ny nz < 2^31) and formed once a thread: the
// columns' offsets in a plane at the start, the plane's offset at each step;
// the tile's ragged edges (z 142 = 4 x 32 + 14) are masked at the stores.
// The channel and the chunk come from one division of blockIdx.z.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTZ = 32;        // z of a tile: a warp's lanes
constexpr int kTY = 16;        // y of a tile
constexpr int kYB = 4;         // y outputs a thread of the y pass
constexpr int kZB = 4;         // z outputs a thread of the z pass
constexpr int kAhead = 1;      // planes loaded ahead of the x pass
constexpr int kMinBlocks = 3;  // blocks an SM the registers must allow (r <= 4)
constexpr int kMaxRadius = 8;
static_assert(kTY % kYB == 0 && kTZ % kZB == 0, "whole register blocks");

struct Taps {
  float w[2 * kMaxRadius + 1];
};

struct Dims {
  int nx, ny, nz;
  int chunk;   // x planes a block marches
  int chunks;  // chunks of x a channel is cut into
};

template <int R, bool kAdd>
__global__ void __launch_bounds__(kThreads, R <= 4 ? kMinBlocks : 1)
demons_blur_kernel(const float* __restrict__ in, const float* __restrict__ addend, Dims d,
                   Taps taps, float* __restrict__ out) {
  constexpr int W = 2 * R + 1;         // taps, and slots of the ring
  constexpr int HY = kTY + 2 * R;      // rows of the haloed tile
  constexpr int HZ = kTZ + 2 * R;      // its row length
  constexpr int NX = HY * HZ;          // x-pass columns
  constexpr int KX = (NX + kThreads - 1) / kThreads;
  constexpr int NY = kTY / kYB * HZ;   // y-pass items: kYB rows of one z each
  constexpr int KY = (NY + kThreads - 1) / kThreads;
  constexpr int GZ = kTZ / kZB;        // z-pass items a row
  constexpr int NZ = kTY * GZ;         // z-pass items: kZB z of one row each
  constexpr int KZ = (NZ + kThreads - 1) / kThreads;
  constexpr int SY = HZ | 1;           // ys's row stride: odd, so the z pass's
                                       // rows of a warp fall in distinct banks
  __shared__ float xs[2][NX];        // x pass, two planes in flight
  __shared__ float ys[2][kTY * SY];  // y pass

  const int tid = threadIdx.x;
  const int z0 = blockIdx.x * kTZ, y0 = blockIdx.y * kTY;
  const int channel = blockIdx.z / d.chunks;
  const int x0 = (blockIdx.z - channel * d.chunks) * d.chunk;
  const int x1 = min(x0 + d.chunk, d.nx);
  const int plane = d.ny * d.nz;
  const int base = channel * d.nx * plane;
  const float* src = in + base;
  const float* add = kAdd ? addend + base : nullptr;

  // the offsets in a plane of this thread's x-pass columns (edge-clamped);
  // a thread past the last column loads the last one and stores nothing
  int off[KX];
#pragma unroll
  for (int k = 0; k < KX; ++k) {
    const int p = min(tid + k * kThreads, NX - 1);
    const int yy = p / HZ, zz = p - (p / HZ) * HZ;
    const int y = min(max(y0 - R + yy, 0), d.ny - 1);
    const int z = min(max(z0 - R + zz, 0), d.nz - 1);
    off[k] = y * d.nz + z;
  }
  auto load = [&](float (&v)[KX], int x) {
    const int q = min(max(x, 0), d.nx - 1) * plane;
#pragma unroll
    for (int k = 0; k < KX; ++k) {
      float a = src[q + off[k]];
      if (kAdd) a = a + add[q + off[k]];
      v[k] = a;
    }
  };

  // y pass of the plane in buffer b: item p = (g, zz) forms rows
  // g kYB .. g kYB + kYB - 1 at zz from xs rows g kYB .. g kYB + kYB + 2R - 1,
  // read once each
  auto y_pass = [&](int b) {
#pragma unroll
    for (int k = 0; k < KY; ++k) {
      const int p = tid + k * kThreads;
      if (k < KY - 1 || p < NY) {
        const int g = p / HZ, zz = p - (p / HZ) * HZ;
        float v[kYB + 2 * R];
#pragma unroll
        for (int m = 0; m < kYB + 2 * R; ++m) v[m] = xs[b][(g * kYB + m) * HZ + zz];
#pragma unroll
        for (int i = 0; i < kYB; ++i) {
          float acc = v[i] * taps.w[0];
#pragma unroll
          for (int j = 1; j < W; ++j) acc = acc + v[i + j] * taps.w[j];
          ys[b][(g * kYB + i) * SY + zz] = acc;
        }
      }
    }
  };

  // z pass of output plane x from ys buffer b: item p = (yy, g) forms z
  // g kZB .. g kZB + kZB - 1 of row yy from kZB + 2R words, read once each
  auto z_pass = [&](int b, int x) {
#pragma unroll
    for (int k = 0; k < KZ; ++k) {
      const int p = tid + k * kThreads;
      const int yy = p / GZ, g = p % GZ;
      const int y = y0 + yy;
      if ((k < KZ - 1 || p < NZ) && y < d.ny) {
        float v[kZB + 2 * R];
#pragma unroll
        for (int m = 0; m < kZB + 2 * R; ++m) v[m] = ys[b][yy * SY + g * kZB + m];
        const int z = z0 + g * kZB;
        float* o = out + base + x * plane + y * d.nz + z;
#pragma unroll
        for (int i = 0; i < kZB; ++i) {
          float acc = v[i] * taps.w[0];
#pragma unroll
          for (int j = 1; j < W; ++j) acc = acc + v[i + j] * taps.w[j];
          if (z + i < d.nz) o[i] = acc;
        }
      }
    }
  };

  // at step s of a round (plane x = xb + s, xb - x0 a multiple of W) ring
  // slot (s + j) % W holds input plane clamp(x - R + j); the prologue fills
  // slots 0 .. 2R - 1 with planes x0 - R .. x0 + R - 1
  float ring[W][KX];
#pragma unroll
  for (int s = 0; s < 2 * R; ++s) load(ring[s], x0 - R + s);
  float next[kAhead][KX];  // planes x + 1 + R .. x + kAhead + R at step x
#pragma unroll
  for (int a = 0; a < kAhead; ++a) load(next[a], x0 + R + a);

  // The passes run as a pipeline of one barrier a step: step x forms the x
  // pass of plane x, the y pass of plane x - 1 and the z pass of plane x - 2,
  // each plane's buffers chosen by its parity. A step's passes touch
  // different buffers, and a buffer read in one step is written again only
  // in the next, across the barrier between them.
#pragma unroll 1
  for (int xb = x0; xb < x1; xb += W) {
#pragma unroll
    for (int s = 0; s < W; ++s) {
      const int x = xb + s;
      if (x >= x1) break;
      const int b = (x - x0) & 1;
#pragma unroll
      for (int k = 0; k < KX; ++k) {
        ring[(s + 2 * R) % W][k] = next[0][k];
#pragma unroll
        for (int a = 0; a + 1 < kAhead; ++a) next[a][k] = next[a + 1][k];
      }
      // lands in the ring kAhead steps on
      if (x + kAhead < x1) load(next[kAhead - 1], x + kAhead + R);

      // x pass of the haloed tile, from the ring
#pragma unroll
      for (int k = 0; k < KX; ++k) {
        float acc = ring[s % W][k] * taps.w[0];
#pragma unroll
        for (int j = 1; j < W; ++j) acc = acc + ring[(s + j) % W][k] * taps.w[j];
        const int p = tid + k * kThreads;
        if (k < KX - 1 || p < NX) xs[b][p] = acc;
      }
      if (x > x0) y_pass(b ^ 1);
      if (x > x0 + 1) z_pass(b, x - 2);
      __syncthreads();
    }
  }
  // the pipeline's last two steps
  const int b = (x1 - x0) & 1;  // the parity of step x1
  y_pass(b ^ 1);
  if (x1 > x0 + 1) z_pass(b, x1 - 2);
  __syncthreads();
  z_pass(b ^ 1, x1 - 1);
}

// x planes a block marches: the chunk count whose grid, in whole waves of
// the blocks the card holds at once, takes the fewest plane steps (a chunk
// loads 2r planes before its first)
int choose_chunk(int nx, int radius, int channels, int tiles, int slots) {
  int best = nx, best_cost = -1;
  for (int c = 1; c <= nx && channels * c <= 65535; ++c) {
    const int chunk = (nx + c - 1) / c;
    const int chunks = (nx + chunk - 1) / chunk;
    if (chunks != c) continue;
    const long long blocks = (long long)tiles * channels * chunks;
    const long long waves = (blocks + slots - 1) / slots;
    const long long cost = waves * (chunk + 2 * radius);
    if (best_cost < 0 || cost < best_cost) best_cost = cost, best = chunk;
  }
  return best;
}

template <int R, bool kAdd>
cudaError_t launch(const float* in, const float* addend, int channels, int nx, int ny, int nz,
                   const Taps& taps, float* out, cudaStream_t s) {
  static int slots = 0;  // blocks the card holds at once
  if (slots == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, demons_blur_kernel<R, kAdd>,
                                                          kThreads, 0);
    if (err != cudaSuccess) return err;
    slots = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int tiles_z = (nz + kTZ - 1) / kTZ, tiles_y = (ny + kTY - 1) / kTY;
  Dims d{nx, ny, nz, 0, 0};
  d.chunk = choose_chunk(nx, R, channels, tiles_z * tiles_y, slots);
  d.chunks = (nx + d.chunk - 1) / d.chunk;
  if (tiles_y > 65535 || (long long)channels * d.chunks > 65535) return cudaErrorInvalidValue;
  const dim3 grid(tiles_z, tiles_y, channels * d.chunks);
  demons_blur_kernel<R, kAdd><<<grid, kThreads, 0, s>>>(in, addend, d, taps, out);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_radius(const float* in, const float* addend, int channels, int nx, int ny,
                          int nz, const Taps& taps, float* out, cudaStream_t s) {
  return addend ? launch<R, true>(in, addend, channels, nx, ny, nz, taps, out, s)
                : launch<R, false>(in, addend, channels, nx, ny, nz, taps, out, s);
}

}  // namespace

extern "C" int demons_blur_launch(const float* in, const float* addend, int channels, int nx,
                                  int ny, int nz, const float* taps, int n_taps, float* out,
                                  void* stream) {
  const int radius = n_taps / 2;
  if (n_taps % 2 != 1 || radius < 1 || radius > kMaxRadius || channels < 1 || nx < 1 ||
      ny < 1 || nz < 1 || (long long)nx * ny * nz * channels > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Taps t{};
  for (int j = 0; j < n_taps; ++j) t.w[j] = taps[j];
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaErrorInvalidValue;
  switch (radius) {
#define DEMONS_BLUR_CASE(R) \
  case R:                   \
    err = launch_radius<R>(in, addend, channels, nx, ny, nz, t, out, s); \
    break;
    DEMONS_BLUR_CASE(1) DEMONS_BLUR_CASE(2) DEMONS_BLUR_CASE(3) DEMONS_BLUR_CASE(4)
    DEMONS_BLUR_CASE(5) DEMONS_BLUR_CASE(6) DEMONS_BLUR_CASE(7) DEMONS_BLUR_CASE(8)
#undef DEMONS_BLUR_CASE
  }
  return (int)err;
}
