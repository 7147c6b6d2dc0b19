#!/usr/bin/env python3
"""Time ROOSTER's two TV kernels, ``tv_spatial`` and ``tv_temporal``, of
one or more checkouts of this repository on one card, in turns, and count
the SASS instructions of their loops.

Usage (on a machine with one CUDA card)::

    python3 scripts/compare_tv_kernels.py ROOT [ROOT ...] [--variants]
        [--only=tv_spatial|tv_temporal]

Each ROOT is a checkout of the repository: the working tree, or another
commit unpacked with ``git archive`` into a directory that ``.gitignore``
lists. For each ROOT, in the order given (for example parent, change,
change, parent), a process of its own imports that checkout's
``chip_smoke.py`` and package and, on the recon-mc path's 10 phase volumes
of (464, 464, 250) (made here on the card from a seed: a water cylinder, the
smoke's insert at each phase's height, noise):

- holds ``spatial_tv`` against its plain version at 1 and at ROOSTER's 10
  iterations (no voxel may differ) and counts its launches a call;
- times the call at both by the profiler (device time of the kernel's
  launches alone) and by CUDA events around the wrapper's call, and by
  device function (the first iteration, the later ones, the finish), with
  the call's peak device memory;
- times two PyTorch calls on the same tensors as yardsticks of the card's
  streaming rate: ``copy_`` of the volumes and a ``torch.add`` that moves
  an iteration's 28 B a voxel;
- holds ``temporal_tv`` against its plain version at 0, 1 and ROOSTER's 10
  iterations (no voxel may differ), counts its launches a call and times it
  at each by the profiler and by CUDA events;
- counts, with ``cuobjdump -sass`` where the toolkit has it, the
  instructions of every loop of ``tv_spatial``'s iteration kernel and of
  ``tv_temporal``'s kernel for 10 phases, and turns ``tv_temporal``'s
  iteration loop into an issue-rate time: its instructions per iteration x
  53,824,000 voxels / 32 lanes x 10 iterations over 132 SMs x 4 warp
  instructions a clock at the card's maximum SM clock (``nvidia-smi``).

``--only=tv_spatial`` or ``--only=tv_temporal`` measures one kernel;
``--volumes=PATH`` times them on the phase volumes of a ``.npy`` file
(float32, [phase, x, y, z]; for example the recon-mc path's) in place of
those made here.

With ``--variants``, the process of the checkout that holds this script
(each time it is named) also builds variants of the kernels
(``SPATIAL_VARIANTS``, ``TEMPORAL_VARIANTS``: text edits of
``csrc/tv_spatial.cu`` and ``csrc/tv_temporal.cu``, each of which must match
once), holds each against the plain version as above (but those that
``TIMING_ONLY`` names) and times it in the same process beside the shipped
kernel, through the package's own wrapper. ``tv_spatial``'s variants replace
its iteration kernel (the finish stays the shipped one); the shipped kernel
and each variant are timed at 10 iterations on rows of 256 z as well
(timing only). ``tv_temporal``'s variants are its first form (one thread a
voxel, every thread loading its phases, iterating and storing) as it was,
with its loop removed (loads and stores only) and with its loads replaced
by values made in registers and its stores by one that never runs (the
loop only), and the designs measured against the shipped one; each
variant's iteration loop is counted as the shipped kernel's is.
Every line names the card and its power limit; the last line of the output
is one JSON object with every checkout's results.
"""

from __future__ import annotations

import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import kernel_variants
import numpy as np
import torch

SHAPE = (10, 464, 464, 250)  # the recon-mc path's phases on reconstruct_4d's grid
ITERATIONS = (1, 10)  # the smoke's check and ROOSTER's n_tv_iterations
TEMPORAL_ITERATIONS = (0, 1, 10)  # 0: the loads and stores alone
REPS = {0: 5, 1: 5, 10: 3}  # timed calls
HOME = Path(__file__).resolve().parents[1]  # the checkout that holds this script
AIR_RADIUS_MM = 232.0

# variant (a): one thread a voxel, d at the voxel and at its +1 neighbours
# formed from device memory through L1 and L2; the grid's z is x and phase
_VOXEL_D = r"""
template <bool kFirst>
__device__ __forceinline__ float ld(const float* q) { return kFirst ? 0.0f : __ldg(q); }

template <bool kFirst>
__device__ __forceinline__ float d_global(const float* __restrict__ f,
                                          const float* __restrict__ p, const Dims& d, int x,
                                          int y, int z, float lam) {
  const int sx = d.ny * d.nz, v = x * sx + y * d.nz + z;
  const float* py = p + d.n;
  const float* pz = p + 2 * d.n;
  const float dx = x == d.nx - 1 ? -ld<kFirst>(p + v - sx)
                                 : (x == 0 ? ld<kFirst>(p + v)
                                           : ld<kFirst>(p + v) - ld<kFirst>(p + v - sx));
  const float dy = y == d.ny - 1 ? -ld<kFirst>(py + v - d.nz)
                                 : (y == 0 ? ld<kFirst>(py + v)
                                           : ld<kFirst>(py + v) - ld<kFirst>(py + v - d.nz));
  const float dz = z == d.nz - 1 ? -ld<kFirst>(pz + v - 1)
                                 : (z == 0 ? ld<kFirst>(pz + v)
                                           : ld<kFirst>(pz + v) - ld<kFirst>(pz + v - 1));
  return ((dx + dy) + dz) - __ldg(f + v) / lam;
}

// the update of p at voxel (x, y, z) of phase b
template <bool kFirst>
__device__ __forceinline__ void update_voxel(const Dims& d, const float* __restrict__ f,
                                             const float* __restrict__ p, float lam,
                                             float* __restrict__ p_out, int b, int x, int y,
                                             int z) {
  const float* fb = f + (int64_t)b * d.n;
  const float* pb = kFirst ? p : p + (int64_t)b * 3 * d.n;
  float* ob = p_out + (int64_t)b * 3 * d.n;
  const int v = x * d.ny * d.nz + y * d.nz + z;
  const float c = d_global<kFirst>(fb, pb, d, x, y, z, lam);
  const float gx = (x + 1 < d.nx ? d_global<kFirst>(fb, pb, d, x + 1, y, z, lam) : c) - c;
  const float gy = (y + 1 < d.ny ? d_global<kFirst>(fb, pb, d, x, y + 1, z, lam) : c) - c;
  const float gz = (z + 1 < d.nz ? d_global<kFirst>(fb, pb, d, x, y, z + 1, lam) : c) - c;
  const float norm = sqrtf((gx * gx + gy * gy) + gz * gz);
  const float den = 1.0f + kTau * norm;
  ob[v] = (ld<kFirst>(pb + v) + kTau * gx) / den;
  ob[d.n + v] = (ld<kFirst>(pb + d.n + v) + kTau * gy) / den;
  ob[2 * d.n + v] = (ld<kFirst>(pb + 2 * d.n + v) + kTau * gz) / den;
}
"""

_VOXEL = _VOXEL_D + r"""
template <bool kFirst>
__global__ void __launch_bounds__(kTZ * kTY)
    tv_spatial_voxel_kernel(Dims d, const float* __restrict__ f, const float* __restrict__ p,
                            float lam, float* __restrict__ p_out) {
  const int z = blockIdx.x * kTZ + threadIdx.x, y = blockIdx.y * kTY + threadIdx.y;
  const int b = blockIdx.z / d.nx, x = blockIdx.z - b * d.nx;
  if (y < d.ny && z < d.nz) update_voxel<kFirst>(d, f, p, lam, p_out, b, x, y, z);
}

extern "C" int tv_spatial_launch(const float* f, const float* p, int B, int nx, int ny, int nz,
                                 float lam, float* p_out, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  Dims d;
  dim3 grid;
  const int err = launch_shape(B, nx, ny, nz, 1, d, grid);
  if (err) return err;
  const dim3 block(kTZ, kTY);
  const cudaStream_t s = (cudaStream_t)stream;
  if (p)
    tv_spatial_voxel_kernel<false><<<grid, block, 0, s>>>(d, f, p, lam, p_out);
  else
    tv_spatial_voxel_kernel<true><<<grid, block, 0, s>>>(d, f, p, lam, p_out);
  return (int)cudaGetLastError();
}

extern "C" int tv_spatial_launch_shipped("""

# variant (a'): one thread a voxel with consecutive threads on consecutive
# (y, z) of a plane (warps aligned in memory whatever nz is); grid (plane
# chunks of 256, x, phase), (y, z) by one 32-bit division
_VOXEL_FLAT = _VOXEL_D + r"""
template <bool kFirst>
__global__ void __launch_bounds__(256)
    tv_spatial_flat_kernel(Dims d, const float* __restrict__ f, const float* __restrict__ p,
                           float lam, float* __restrict__ p_out) {
  const int q = blockIdx.x * 256 + threadIdx.x;
  if (q >= d.ny * d.nz) return;
  const int y = q / d.nz;
  update_voxel<kFirst>(d, f, p, lam, p_out, blockIdx.z, blockIdx.y, y, q - y * d.nz);
}

extern "C" int tv_spatial_launch(const float* f, const float* p, int B, int nx, int ny, int nz,
                                 float lam, float* p_out, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  Dims d;
  dim3 grid;
  const int err = launch_shape(B, nx, ny, nz, 1, d, grid);
  if (err) return err;
  grid = dim3((unsigned)((ny * nz + 255) / 256), nx, B);
  const cudaStream_t s = (cudaStream_t)stream;
  if (p)
    tv_spatial_flat_kernel<false><<<grid, 256, 0, s>>>(d, f, p, lam, p_out);
  else
    tv_spatial_flat_kernel<true><<<grid, 256, 0, s>>>(d, f, p, lam, p_out);
  return (int)cudaGetLastError();
}

extern "C" int tv_spatial_launch_shipped("""

# variant (b) as first built: a block marches the whole of x, each plane of
# px, py, pz and f over the tile and its halo copied into a ring of kStages
# planes in shared memory by 4-byte cp.async, one plane ahead; d of the tile
# and its +1 halo formed once a plane into shared memory; three barriers a
# plane (the finish stays the shipped one)
_RING = r"""
namespace ring {

constexpr int kStages = 3;
constexpr int kRY = kTY + 1, kRZ = kTZ + 1;

struct Plane {
  float px[kRY][kRZ];
  float py[kRY + 1][kRZ];
  float pz[kRY][kRZ + 1];
  float f[kRY][kRZ];
};

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void wait_prior() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int kRows, int kLeft>
__device__ __forceinline__ void copy_rows(float* dst, const float* __restrict__ src, int y_lo,
                                          int z0, const Dims& d) {
  constexpr int kCols = kLeft + kTZ + 1;
  const int lane = threadIdx.x, warp = threadIdx.y;
  for (int r = warp; r < kRows; r += kTY) {
    const int y = y_lo + r, z = z0 + lane;
    if (y >= 0 && y < d.ny && z < d.nz) copy4(dst + r * kCols + kLeft + lane, src + y * d.nz + z);
  }
  const int t = warp * kTZ + lane;
  if (t < kRows * (kLeft + 1)) {
    const int r = t / (kLeft + 1);
    const int c = t - r * (kLeft + 1) == kLeft ? kCols - 1 : 0;
    const int y = y_lo + r, z = z0 - kLeft + c;
    if (y >= 0 && y < d.ny && z >= 0 && z < d.nz) copy4(dst + r * kCols + c, src + y * d.nz + z);
  }
}

template <bool kFirst>
__device__ __forceinline__ void copy_plane(Plane& pl, const float* __restrict__ f,
                                           const float* __restrict__ p, int x, int y0, int z0,
                                           const Dims& d) {
  const int at = x * d.ny * d.nz;
  copy_rows<kRY, 0>(&pl.f[0][0], f + at, y0, z0, d);
  if (!kFirst) {
    copy_rows<kRY, 0>(&pl.px[0][0], p + at, y0, z0, d);
    copy_rows<kRY + 1, 0>(&pl.py[0][0], p + d.n + at, y0 - 1, z0, d);
    copy_rows<kRY, 1>(&pl.pz[0][0], p + 2 * d.n + at, y0, z0, d);
  }
}

template <bool kFirst>
__device__ __forceinline__ float d_at(const Plane& pl, const Plane& before, int x, int y, int z,
                                      int r, int c, const Dims& d, float lam) {
  const float pxc = kFirst ? 0.0f : pl.px[r][c];
  const float pyc = kFirst ? 0.0f : pl.py[r + 1][c];
  const float pzc = kFirst ? 0.0f : pl.pz[r][c + 1];
  const float dx = x == d.nx - 1 ? -(kFirst ? 0.0f : before.px[r][c])
                                 : (x == 0 ? pxc : pxc - (kFirst ? 0.0f : before.px[r][c]));
  const float dy = y == d.ny - 1 ? -(kFirst ? 0.0f : pl.py[r][c])
                                 : (y == 0 ? pyc : pyc - (kFirst ? 0.0f : pl.py[r][c]));
  const float dz = z == d.nz - 1 ? -(kFirst ? 0.0f : pl.pz[r][c])
                                 : (z == 0 ? pzc : pzc - (kFirst ? 0.0f : pl.pz[r][c]));
  return ((dx + dy) + dz) - pl.f[r][c] / lam;
}

template <bool kFirst>
__global__ void __launch_bounds__(kTZ * kTY)
    tv_spatial_ring_kernel(Dims d, const float* __restrict__ f, const float* __restrict__ p,
                           float lam, float* __restrict__ p_out) {
  __shared__ Plane planes[kStages];
  __shared__ float dsh[2][kRY][kRZ];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int z0 = blockIdx.x * kTZ, y0 = blockIdx.y * kTY;
  const float* fb = f + (int64_t)blockIdx.z * d.n;
  const float* pb = kFirst ? nullptr : p + (int64_t)blockIdx.z * 3 * d.n;
  float* ob = p_out + (int64_t)blockIdx.z * 3 * d.n;
  const int sx = d.ny * d.nz;
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < d.nx) copy_plane<kFirst>(planes[s], fb, pb, s, y0, z0, d);
    commit();
  }
  for (int x = 0; x <= d.nx; ++x) {
    wait_prior<kStages - 2>();
    __syncthreads();
    if (x < d.nx) {
      const Plane& pl = planes[x % kStages];
      const Plane& before = planes[(x + kStages - 1) % kStages];
      auto& dn = dsh[x & 1];
      for (int r = warp; r < kRY; r += kTY) {
        const int y = y0 + r, z = z0 + lane;
        if (y < d.ny && z < d.nz) dn[r][lane] = d_at<kFirst>(pl, before, x, y, z, r, lane, d, lam);
      }
      const int t = warp * kTZ + lane;
      if (t < kTY && y0 + t < d.ny && z0 + kTZ < d.nz)
        dn[t][kTZ] = d_at<kFirst>(pl, before, x, y0 + t, z0 + kTZ, t, kTZ, d, lam);
    }
    __syncthreads();
    if (x > 0) {
      const int xu = x - 1, y = y0 + warp, z = z0 + lane;
      if (y < d.ny && z < d.nz) {
        const Plane& pl = planes[xu % kStages];
        const auto& dc = dsh[xu & 1];
        const float c = dc[warp][lane];
        const float gx = (x < d.nx ? dsh[x & 1][warp][lane] : c) - c;
        const float gy = (y + 1 < d.ny ? dc[warp + 1][lane] : c) - c;
        const float gz = (z + 1 < d.nz ? dc[warp][lane + 1] : c) - c;
        const float norm = sqrtf((gx * gx + gy * gy) + gz * gz);
        const float den = 1.0f + kTau * norm;
        const float px = kFirst ? 0.0f : pl.px[warp][lane];
        const float py = kFirst ? 0.0f : pl.py[warp + 1][lane];
        const float pz = kFirst ? 0.0f : pl.pz[warp][lane + 1];
        const int v = xu * sx + y * d.nz + z;
        ob[v] = (px + kTau * gx) / den;
        ob[d.n + v] = (py + kTau * gy) / den;
        ob[2 * d.n + v] = (pz + kTau * gz) / den;
      }
    }
    __syncthreads();
    const int next = x + kStages - 1;
    if (next < d.nx) copy_plane<kFirst>(planes[next % kStages], fb, pb, next, y0, z0, d);
    commit();
  }
}

}  // namespace ring

extern "C" int tv_spatial_launch(const float* f, const float* p, int B, int nx, int ny, int nz,
                                 float lam, float* p_out, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  Dims d;
  dim3 grid;
  const int err = launch_shape(B, nx, ny, nz, 1 << 30, d, grid);
  if (err) return err;
  const dim3 block(kTZ, kTY);
  const cudaStream_t s = (cudaStream_t)stream;
  if (p)
    ring::tv_spatial_ring_kernel<false><<<grid, block, 0, s>>>(d, f, p, lam, p_out);
  else
    ring::tv_spatial_ring_kernel<true><<<grid, block, 0, s>>>(d, f, p, lam, p_out);
  return (int)cudaGetLastError();
}

extern "C" int tv_spatial_launch_shipped("""

_PLANES = "constexpr int kPlanes = 4;"
_TILE_Y = "constexpr int kTY = 8;"

#: name -> (kernel, {source file: [(text, replacement), ...]})
SPATIAL_VARIANTS = {
    "voxel": ("tv_spatial", {"tv_spatial.cu": [
        ('extern "C" int tv_spatial_launch(', _VOXEL)]}),
    "voxel_flat": ("tv_spatial", {"tv_spatial.cu": [
        ('extern "C" int tv_spatial_launch(', _VOXEL_FLAT)]}),
    "ring": ("tv_spatial", {"tv_spatial.cu": [('extern "C" int tv_spatial_launch(', _RING)]}),
    # runs of 1, 2, 8 and 16 x planes a block, and the whole of x (one run)
    **{f"planes_{k}": ("tv_spatial", {"tv_spatial.cu": [
        (_PLANES, f"constexpr int kPlanes = {k};")]}) for k in (1, 2, 8, 16)},
    "planes_all": ("tv_spatial", {"tv_spatial.cu": [
        (_PLANES, "constexpr int kPlanes = 1 << 16;")]}),
    # no bound on the registers (40: 6 blocks an SM)
    "blocks_any": ("tv_spatial", {"tv_spatial.cu": [(
        "__global__ void __launch_bounds__(kTZ * kTY, 8)\n    tv_spatial_kernel(",
        "__global__ void __launch_bounds__(kTZ * kTY)\n    tv_spatial_kernel(")]}),
    "tile_4y": ("tv_spatial", {"tv_spatial.cu": [(_TILE_Y, "constexpr int kTY = 4;")]}),
    "tile_16y": ("tv_spatial", {"tv_spatial.cu": [(_TILE_Y, "constexpr int kTY = 16;")]}),
}

# tv_temporal's first form: one thread a voxel, 256 a block, each thread
# loading its 10 phases, running every iteration and storing; @LOAD@,
# @ITERATIONS@ and @STORE@ make its variants (only 10 phases are built)
_T_VOXEL = r"""
namespace voxel {

template <int NP>
__global__ void tv_temporal_voxel_kernel(const float* __restrict__ vol, int64_t n, float lam,
                                         int n_iter, float* __restrict__ out) {
  const int64_t v = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (v >= n) return;
  float x[NP], xl[NP], p[NP], q[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    x[k] = @LOAD@;
    xl[k] = x[k] / lam;
    p[k] = 0.0f;
  }
  const float tau = 0.25f;
  for (int it = 0; it < @ITERATIONS@; ++it) {
#pragma unroll
    for (int k = 0; k < NP; ++k) q[k] = (p[k] - p[(k + NP - 1) % NP]) - xl[k];
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const float g = q[(k + 1) % NP] - q[k];
      p[k] = (p[k] + tau * g) / (1.0f + tau * fabsf(g));
    }
  }
@STORE@
}

}  // namespace voxel

extern "C" int tv_temporal_launch(const float* vol, int n_phases, long long n, float lam,
                                  int n_iter, float* out, void* stream) {
  if (n_phases != 10) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  voxel::tv_temporal_voxel_kernel<10><<<(unsigned)((n + 255) / 256), 256, 0,
                                        (cudaStream_t)stream>>>(vol, n, lam, n_iter, out);
  return (int)cudaGetLastError();
}

extern "C" int tv_temporal_launch_shipped("""

_T_LOAD = "vol[k * n + v]"
# values of the path's magnitude (x / lambda ~ 100: the divisions' fast path)
_T_LOAD_MADE = "0.02f + 1e-6f * (float)((int)(v * 31 + k * 17) & 1023)"
_T_STORE = """#pragma unroll
  for (int k = 0; k < NP; ++k) out[k * n + v] = x[k] - lam * (p[k] - p[(k + NP - 1) % NP]);"""
# the results summed and stored only if the sum is one value it never takes
# here, so the loop is not dead code and nothing is written
_T_STORE_NEVER = """  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < NP; ++k) acc = acc + (x[k] - lam * (p[k] - p[(k + NP - 1) % NP]));
  if (acc == 1.5e-42f) out[v] = acc;"""


def _t_voxel(load: str, iterations: str, store: str) -> str:
    return (_T_VOXEL.replace("@LOAD@", load).replace("@ITERATIONS@", iterations)
            .replace("@STORE@", store))


_T_LAUNCH = 'extern "C" int tv_temporal_launch('
#: the shipped kernel for 10 phases in the SASS
TEMPORAL_SHIPPED = "tv_temporal_kernelILi10EiE"  # <10, int>

# design (A): a persistent grid (as many blocks as fit on the card at once)
# whose threads walk voxels v, v + stride, ..., issuing the loads of the next
# voxel's phases into a second set of registers before iterating over one
_T_PREFETCH = r"""
namespace prefetch {

template <int NP>
__global__ void __launch_bounds__(kThreads)
    tv_temporal_prefetch_kernel(const float* __restrict__ vol, int n, float lam, int n_iter,
                                float* __restrict__ out) {
  const int stride = gridDim.x * kThreads;
  const float lam_r = reciprocal(lam);
  const bool lam_in_range = lambda_in_range(lam);
  int v = blockIdx.x * kThreads + threadIdx.x;
  float next[NP];
  if (v < n) {
#pragma unroll
    for (int k = 0; k < NP; ++k) next[k] = vol[k * n + v];
  }
  for (; v < n; v += stride) {
    float x[NP], xl[NP], p[NP];
#pragma unroll
    for (int k = 0; k < NP; ++k) x[k] = next[k];
    divide_by_lambda<NP>(x, lam, lam_r, lam_in_range, xl);
    const int w = v + stride;
    if (w < n) {
#pragma unroll
      for (int k = 0; k < NP; ++k) next[k] = vol[k * n + w];
    }
    iterate<NP>(xl, n_iter, p);
#pragma unroll
    for (int k = 0; k < NP; ++k) out[k * n + v] = x[k] - lam * (p[k] - p[(k + NP - 1) % NP]);
  }
}

}  // namespace prefetch

extern "C" int tv_temporal_launch(const float* vol, int n_phases, long long n, float lam,
                                  int n_iter, float* out, void* stream) {
  if (n_phases != 10 || 10 * n + kThreads > INT_MAX) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, prefetch::tv_temporal_prefetch_kernel<10>,
                                                kThreads, 0);
  const long long tiles = (n + kThreads - 1) / kThreads, resident = (long long)per_sm * sms;
  prefetch::tv_temporal_prefetch_kernel<10>
      <<<(unsigned)(tiles < resident ? tiles : resident), kThreads, 0, (cudaStream_t)stream>>>(
          vol, (int)n, lam, n_iter, out);
  return (int)cudaGetLastError();
}

extern "C" int tv_temporal_launch_shipped("""

# design (B): a persistent grid whose blocks walk tiles of 256 voxels; one
# thread of a block copies the next tiles' phase rows into a ring of
# shared-memory stages by 1-D bulk copies (TMA), each stage completing an
# mbarrier; x stays in its stage until the tile's stores, so registers hold
# x / lambda, p and q only. Rows that are not 16-byte aligned (n not a
# multiple of 4, or the volume's address) are loaded by each thread into
# its own slots of the stage. One barrier a tile frees the stage.
_T_BULK = r"""
namespace bulk {

constexpr int kStages = 3;

__device__ __forceinline__ unsigned smem(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem(bar)) : "memory");
}

// the one arrival of a stage's phase, with the bytes its copies bring
__device__ __forceinline__ void bar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem(bar)),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred P;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem(dst)), "l"(src), "r"(bytes), "r"(smem(bar))
      : "memory");
}

template <int NP, typename I>
__global__ void __launch_bounds__(kThreads)
    tv_temporal_bulk_kernel(const float* __restrict__ vol, I n, float lam, int n_iter,
                            float* __restrict__ out, int aligned) {
  constexpr int S = NP <= 10 ? kStages : 2;
  __shared__ alignas(16) float stage[S][NP][kThreads];
  __shared__ alignas(8) uint64_t full[S];
  const int t = threadIdx.x;
  const I tiles = (n + kThreads - 1) / kThreads;
  const float lam_r = reciprocal(lam);
  const bool lam_in_range = lambda_in_range(lam);
  if (aligned && t == 0) {
    for (int s = 0; s < S; ++s) bar_init(&full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the block's j-th tile into stage j % S
  auto fill = [&](int j) {
    const I tile = (I)blockIdx.x + (I)j * (I)gridDim.x;
    if (!aligned || t != 0 || tile >= tiles) return;
    const I v0 = tile * kThreads;
    const unsigned bytes = (unsigned)((n - v0 < kThreads ? n - v0 : (I)kThreads) * 4);
    uint64_t* bar = &full[j % S];
    bar_expect(bar, NP * bytes);
#pragma unroll
    for (int k = 0; k < NP; ++k) bulk_copy(stage[j % S][k], vol + (k * n + v0), bytes, bar);
  };
  for (int j = 0; j < S - 1; ++j) fill(j);
  for (int j = 0;; ++j) {
    const I tile = (I)blockIdx.x + (I)j * (I)gridDim.x;
    if (tile >= tiles) break;
    fill(j + S - 1);  // into the stage the last tile freed
    const I v = tile * kThreads + t;
    float* xs = &stage[j % S][0][t];
    if (aligned) {
      bar_wait(&full[j % S], (unsigned)(j / S) & 1u);
    } else if (v < n) {
#pragma unroll
      for (int k = 0; k < NP; ++k) xs[k * kThreads] = vol[k * n + v];
    }
    if (v < n) {
      float x[NP], xl[NP], p[NP];
#pragma unroll
      for (int k = 0; k < NP; ++k) x[k] = xs[k * kThreads];
      divide_by_lambda<NP>(x, lam, lam_r, lam_in_range, xl);
      iterate<NP>(xl, n_iter, p);
#pragma unroll
      for (int k = 0; k < NP; ++k)
        out[k * n + v] = xs[k * kThreads] - lam * (p[k] - p[(k + NP - 1) % NP]);
    }
    __syncthreads();  // every thread is done with the stage before it is filled again
  }
}

}  // namespace bulk

extern "C" int tv_temporal_launch(const float* vol, int n_phases, long long n, float lam,
                                  int n_iter, float* out, void* stream) {
  if (n_phases != 10 || 10 * n + kThreads > INT_MAX) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bulk::tv_temporal_bulk_kernel<10, int>,
                                                kThreads, 0);
  const long long tiles = (n + kThreads - 1) / kThreads, resident = (long long)per_sm * sms;
  const int aligned = n % 4 == 0 && (uintptr_t)vol % 16 == 0;
  bulk::tv_temporal_bulk_kernel<10, int>
      <<<(unsigned)(tiles < resident ? tiles : resident), kThreads, 0, (cudaStream_t)stream>>>(
          vol, (int)n, lam, n_iter, out, aligned);
  return (int)cudaGetLastError();
}

extern "C" int tv_temporal_launch_shipped("""

_T_DIVIDE = "        p[k] = divide(p[k], b, reciprocal(b));"
_T_CHECK = "      fast = fast && numerator_in_range(p[k]);"
_T_BOUNDS = "__global__ void __launch_bounds__(kThreads)\n    tv_temporal_kernel("
_T_BULK_BOUNDS = "__launch_bounds__(kThreads)\n    tv_temporal_bulk_kernel("
_T_ITERATION = "  for (int it = 0; it < n_iter; ++it) {\n    float q[NP], t[NP];"
_T_THREADS = "constexpr int kThreads = 256;"

#: name -> (kernel, {source file: [(text, replacement), ...]}, the mangled
#: name's part that finds the variant's kernel for 10 phases in the SASS)
TEMPORAL_VARIANTS = {
    "voxel": ("tv_temporal", {"tv_temporal.cu": [
        (_T_LAUNCH, _t_voxel(_T_LOAD, "n_iter", _T_STORE))]}, "tv_temporal_voxel_kernelILi10E"),
    "voxel_loads_only": ("tv_temporal", {"tv_temporal.cu": [
        (_T_LAUNCH, _t_voxel(_T_LOAD, "0", _T_STORE))]}, "tv_temporal_voxel_kernelILi10E"),
    "voxel_loop_only": ("tv_temporal", {"tv_temporal.cu": [
        (_T_LAUNCH, _t_voxel(_T_LOAD_MADE, "n_iter", _T_STORE_NEVER))]},
        "tv_temporal_voxel_kernelILi10E"),
    "prefetch": ("tv_temporal", {"tv_temporal.cu": [(_T_LAUNCH, _T_PREFETCH)]},
                 "tv_temporal_prefetch_kernelILi10E"),
    "bulk": ("tv_temporal", {"tv_temporal.cu": [(_T_LAUNCH, _T_BULK)]},
             "tv_temporal_bulk_kernelILi10EiE"),
    # the shipped kernel with the compiler's divisions in the iteration (its
    # range check, branch and convergence barrier around each)
    "compiler_division": ("tv_temporal", {"tv_temporal.cu": [
        (_T_DIVIDE, "        p[k] = p[k] / b;"), (_T_CHECK, "")]}, TEMPORAL_SHIPPED),
    "unroll_2": ("tv_temporal", {"tv_temporal.cu": [
        (_T_ITERATION, "#pragma unroll 2\n" + _T_ITERATION)]}, TEMPORAL_SHIPPED),
    # the written-out divisions only for |a| >= 2^-32 in the iteration and
    # values in [2^-20, 2^20] for lambda's
    "narrow_ranges": ("tv_temporal", {"tv_temporal.cu": [
        ("constexpr float kNumeratorMin = 0x1p-90f;", "constexpr float kNumeratorMin = 0x1p-32f;"),
        ("constexpr float kValueMin = 0x1p-90f, kValueMax = 0x1p90f;",
         "constexpr float kValueMin = 0x1p-20f, kValueMax = 0x1p20f;")]}, TEMPORAL_SHIPPED),
    "threads_128": ("tv_temporal", {"tv_temporal.cu": [
        (_T_THREADS, "constexpr int kThreads = 128;")]}, TEMPORAL_SHIPPED),
    # registers bounded for 5 blocks of 256 an SM (51), and (B) for 5 and 6 (40)
    "blocks_5": ("tv_temporal", {"tv_temporal.cu": [
        (_T_BOUNDS, _T_BOUNDS.replace("(kThreads)", "(kThreads, 5)"))]}, TEMPORAL_SHIPPED),
    **{f"bulk_{b}": ("tv_temporal", {"tv_temporal.cu": [(_T_LAUNCH, _T_BULK.replace(
        _T_BULK_BOUNDS, _T_BULK_BOUNDS.replace("(kThreads)", f"(kThreads, {b})")))]},
        "tv_temporal_bulk_kernelILi10EiE") for b in (5, 6)},
    # the divisions by lambda as true divisions
    "lambda_true": ("tv_temporal", {"tv_temporal.cu": [
        ("  bool fast = lam_ok;", "  bool fast = false;")]}, TEMPORAL_SHIPPED),
    # no skip of the loop for a voxel with one value in every phase
    "no_skip": ("tv_temporal", {"tv_temporal.cu": [
        ("  if (still && in_range) return;", "  (void)still;")]}, TEMPORAL_SHIPPED),
}
#: variants whose results are not the function's (timed, not held)
TIMING_ONLY = {"voxel_loads_only", "voxel_loop_only"}


def volumes(device="cuda", air: bool = False) -> torch.Tensor:
    """The 10 phase volumes [phase, x, y, z] at 1 mm: mu 0.02 /mm in a
    cylinder of radius 100 mm about z, 1e-4 outside, the smoke's insert (mu
    0.08, radius 20 mm, at x = 40 mm) 20 mm up and down along z with the
    phase, and N(0, 2e-3) noise from seed 0. ``air``: exact zeros outside
    the circle inscribed in the grid's x-y square (AIR_RADIUS_MM; 21.5 % of
    the voxels), as outside an FDK volume's field of view."""
    n_phases, nx, ny, nz = SHAPE
    dev = torch.device(device)
    x, y, z = (torch.arange(k, device=dev, dtype=torch.float32) - (k - 1) / 2 for k in SHAPE[1:])
    r2 = (x[:, None] ** 2 + y[None, :] ** 2)[:, :, None]
    base = torch.where(r2 <= 100.0**2, 0.02, 1e-4).expand(nx, ny, nz)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = torch.empty(SHAPE, dtype=torch.float32, device=dev)
    for ph in range(n_phases):
        zc = 20.0 * math.cos(2.0 * math.pi * ph / n_phases)
        s2 = ((x[:, None, None] - 40.0) ** 2 + y[None, :, None] ** 2
              + (z[None, None, :] - zc) ** 2)
        out[ph] = torch.where(s2 <= 20.0**2, 0.08, base)
        out[ph] += 2e-3 * torch.randn((nx, ny, nz), generator=gen, device=dev)
    if air:
        out[:, r2[..., 0] > AIR_RADIUS_MM**2] = 0.0
    return out


def volume_stats(vols: torch.Tensor) -> dict:
    """Shares of the voxels (one value a phase) that ``tv_temporal`` treats
    apart: ``air`` 0 in every phase; ``still`` one value in every phase (air
    included), which skip the loop; ``lambda_out`` some nonzero |v| outside
    [2^-90, 2^90] (``_narrow``: [2^-20, 2^20]), where the divisions by lambda
    are true divisions; ``equal_neighbour`` not still but equal in two
    cyclically adjacent phases, whose first iteration has a zero numerator."""
    m = vols.abs()
    still = (vols == vols[0]).all(0)
    return dict(air=float((m == 0).all(0).float().mean()), still=float(still.float().mean()),
                lambda_out=float(((m != 0) & ((m < 2.0**-90) | (m > 2.0**90))).any(0)
                                 .float().mean()),
                lambda_out_narrow=float(((m != 0) & ((m < 2.0**-20) | (m > 2.0**20))).any(0)
                                        .float().mean()),
                equal_neighbour=float(((vols == torch.roll(vols, -1, 0)).any(0) & ~still)
                                      .float().mean()))


def clock_probe(cs, call, seconds: float = 1.5) -> dict:
    """The card's SM clock (MHz) and power draw (W), sampled by ``nvidia-smi``
    every 100 ms while ``call`` runs back to back for about ``seconds``: the
    median of the samples drawn under load (power above the midpoint of the
    lowest and highest sample) and their count."""
    n = max(1, int(seconds * 1e3 / cs.as_run_ms([call] * 3)))
    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                             "--format=csv,noheader,nounits", "-lms", "100"],
                            stdout=subprocess.PIPE, text=True)
    time.sleep(0.5)
    for _ in range(n):
        call()
    torch.cuda.synchronize()
    proc.terminate()
    text, _ = proc.communicate(timeout=30)
    samples = [tuple(float(v) for v in line.split(",")) for line in text.splitlines()
               if line.count(",") == 1]
    if not samples:
        return {}
    mid = (min(w for _, w in samples) + max(w for _, w in samples)) / 2
    busy = [(c, w) for c, w in samples if w >= mid]
    return dict(sm_mhz=statistics.median(c for c, _ in busy),
                power_w=statistics.median(w for _, w in busy), samples=len(busy))


def launch_split_ms(cs, call) -> dict:
    """``{device function: [launches, mean ms]}`` of the ``tv_spatial``
    functions in one profiled call after a warm-up call; empty where the
    profiler recorded none."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    split: dict = {}
    for name, t_us in cs.device_events(prof):
        if "tv_spatial" in name:
            key = name.split("(")[0].replace("void ", "")
            count, total = split.get(key, (0, 0.0))
            split[key] = (count + 1, total + t_us / 1e3)
    return {k: [c, total / c] for k, (c, total) in split.items()}


def timings(cs, kernels, rooster, vols, want, iterations=ITERATIONS) -> dict:
    """Per iteration count: bit-equality (where ``want`` holds the plain
    version's result), launches a call, profiler and event times of the
    call, the split by device function, peak memory."""
    lam = rooster.RoosterParameters().gamma_space
    out = {}
    for n_iter in iterations:
        def call(n_iter=n_iter):
            return rooster.spatial_tv(vols, lam, n_iter)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        before = kernels.launch_counts["tv_spatial"]
        got = call()
        torch.cuda.synchronize()
        launches = kernels.launch_counts["tv_spatial"] - before
        peak = torch.cuda.max_memory_allocated()
        n_off = int((got != want[n_iter]).sum()) if want else None
        del got
        reps = REPS[n_iter]
        ms, timer = cs.kernel_ms([call] * (reps + 1), "tv_spatial", launches)
        out[f"x{n_iter}"] = dict(voxels_differ=n_off, launches=launches, ms=ms, timer=timer,
                                 events_ms=cs.as_run_ms([call] * (reps + 1)),
                                 by_function=launch_split_ms(cs, call),
                                 peak_gb=peak / 1e9, call_gb=(peak - held) / 1e9)
    return out


def yardsticks(cs, vols) -> dict:
    """What one PyTorch call moves on these tensors: ``out.copy_(f)`` (8 B a
    voxel) and ``torch.add(p, f[:, None], out=q)`` over the dual variable's
    shape (p and f in, q out: the 28 B a voxel of an iteration's stream),
    by CUDA events, with the rates they reach."""
    n = vols.numel()
    out = torch.empty_like(vols)
    p = torch.zeros((vols.shape[0], 3, *vols.shape[1:]), device=vols.device)
    q = torch.empty_like(p)
    copy_ms = cs.as_run_ms([lambda: out.copy_(vols)] * 6)
    add_ms = cs.as_run_ms([lambda: torch.add(p, vols[:, None], out=q)] * 4)
    return dict(copy_ms=copy_ms, copy_tb_s=8 * n / copy_ms / 1e9, stream_ms=add_ms,
                stream_tb_s=28 * n / add_ms / 1e9)


def rows_of_256(cs, kernels, rooster) -> dict:
    """The call at 10 iterations on (10, 464, 464, 256), whose z rows start
    on 1 KiB boundaries (those of nz = 250 do not), timing only."""
    vols = volumes()
    vols = torch.cat([vols, vols[..., :6]], dim=-1).contiguous()
    return timings(cs, kernels, rooster, vols, None, iterations=(10,))["x10"]


# ---------------------------------------------------------------------------
# SASS: loops counted in the compiled kernels (cuobjdump)
# ---------------------------------------------------------------------------
SMS, ISSUE_PER_CLOCK, LANES = 132, 4, 32  # H100 SXM: SMs, warp instructions an SM a clock


def _sass_functions(lib: Path) -> dict:
    """``{mangled name: [(address, instruction text), ...]}`` of a library's
    SASS, or ``{}`` where the toolkit has no ``cuobjdump``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    funcs, current = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = funcs.setdefault(m.group(1), [])
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and current is not None:
            current.append((int(m.group(1), 16), m.group(2)))
    return funcs


def _branch_target(ins: str):
    m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", ins)
    return int(m.group(1), 16) if m else None


def _fast_path(code: list, start: int, end: int) -> list:
    """The instructions of one pass through the loop ``start``..``end`` on
    its fast path: from the top, a forward branch is followed where it is
    unconditional or where the instructions it skips hold a call (the slow
    paths of correctly rounded divisions and square roots, and a block of
    true divisions taken only when a range check fails), else passed."""
    at = {a: k for k, (a, _) in enumerate(code)}
    k, path = at[start], []
    while k < len(code):
        addr, ins = code[k]
        path.append((addr, ins))
        if addr >= end:
            break
        t = _branch_target(ins)
        if t is not None and addr < t <= end and (
                not ins.startswith("@") or any("CALL" in i for a, i in code if addr < a < t)):
            k = at[t]
            continue
        k += 1
    return path


def sass_loops(lib: Path, mangled_part: str) -> list:
    """Every loop (a backward branch) of the first function whose mangled
    name holds ``mangled_part``: ``{start, end, instructions, fast_path,
    mufu_rcp, innermost}`` (addresses in hex; ``fast_path`` and
    ``mufu_rcp``: the instructions of one pass on the fast path
    (:func:`_fast_path`) and the MUFU.RCP among them, one a division;
    ``innermost``: no other loop lies inside it)."""
    funcs = _sass_functions(lib)
    name = next((k for k in funcs if mangled_part in k), None)
    if name is None:
        return []
    code = funcs[name]
    spans = [(t, addr) for addr, ins in code
             if (t := _branch_target(ins)) is not None and t <= addr]
    loops = []
    for t, addr in spans:
        body = [(a, i) for a, i in code if t <= a <= addr]
        fast = _fast_path(code, t, addr)
        inner = any(t <= s and e <= addr and (s, e) != (t, addr) for s, e in spans)
        loops.append(dict(function=name, start=f"{t:x}", end=f"{addr:x}",
                          instructions=len(body), fast_path=len(fast),
                          mufu_rcp=sum("MUFU.RCP" in i for _, i in fast), innermost=not inner))
    return loops


def max_sm_clock_mhz() -> float:
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])


def temporal_issue(lib: Path, mangled_part: str, n_phases: int, voxels: int,
                   n_iter: int) -> dict | None:
    """The iteration loop of a ``tv_temporal`` kernel (the largest innermost
    loop that holds the iteration's ``n_phases`` divisions, one MUFU.RCP
    each): its instructions per iteration on the fast path and the
    issue-rate time of ``n_iter`` iterations over ``voxels`` voxels (one
    thread a voxel, 32 a warp) on SMS SMs issuing ISSUE_PER_CLOCK warp
    instructions a clock at the card's maximum SM clock. None where the
    toolkit has no ``cuobjdump`` or no such loop was found."""
    inner = [lp for lp in sass_loops(lib, mangled_part)
             if lp["innermost"] and lp["mufu_rcp"] >= n_phases]
    if not inner:
        return None
    loop = max(inner, key=lambda lp: lp["instructions"])
    unrolled = loop["mufu_rcp"] // n_phases
    per_iter = loop["fast_path"] / unrolled
    clock_mhz = max_sm_clock_mhz()
    rate = SMS * ISSUE_PER_CLOCK * clock_mhz * 1e6  # warp instructions a second
    return dict(instructions_per_iteration=per_iter, loop_instructions=loop["instructions"],
                iterations_per_loop_pass=unrolled, clock_mhz=clock_mhz,
                issue_ms=per_iter * n_iter * voxels / LANES / rate * 1e3)


def ptxas_usage(log: str, mangled_part: str) -> list:
    """The ``ptxas -v`` lines (registers, shared memory, spills) of the entry
    functions whose mangled name holds ``mangled_part``."""
    lines, current = [], ""
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\S+?)'?(?: |$)",
                      line)
        if m:
            current = m.group(1)
        elif mangled_part in current and re.search(r"registers|spill|smem", line):
            lines.append(line.strip())
    return lines


def temporal_timings(cs, kernels, rooster, vols, want, iterations=TEMPORAL_ITERATIONS,
                     air=None) -> dict:
    """Per iteration count: bit-equality (where ``want`` holds the plain
    version's result), launches a call, profiler and event times of the
    call; the card's clock and power while the call at 10 iterations runs
    back to back; with ``air = (volumes, want)`` the same at 10 iterations
    on those volumes (``air_x10``)."""
    lam = rooster.RoosterParameters().gamma_time
    out = {}
    for n_iter in iterations:
        def call(n_iter=n_iter):
            return rooster.temporal_tv(vols, lam, n_iter)

        torch.cuda.synchronize()
        before = kernels.launch_counts["tv_temporal"]
        got = call()
        torch.cuda.synchronize()
        launches = kernels.launch_counts["tv_temporal"] - before
        n_off = int((got != want[n_iter]).sum()) if want else None
        del got
        reps = REPS[n_iter]
        ms, timer = cs.kernel_ms([call] * (reps + 1), "tv_temporal", launches)
        out[f"x{n_iter}"] = dict(voxels_differ=n_off, launches=launches, ms=ms, timer=timer,
                                 events_ms=cs.as_run_ms([call] * (reps + 1)))
        if n_iter == ITERATIONS[-1]:
            out[f"x{n_iter}"]["clock"] = clock_probe(cs, call)
    if air is not None:
        out["air_x10"] = temporal_timings(cs, kernels, rooster, air[0],
                                          {n: air[1] for n in ITERATIONS[-1:]} if air[1]
                                          is not None else None, ITERATIONS[-1:])["x10"]
    return out


def temporal_sass(lib: Path, mangled_part: str) -> dict | None:
    """``tv_temporal``'s iteration loop in ``lib`` and the issue-rate time of
    ROOSTER's call (10 iterations over the 53,824,000 voxels of 10 phases)."""
    n_phases, nx, ny, nz = SHAPE
    return temporal_issue(lib, mangled_part, n_phases, nx * ny * nz, ITERATIONS[-1])


def sass_counts(kernels, which) -> dict:
    """The loops of ``tv_spatial``'s iteration kernel and of ``tv_temporal``'s
    kernel for 10 phases; ``tv_temporal``'s iteration loop as an issue-rate
    time (:func:`temporal_sass`); for ``tv_spatial``'s march, the issue-rate
    time of one iteration launch if every warp ran the whole loop body once
    a plane."""
    paths = kernels.build_kernels(which)
    out = {}
    if "tv_temporal" in which:
        # the 32-bit instance for 10 phases, or the one instance of a kernel
        # that has no index type (this kernel's first form)
        part = next((k for k in (TEMPORAL_SHIPPED, "tv_temporal_kernelILi10E")
                     if sass_loops(paths["tv_temporal"], k)), TEMPORAL_SHIPPED)
        out["tv_temporal"] = sass_loops(paths["tv_temporal"], part)
        out["tv_temporal_issue"] = temporal_sass(paths["tv_temporal"], part)
    if "tv_spatial" in which:
        out["tv_spatial"] = sass_loops(paths["tv_spatial"], "tv_spatial_kernelILb0E")
        if out["tv_spatial"]:
            # the march's loop once a plane for every warp: at most, since only warps 0
            # and 1 run the halo's block (tiles of 32 z x 8 y, 8 warps a block)
            rate = SMS * ISSUE_PER_CLOCK * max_sm_clock_mhz() * 1e6
            loop = max(out["tv_spatial"], key=lambda lp: lp["instructions"])
            n_phases, nx, ny, nz = SHAPE
            warps = n_phases * -(-nz // 32) * -(-ny // 8) * 8
            out["tv_spatial_issue"] = dict(instructions_per_plane=loop["fast_path"],
                                           issue_ms_at_most=loop["fast_path"] * warps * nx
                                           / rate * 1e3)
    if not any(out.values()):
        out["note"] = "no cuobjdump in the toolkit, or no such function"
    return out


def spatial_variants(cs, kernels, card, rooster, vols, want) -> dict:
    built = kernel_variants.build_variants(kernels, SPATIAL_VARIANTS)
    out = {"shipped": dict(**timings(cs, kernels, rooster, vols, want),
                           rows_of_256=rows_of_256(cs, kernels, rooster))}
    for name, (kernel, fn) in built.items():
        with kernel_variants.swapped(kernels, kernel, fn):
            out[name] = dict(**timings(cs, kernels, rooster, vols, want),
                             rows_of_256=rows_of_256(cs, kernels, rooster))
        cs.say(f"variant {name}: {out[name]}", card)
    out["shipped again"] = timings(cs, kernels, rooster, vols, want)
    return out


def temporal_variants(cs, kernels, card, rooster, vols, want, air) -> dict:
    built = kernel_variants.build_variants(
        kernels, {name: v[:2] for name, v in TEMPORAL_VARIANTS.items()})
    out = {"shipped": temporal_timings(cs, kernels, rooster, vols, want, air=air)}
    for name, (kernel, fn) in built.items():
        lib = kernels.BUILD_DIR / "variants" / name / f"lib{name}.so"
        log = (lib.parent / "build_log.txt").read_text()
        pattern = TEMPORAL_VARIANTS[name][2]
        with kernel_variants.swapped(kernels, kernel, fn):
            exact = name not in TIMING_ONLY
            out[name] = dict(**temporal_timings(cs, kernels, rooster, vols,
                                                want if exact else None,
                                                air=(air[0], air[1] if exact else None)),
                             sass=temporal_sass(lib, pattern),
                             ptxas=ptxas_usage(log, pattern))
        cs.say(f"variant {name}: {out[name]}", card)
    out["shipped again"] = temporal_timings(cs, kernels, rooster, vols, want, air=air)
    return out


def differing(result, path="") -> list:
    """The paths in ``result`` whose ``voxels_differ`` is not 0 (or None)."""
    if not isinstance(result, dict):
        return []
    here = [path] if result.get("voxels_differ") else []
    return here + [p for k, v in result.items() for p in differing(v, f"{path}/{k}")]


def child(root: Path, with_variants: bool) -> None:
    cs = kernel_variants.enter(root)
    from cbctmc_tpu_torch.engine import kernels
    from cbctmc_tpu_torch.recon import rooster

    only = [a.split("=", 1)[1] for a in sys.argv if a.startswith("--only=")]
    which = tuple(only) or ("tv_spatial", "tv_temporal")
    given = [a.split("=", 1)[1] for a in sys.argv if a.startswith("--volumes=")]
    card = cs.card_line()
    kernels.build_kernels(which)
    if "tv_spatial" in which:
        for line in kernels.build_logs.get("tv_spatial", "").splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                cs.say(f"ptxas tv_spatial: {line.strip()}")
    if "tv_temporal" in which:
        for line in ptxas_usage(kernels.build_logs.get("tv_temporal", ""), TEMPORAL_SHIPPED):
            cs.say(f"ptxas tv_temporal (10 phases): {line}")
    vols = (torch.from_numpy(np.load(HOME / given[0])).to("cuda") if given else volumes())
    result = {"root": str(root), "card": card, "volumes": given[0] if given else "made here",
              "volume_stats": volume_stats(vols), "sass": sass_counts(kernels, which)}
    if "tv_spatial" in which:
        lam = rooster.RoosterParameters().gamma_space
        want = {n: rooster.spatial_tv_reference(vols, lam, n) for n in ITERATIONS}
        result["tv_spatial"] = dict(**timings(cs, kernels, rooster, vols, want),
                                    yardsticks=yardsticks(cs, vols))
        cs.say(f"{root} tv_spatial: {result['tv_spatial']}", card)
        if with_variants:
            result["tv_spatial"]["variants"] = spatial_variants(cs, kernels, card, rooster,
                                                                vols, want)
        del want
    if "tv_temporal" in which:
        lam = rooster.RoosterParameters().gamma_time
        want = {n: rooster.temporal_tv_reference(vols, lam, n) for n in TEMPORAL_ITERATIONS}
        air_vols = volumes(air=True)
        air = (air_vols, rooster.temporal_tv_reference(air_vols, lam, ITERATIONS[-1]))
        result["tv_temporal"] = temporal_timings(cs, kernels, rooster, vols, want, air=air)
        cs.say(f"{root} tv_temporal: {result['tv_temporal']}", card)
        if with_variants:
            result["tv_temporal"]["variants"] = temporal_variants(cs, kernels, card, rooster,
                                                                  vols, want, air)
    cs.say(f"{root}: sass {result['sass']}", card)
    bad = differing(result)
    kernel_variants.emit(result)
    if bad:
        raise SystemExit(f"differs from its plain version at {bad}")


if __name__ == "__main__":
    sys.exit(kernel_variants.main(__doc__, __file__, child))
