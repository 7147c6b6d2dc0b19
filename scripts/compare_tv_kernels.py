#!/usr/bin/env python3
"""Time ROOSTER's spatial TV kernel, ``tv_spatial``, of one or more
checkouts of this repository on one card, in turns, and count the SASS
instructions of the TV kernels' loops.

Usage (on a machine with one CUDA card)::

    python3 scripts/compare_tv_kernels.py ROOT [ROOT ...] [--variants]

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
- counts, with ``cuobjdump -sass`` where the toolkit has it, the
  instructions of every loop of ``tv_spatial``'s iteration kernel and of
  ``tv_temporal_kernel<10>``, and turns ``tv_temporal``'s iteration loop
  into an issue-rate time: its instructions per iteration x 53,824,000
  voxels / 32 lanes x 10 iterations over 132 SMs x 4 warp instructions a
  clock at the card's maximum SM clock (``nvidia-smi``).

With ``--variants``, the process of the checkout that holds this script
(each time it is named) also builds variants of the iteration kernel
(``VARIANTS``: text edits of ``csrc/tv_spatial.cu``, each of which must
match once), holds each against the plain version as above and times it in
the same process beside the shipped kernel, through the package's own
wrapper (the finish stays the shipped one), and times the shipped kernel
and each variant at 10 iterations on rows of 256 z as well (timing only).
Every line names the card and its power limit; the last line of the output
is one JSON object with every checkout's results.
"""

from __future__ import annotations

import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import kernel_variants
import torch

SHAPE = (10, 464, 464, 250)  # the recon-mc path's phases on reconstruct_4d's grid
ITERATIONS = (1, 10)  # the smoke's check and ROOSTER's n_tv_iterations
REPS = {1: 5, 10: 3}  # timed calls
SMS, ISSUE_PER_CLOCK, LANES = 132, 4, 32
SLOW_BLOCK = 8  # instructions around the call of a division's or square root's slow path

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
VARIANTS = {
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


def volumes(device="cuda") -> torch.Tensor:
    """The 10 phase volumes [phase, x, y, z] at 1 mm: mu 0.02 /mm in a
    cylinder of radius 100 mm about z, 1e-4 outside, the smoke's insert (mu
    0.08, radius 20 mm, at x = 40 mm) 20 mm up and down along z with the
    phase, and N(0, 2e-3) noise from seed 0."""
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
    return out


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


def _sass_functions(lib: Path) -> dict:
    """``{mangled name: [(address, instruction text), ...]}`` of a library's
    SASS, or ``{}`` where the toolkit has no ``cuobjdump``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
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


def _target(ins: str):
    m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", ins)
    return int(m.group(1), 16) if m else None


def sass_loops(lib: Path, mangled_part: str) -> list:
    """Every loop (a backward branch) of the first function whose mangled
    name holds ``mangled_part``: ``{start, end, instructions, fast_path,
    mufu_rcp}`` (addresses in hex; ``fast_path`` leaves out the short
    blocks, at most SLOW_BLOCK instructions, that a conditional branch
    skips and that hold a call: the calls of the slow paths of correctly
    rounded divisions and square roots; MUFU.RCP begins each division)."""
    funcs = _sass_functions(lib)
    name = next((k for k in funcs if mangled_part in k), None)
    if name is None:
        return []
    code = funcs[name]
    slow = set()  # addresses of the short blocks around a call that a branch skips
    for addr, ins in code:
        t = _target(ins)
        if ins.startswith("@") and t is not None and t > addr:
            block = [(a, i) for a, i in code if addr < a < t]
            if len(block) <= SLOW_BLOCK and any("CALL" in i for _, i in block):
                slow.update(a for a, _ in block)
    loops = []
    for addr, ins in code:
        t = _target(ins)
        if t is not None and t <= addr:
            body = [(a, i) for a, i in code if t <= a <= addr]
            loops.append(dict(function=name, start=f"{t:x}", end=f"{addr:x}",
                              instructions=len(body),
                              fast_path=sum(a not in slow for a, _ in body),
                              mufu_rcp=sum("MUFU.RCP" in i for _, i in body)))
    return loops


def sass_counts(cs, kernels) -> dict:
    """The loops of ``tv_spatial``'s iteration kernel and of
    ``tv_temporal_kernel<10>``; for ``tv_temporal``'s largest loop, its
    instructions per iteration on the fast path (10 divisions an iteration,
    one MUFU.RCP each) and the issue-rate time of ROOSTER's call (10
    iterations over 53,824,000 voxels of 10 phases); for ``tv_spatial``'s
    march, the issue-rate time of one iteration launch if every warp ran
    the whole loop body once a plane."""
    paths = kernels.build_kernels(("tv_spatial", "tv_temporal"))
    out = {"tv_spatial": sass_loops(paths["tv_spatial"], "tv_spatial_kernelILb0E"),
           "tv_temporal": sass_loops(paths["tv_temporal"], "tv_temporal_kernelILi10E")}
    if not out["tv_temporal"]:
        out["note"] = "no cuobjdump in the toolkit, or no such function"
        return out
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    rate = SMS * ISSUE_PER_CLOCK * clock_mhz * 1e6  # warp instructions a second
    loop = max(out["tv_temporal"], key=lambda lp: lp["instructions"])
    unrolled = max(1, loop["mufu_rcp"] // 10)
    per_iter = loop["fast_path"] / unrolled
    n_phases, nx, ny, nz = SHAPE
    out["tv_temporal_issue"] = dict(
        instructions_per_iteration=per_iter, iterations_per_loop_pass=unrolled,
        clock_mhz=clock_mhz, issue_ms=per_iter * 10 * nx * ny * nz / LANES / rate * 1e3)
    if out["tv_spatial"]:
        # the march's loop once a plane for every warp: at most, since only warps 0
        # and 1 run the halo's block (tiles of 32 z x 8 y, 8 warps a block)
        loop = max(out["tv_spatial"], key=lambda lp: lp["instructions"])
        warps = n_phases * -(-nz // 32) * -(-ny // 8) * 8
        out["tv_spatial_issue"] = dict(instructions_per_plane=loop["fast_path"],
                                       issue_ms_at_most=loop["fast_path"] * warps * nx / rate
                                       * 1e3)
    return out


def variants(cs, kernels, card, rooster, vols, want) -> dict:
    built = kernel_variants.build_variants(kernels, VARIANTS)
    out = {"shipped": dict(**timings(cs, kernels, rooster, vols, want),
                           rows_of_256=rows_of_256(cs, kernels, rooster))}
    for name, (kernel, fn) in built.items():
        with kernel_variants.swapped(kernels, kernel, fn):
            out[name] = dict(**timings(cs, kernels, rooster, vols, want),
                             rows_of_256=rows_of_256(cs, kernels, rooster))
        cs.say(f"variant {name}: {out[name]}", card)
    out["shipped again"] = timings(cs, kernels, rooster, vols, want)
    return out


def child(root: Path, with_variants: bool) -> None:
    cs = kernel_variants.enter(root)
    from cbctmc_tpu_torch.engine import kernels
    from cbctmc_tpu_torch.recon import rooster

    card = cs.card_line()
    kernels.build_kernels(("tv_spatial",))
    for line in kernels.build_logs.get("tv_spatial", "").splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            cs.say(f"ptxas tv_spatial: {line.strip()}")
    vols = volumes()
    lam = rooster.RoosterParameters().gamma_space
    want = {n: rooster.spatial_tv_reference(vols, lam, n) for n in ITERATIONS}
    result = {"root": str(root), "card": card, **timings(cs, kernels, rooster, vols, want),
              "yardsticks": yardsticks(cs, vols), "sass": sass_counts(cs, kernels)}
    cs.say(f"{root}: {result}", card)
    if with_variants:
        result["variants"] = variants(cs, kernels, card, rooster, vols, want)
    bad = [k for k, v in result.items() if isinstance(v, dict) and v.get("voxels_differ")]
    kernel_variants.emit(result)
    if bad:
        raise SystemExit(f"tv_spatial differs from its plain version at {bad}")


if __name__ == "__main__":
    sys.exit(kernel_variants.main(__doc__, __file__, child))
