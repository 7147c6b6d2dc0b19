// flight_prototype: fused Woodcock multi-flight over split material/density
// voxel arrays, with exactly the contract of the Pallas prototype.
//
// Replaces: cbctmc_tpu/engine/pallas_kernels.py::_flight_kernel. For each
// lane and each of n_flights steps: step = -mfp_wc*log(u_step); advance;
// bbox test with eps 1.5e-5; flat voxel index (only vx clipped to
// [0, 2^30], then the flat index clipped to [0, nvox-1]); gather material
// and density; inv_mfp = a + E*b at row ebin*n_mats + mat; the event is real
// iff u_int >= 1 - mfp_wc*den*inv_mfp. Outputs the final positions [3, n]
// and the flags (pending, escaped, randno, mfp_density) [4, n].
//
// Bound on the H100: bytes. Per lane it streams pos, dir, state, active and
// 2*F uniforms in and 7 words out (104 B at F = 4), and makes two random
// 4-byte voxel gathers plus one 8-byte (a, b) row gather per active flight,
// each costing a 32-byte sector when it misses L2. At 4 flights the
// arithmetic (one logf and ~30 flops per flight) is far below the bytes.
//
// Design: one thread per lane; the TPU's sequential flight loop becomes a
// loop inside the thread, so lane state stays in registers across flights
// and the inputs are read once. Lane arrays are structure-of-arrays rows, so
// neighbouring threads read neighbouring words. Gathers are native loads
// (the Mosaic lowering that stopped the TPU version is not needed here);
// the small (a, b) table stays hot in L1/L2. The flight count is read on
// the device (the Pallas scalar prefetch), capped at the uniform rows given.

#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void flight_prototype_kernel(
    const int32_t* __restrict__ n_flights, const float* __restrict__ pos,
    const float* __restrict__ dir, const float* __restrict__ state,
    const float* __restrict__ active, const float* __restrict__ u, int f_cap,
    const float* __restrict__ voxmat, const float* __restrict__ voxden, int nvox,
    const float* __restrict__ mfp_ab, int rows, const float* __restrict__ geom,
    float* __restrict__ out_pos, float* __restrict__ out_flags, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float inv_vx = geom[0], inv_vy = geom[1], inv_vz = geom[2];
  const float bx = geom[3], by = geom[4], bz = geom[5];
  const int nx = (int)geom[6], nxny = (int)geom[7];
  const float eps = 1.5e-5f;

  float px = pos[i], py = pos[n + i], pz = pos[2 * n + i];
  const float dx = dir[i], dy = dir[n + i], dz = dir[2 * n + i];
  const float energy = state[i];
  const float mfp_wc = state[n + i];
  const int row_base = (int)state[2 * n + i];
  const bool lane_active = active[i] > 0.5f;

  float pending = 0.f, escaped = 0.f, randno = 0.f, mfp_density = 0.f;
  int nf = n_flights[0];
  nf = nf < f_cap ? nf : f_cap;
  for (int f = 0; f < nf; ++f) {
    const bool act = lane_active && pending < 0.5f && escaped < 0.5f;
    const float u_step = u[(2 * f) * n + i];
    const float u_int = u[(2 * f + 1) * n + i];
    const float step = -mfp_wc * logf(u_step);
    const float npx = act ? px + step * dx : px;
    const float npy = act ? py + step * dy : py;
    const float npz = act ? pz + step * dz : pz;
    const bool inside = (npx >= eps) && (npx <= bx - eps) && (npy >= eps) &&
                        (npy <= by - eps) && (npz >= eps) && (npz <= bz - eps);
    // float -> int truncates toward zero and saturates, as XLA's convert
    const int vx = clampi((int)(npx * inv_vx), 0, 1 << 30);
    const int vy = (int)(npy * inv_vy);
    const int vz = (int)(npz * inv_vz);
    // two's-complement wrap of the int32 index arithmetic, as in JAX
    int vox = (int)((unsigned)vx + (unsigned)vy * (unsigned)nx +
                    (unsigned)vz * (unsigned)nxny);
    vox = clampi(vox, 0, nvox - 1);

    const int mat = (int)__ldg(voxmat + vox);
    const float den = __ldg(voxden + vox);
    const int row = clampi(row_base + mat, 0, rows - 1);
    const float inv_mfp = __ldg(mfp_ab + 2 * row) + energy * __ldg(mfp_ab + 2 * row + 1);
    const float mfp_den = mfp_wc * den;
    const float p_delta = 1.0f - mfp_den * inv_mfp;
    const bool real = act && inside && (u_int >= p_delta);
    const bool newly_escaped = act && !inside;

    px = npx;
    py = npy;
    pz = npz;
    if (real) {
      pending = 1.f;
      randno = u_int;
      mfp_density = mfp_den;
    }
    if (newly_escaped) escaped = 1.f;
  }
  out_pos[i] = px;
  out_pos[n + i] = py;
  out_pos[2 * n + i] = pz;
  out_flags[i] = pending;
  out_flags[n + i] = escaped;
  out_flags[2 * n + i] = randno;
  out_flags[3 * n + i] = mfp_density;
}

extern "C" int flight_prototype_launch(
    const int32_t* n_flights, const float* pos, const float* dir, const float* state,
    const float* active, const float* u, int f_cap, const float* voxmat,
    const float* voxden, int nvox, const float* mfp_ab, int rows, const float* geom,
    float* out_pos, float* out_flags, int n, void* stream) {
  if (n > 0) {
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    flight_prototype_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        n_flights, pos, dir, state, active, u, f_cap, voxmat, voxden, nvox, mfp_ab,
        rows, geom, out_pos, out_flags, n);
  }
  return (int)cudaGetLastError();
}
