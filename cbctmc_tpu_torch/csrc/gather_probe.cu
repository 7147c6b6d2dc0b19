// gather_probe: per-lane dynamic gather out[i] = table[idx[i]].
//
// Replaces: the Pallas kernel cbctmc_tpu/engine/pallas_kernels.py::_gather_kernel
// (reached through probe_vmem_gather), which checked whether per-lane
// dynamic indexing of an on-chip table lowers on the TPU (it does not on a
// v5e). On Hopper a per-thread load from any address is native, so the
// engine also reads the two angle inverse-CDF knots of every lane through
// this kernel in each event resolve (65,536 lanes into a table of a few
// hundred KB at the production shapes).
//
// Bound on the H100: bytes. One 4-byte index read and one 4-byte value
// written per lane, plus the table entries touched (the probe's table is
// 128 KB, resident in L2 after first touch). There are no arithmetic
// operations to speak of; at these sizes the launch itself dominates.
//
// Design: one thread per index, consecutive threads on consecutive indices
// and outputs (coalesced 128-byte transactions); the table read goes
// through the read-only data cache (__ldg). Indices are clamped into the
// table, matching the JAX gather's clamping, so no index can fault.

#include <cstdint>
#include <cuda_runtime.h>

__global__ void gather_probe_kernel(const float* __restrict__ table, int table_size,
                                    const int32_t* __restrict__ idx,
                                    float* __restrict__ out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int j = idx[i];
  j = j < 0 ? 0 : (j >= table_size ? table_size - 1 : j);
  out[i] = __ldg(table + j);
}

extern "C" int gather_probe_launch(const float* table, int table_size,
                                   const int32_t* idx, float* out, int n,
                                   void* stream) {
  if (n > 0) {
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    gather_probe_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        table, table_size, idx, out, n);
  }
  return (int)cudaGetLastError();
}
