// tally: score each lane's escape record into the 4-class detector image,
// once per outer iteration, and leave the loop condition on the device.
//
// Replaces: the tally stage of the JAX engine's loop body
// (cbctmc_tpu/engine/transport.py run_projection: _tally_pixel, the
// stash / doubles logic and the scatter-add into the f32[4 * npix + 1]
// image) and the while_loop's condition (budget left, any lane alive, any
// record stashed). No Pallas counterpart: on the TPU it is a one-hot-free
// XLA scatter inside the compiled loop.
//
// Bound on the H100: bytes. A lane reads 3 flag bytes and, where it holds a
// record, up to 9 state words; it writes up to 3 words and does one 4-byte
// atomic add into the image (a 32-byte sector of L2 each): at most ~110 B
// per lane, 7 MB per launch at 65,536 lanes; with the typical third of the
// lanes holding a record, about 2 MB. The arithmetic (one detector-plane
// intersection for a parked record) is negligible.
//
// Design: one thread per lane; the tally is an atomicAdd per record (the
// image, 22.7 MB at 1848 x 768, stays in L2), as MC-GPU scores. The order
// of the adds differs from run to run, so the image agrees with the plain
// version's index_add_ to rounding, not bit for bit; the integer counters
// are exact. Records and tallied energy (float64) are summed per block and
// added with one atomic each. Each block ORs whether it holds a live lane
// or a stashed record; the block that finishes last writes the word the
// host reads once per iteration beside the budget. Each block also leaves
// its count of dead lanes for the next refill's ordered tail.

#include "flight.cuh"

__global__ void __launch_bounds__(PHASE_THREADS)
tally_kernel(Lanes L, float* __restrict__ image, int32_t* ctrl,
             unsigned long long* counters, double* energy_sum, int32_t* block_dead,
             Params P) {
  __shared__ int s_buf[32];
  __shared__ double s_dbuf[32];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int npix = P.npix_x * P.npix_z;
  int tallied = 0, live = 0, dead = 0;
  double tallied_energy = 0.0;
  if (i < P.n) {
    const bool alive = L.alive[i];
    const bool escaped = L.escaped[i];
    const bool stash_valid = L.stash_valid[i];
    int parked_idx = 4 * npix;  // the dropped sentinel
    float parked_energy = 0.0f;
    if (escaped) {
      const int pix = detector_pixel(L.px[i], L.py[i], L.pz[i], L.dx[i], L.dy[i], L.dz[i], P);
      if (pix >= 0) {
        parked_idx = L.scatter[i] * npix + pix;
        parked_energy = L.energy[i];
      }
    }
    const bool parked = parked_idx < 4 * npix;
    int idx = parked_idx;
    float val = parked_energy;
    bool doubles = false;
    if (stash_valid) {
      const int stash_idx = L.stash_idx[i];
      if (stash_idx < 4 * npix) {
        idx = stash_idx;
        val = L.stash_energy[i];
        doubles = parked;  // the parked record waits for the next tally
      }
      if (doubles) {
        L.stash_idx[i] = parked_idx;
        L.stash_energy[i] = parked_energy;
      } else {
        L.stash_valid[i] = 0;
      }
    }
    if (idx < 4 * npix) {
      atomicAdd(image + (idx < 0 ? 0 : idx), val);
      tallied = 1;
      tallied_energy = (double)val;
    }
    live = alive || doubles;
    dead = !alive;
  }

  tallied = block_sum(tallied, s_buf);
  live = block_sum(live, s_buf);
  dead = block_sum(dead, s_buf);
  tallied_energy = block_sum(tallied_energy, s_dbuf);
  if (threadIdx.x == 0) {
    block_dead[blockIdx.x] = dead;
    count(counters, COUNT_TALLIED, tallied);
    if (tallied) atomicAdd(energy_sum, tallied_energy);
    if (live) atomicOr(ctrl + CTRL_LIVE_ACC, 1);
    if (last_block_done(ctrl)) ctrl[CTRL_LIVE] = atomicExch(ctrl + CTRL_LIVE_ACC, 0);
  }
}

extern "C" int tally_launch(const Lanes* lanes, float* image, int32_t* ctrl,
                            unsigned long long* counters, double* energy_sum,
                            int32_t* block_dead, const Params* params, void* stream) {
  if (params->n > 0) {
    const int blocks = (params->n + PHASE_THREADS - 1) / PHASE_THREADS;
    tally_kernel<<<blocks, PHASE_THREADS, 0, (cudaStream_t)stream>>>(
        *lanes, image, ctrl, counters, energy_sum, block_dead, *params);
  }
  return (int)cudaGetLastError();
}
