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
// record, 8 state words (parked) or 2 (stashed); it writes up to 2 words and
// a flag and does one 4-byte atomic add into the image (a 32-byte sector of
// L2 each): at most ~90 B per lane, 6 MB per launch at 65,536 lanes; with
// the typical third of the lanes holding a record, about 2 MB. The
// arithmetic (one detector-plane intersection for a parked record) is
// negligible.
//
// On the engine's main path this work rides on the flight_resolve launch
// that ends an iteration (flight_resolve.cu, with_tally), which holds the
// lane in registers already; this kernel is the tally as a launch of its
// own, on the stepwise path (transport.run_projection_stepwise) and wherever
// the tally is measured alone. Both share the per-lane body (flight.cuh
// tally_stored_lane, tally_lane) and the epilogue (engine.cuh settle_launch).
//
// Design: one thread per lane; the tally is an atomicAdd per record (the
// image, 22.7 MB at 1848 x 768, stays in L2), as MC-GPU scores. The order
// of the adds differs from run to run, so the image agrees with the plain
// version's index_add_ to rounding, not bit for bit; the integer counters
// are exact. Records and tallied energy (float64) are summed per block and
// added with one atomic each. Each block ORs whether it holds a live lane
// or a waiting record; the block that finishes last writes the live word,
// the iteration number and whether the next iteration is to run (CTRL_RUN,
// which every phase kernel reads at its start). Each block also leaves its
// count of dead lanes for the next refill's ordered tail.

#include "flight.cuh"

__global__ void __launch_bounds__(PHASE_THREADS)
tally_kernel(Lanes L, float* __restrict__ image, int32_t* ctrl,
             unsigned long long* counters, double* energy_sum, int32_t* block_dead,
             const Params* __restrict__ params) {
  __shared__ Params s_params;
  __shared__ int s_ctrl[5], s_buf[32];
  __shared__ double s_dbuf[32];
  stage_struct(&s_params, params);
  const Ctrl ctrl_in = read_ctrl(ctrl, s_ctrl);  // also orders s_params
  if (!ctrl_in.run) return;
  const Params& P = s_params;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int tallied = 0, live = 0, dead = 0;
  double tallied_energy = 0.0;
  if (i < P.n) {
    const bool alive = L.alive[i];
    bool waits;
    float val;
    if (tally_stored_lane(L, i, image, P, val, waits)) {
      tallied = 1;
      tallied_energy = (double)val;
    }
    live = alive || waits;
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
    settle_launch(ctrl, 0, CTRL_LAUNCHES_TALLY, true, live);
  }
}

extern "C" int tally_launch(const Lanes* lanes, int n, float* image, int32_t* ctrl,
                            unsigned long long* counters, double* energy_sum,
                            int32_t* block_dead, const Params* params, void* stream) {
  if (n > 0) {
    const int blocks = (n + PHASE_THREADS - 1) / PHASE_THREADS;
    tally_kernel<<<blocks, PHASE_THREADS, 0, (cudaStream_t)stream>>>(
        *lanes, image, ctrl, counters, energy_sum, block_dead, params);
  }
  return (int)cudaGetLastError();
}
