// LArPix self-trigger FSM per pixel on NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel larndsim_tpu/ops/fee_pallas.py: _fee_kernel,
// called through _fee_pallas_call by fee_fsm_pallas, which is the TPU
// branch of ops/fee.get_adc_values.  Per pixel and tick: leaky IIR
// integrator, discriminator with noise, integrate countdown, latch with a
// second discriminator, reset/skip and busy countdown (reference
// fee.py:517-656).  Every float32 operation keeps the order of the scan
// body in ops/fee.py (step()), rounded on its own (__fmul_rn/__fadd_rn,
// and -fmad=false), so the control flow and every output, integer and
// float, equal the plain version's.
//
// What bounds it: the tick loop is sequential per pixel, and each tick
// reads one signal and five noise values per pixel (24 bytes), so the
// least time is that of streaming (n_scan x 6 x U) floats once from device
// memory.  A loop that loads tick t's values and then runs the FSM's
// data-dependent branches and stores on them waits about one memory round
// trip per tick (the card probes P2/P3 showed it: the same stream without
// the FSM's control flow runs at 93% of the bytes bound).  Design: one
// thread per pixel with the FSM state in registers, and a register ring of
// kAhead ticks: once the FSM body of tick t has read its slot, the slot's
// registers are loaded with tick t + kAhead, unconditionally (a clamped
// row), so that the load writes the ring register itself and nothing waits
// on it for kAhead - 1 ticks.  (A load under a branch, or into a slot whose
// old value the body still reads, lands in a temporary that is moved into
// the ring at once, and that move waits a full round trip every tick.)  At
// tick t a warp reads 32 neighbouring pixels of row t of each stream
// (coalesced).  Blocks of kBlock = 64 pixels spread a small U over more SMs
// (U 2048: 32 blocks).  The block first writes the initial (U, max_adc)
// outputs of its pixels as one contiguous run (coalesced); a latch then
// writes its slot directly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;
// ticks whose loads are in flight ahead of the tick being processed
constexpr int kAhead = 16;

__global__ void __launch_bounds__(kBlock) fee_fsm_kernel(
    const float* __restrict__ sig_rows, const float* __restrict__ noise,
    const float* __restrict__ q_init, const float* __restrict__ thresholds,
    const float* __restrict__ tick_times, float* __restrict__ integrals,
    float* __restrict__ ticks_out, int* __restrict__ n_adc_out,
    int* __restrict__ reset_start, int* __restrict__ latch_end, float A,
    float dt, float C, float sigma_uncorr, float sigma_disc,
    float sigma_reset, float time_padding, int U, int n_scan, int n_times,
    int max_adc, int interval, int reset_ticks, int busy_ticks) {
  // the block's pixels' output rows, neighbouring threads on neighbouring
  // words
  const int u0 = blockIdx.x * kBlock;
  const int64_t lo = static_cast<int64_t>(u0) * max_adc;
  const int64_t hi = static_cast<int64_t>(min(u0 + kBlock, U)) * max_adc;
  for (int64_t k = lo + threadIdx.x; k < hi; k += kBlock) {
    integrals[k] = 0.0f;
    ticks_out[k] = 0.0f;
    reset_start[k] = -1;
    latch_end[k] = -1;
  }
  __syncthreads();

  const int u = u0 + threadIdx.x;
  if (u >= U) return;

  const int64_t base = static_cast<int64_t>(u) * max_adc;
  const float* sig = sig_rows + u;
  const float* nz = noise + u;
  const int64_t U5 = 5LL * U;

  // ring slot d holds the tick t with t % kAhead == d; a load never waits
  // on a branch: past the last tick it rereads the last row
  float r_cur[kAhead], r_q[kAhead], r_disc[kAhead], r_adc[kAhead],
      r_disc2[kAhead], r_reset[kAhead];
  auto load = [&](int d, int t) {
    const int64_t tt = min(t, n_scan - 1);
    const float* z = nz + tt * U5;
    r_cur[d] = __ldg(sig + tt * U);
    r_q[d] = __ldg(z);
    r_disc[d] = __ldg(z + U);
    r_adc[d] = __ldg(z + 2 * U);
    r_disc2[d] = __ldg(z + 3 * U);
    r_reset[d] = __ldg(z + 4 * U);
  };
#pragma unroll
  for (int d = 0; d < kAhead; ++d) load(d, d);

  const float thr = thresholds[u];
  float s_filt = 0.0f;
  float q_sum = q_init[u];
  int busy = 0, integ_rem = 0, skip_rem = 0, iadc = 0, last_reset = 0;

  for (int t0 = 0; t0 < n_scan; t0 += kAhead) {
#pragma unroll
    for (int d = 0; d < kAhead; ++d) {
      const int t = t0 + d;
      if (t >= n_scan) break;
      const float cur = r_cur[d];
      const float n_q = r_q[d];
      const float n_disc = r_disc[d];
      const float n_adc = r_adc[d];
      const float n_disc2 = r_disc2[d];
      const float n_reset = r_reset[d];

      const bool skipping = skip_rem > 0;
      const bool integrating = integ_rem > 0;
      // IIR leaky integrator, frozen while skipping
      s_filt = skipping ? 0.0f : __fadd_rn(__fmul_rn(A, s_filt), cur);
      const float q = skipping ? 0.0f : __fmul_rn(__fmul_rn(s_filt, dt), C);
      q_sum = __fadd_rn(q_sum, q);

      // integration phase
      int ir = (integrating && !skipping) ? integ_rem - 1 : integ_rem;
      const bool latch = integrating && !skipping && ir == 0;
      const float adc = __fadd_rn(q_sum, __fmul_rn(n_adc, sigma_uncorr));
      const bool success =
          latch && adc >= __fadd_rn(thr, __fmul_rn(n_disc2, sigma_disc));
      if (success) {
        const int64_t slot = base + min(iadc, max_adc - 1);
        const int crossing = min(t + 1, n_times - 1);
        const int post = max(t + 1 - (n_times - 1), 0);
        // "+2-tick PACMAN delay" (fee.py:639-643, applied as written)
        integrals[slot] = adc;
        ticks_out[slot] = __fadd_rn(
            __fsub_rn(__fadd_rn(__ldg(tick_times + crossing), time_padding),
                      2.0f),
            static_cast<float>(post));
        reset_start[slot] = last_reset;
        latch_end[slot] = t;
        iadc += 1;
      }

      // idle phase: busy countdown + discriminator
      const bool idle = !skipping && !integrating;
      int b = idle ? max(busy - 1, 0) : busy;
      const bool fire =
          idle && b == 0 && iadc < max_adc &&
          __fadd_rn(q_sum, __fmul_rn(n_q, sigma_uncorr)) >=
              __fadd_rn(thr, __fmul_rn(n_disc, sigma_disc));
      if (fire) ir = interval;

      // reset on latch (success or failure)
      int sr = skip_rem > 0 ? skip_rem - 1 : 0;
      if (latch) {
        sr = reset_ticks;
        last_reset = t + reset_ticks + 1;
        q_sum = __fmul_rn(n_reset, sigma_reset);
        s_filt = 0.0f;
      }
      if (success) b = busy_ticks;
      busy = b;
      integ_rem = ir;
      skip_rem = sr;
      // the slot is free again: bring tick t + kAhead
      load(d, t + kAhead);
    }
  }
  n_adc_out[u] = iadc;
}

}  // namespace

extern "C" int fee_fsm_launch(
    const float* sig_rows, const float* noise, const float* q_init,
    const float* thresholds, const float* tick_times, float* integrals,
    float* ticks_out, int* n_adc, int* reset_start, int* latch_end, float A,
    float dt, float C, float sigma_uncorr, float sigma_disc,
    float sigma_reset, float time_padding, int U, int n_scan, int n_times,
    int max_adc, int interval, int reset_ticks, int busy_ticks,
    cudaStream_t stream) {
  const int grid = (U + kBlock - 1) / kBlock;
  fee_fsm_kernel<<<grid, kBlock, 0, stream>>>(
      sig_rows, noise, q_init, thresholds, tick_times, integrals, ticks_out,
      n_adc, reset_start, latch_end, A, dt, C, sigma_uncorr, sigma_disc,
      sigma_reset, time_padding, U, n_scan, n_times, max_adc, interval,
      reset_ticks, busy_ticks);
  return static_cast<int>(cudaGetLastError());
}
