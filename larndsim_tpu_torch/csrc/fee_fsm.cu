// LArPix self-trigger FSM per pixel on NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel larndsim_tpu/ops/fee_pallas.py: _fee_kernel,
// called through _fee_pallas_call by fee_fsm_pallas, which is the TPU
// branch of ops/fee.get_adc_values.  Per pixel and tick: leaky IIR
// integrator, discriminator with noise, integrate countdown, latch with a
// second discriminator, reset/skip and busy countdown (reference
// fee.py:517-656).  Every float32 operation keeps the order of the scan
// body in ops/fee.py (step()), rounded on its own (__fmul_rn/__fadd_rn,
// and -fmad=false), so the control flow and every integer output equal
// the scan's.
//
// What bounds it: the tick loop is sequential per pixel; each tick reads
// one signal and five noise values per pixel (24 bytes), so the kernel
// streams (n_scan x 6 x U) floats once from device memory.  Design: one
// thread per pixel with the FSM state in registers; at tick t a warp reads
// 32 neighbouring pixels of row t of each stream (coalesced); tick_times
// is staged in shared memory; a latch writes its slot of the (U, max_adc)
// outputs directly.  At U ~ 16k there are only ~64 blocks of 256 threads
// for 132 SMs, so latency rather than bandwidth limits it at that size.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;

__global__ void fee_fsm_kernel(
    const float* __restrict__ sig_rows, const float* __restrict__ noise,
    const float* __restrict__ q_init, const float* __restrict__ thresholds,
    const float* __restrict__ tick_times, float* __restrict__ integrals,
    float* __restrict__ ticks_out, int* __restrict__ n_adc_out,
    int* __restrict__ reset_start, int* __restrict__ latch_end, float A,
    float dt, float C, float sigma_uncorr, float sigma_disc,
    float sigma_reset, float time_padding, int U, int n_scan, int n_times,
    int max_adc, int interval, int reset_ticks, int busy_ticks) {
  extern __shared__ float times_s[];
  for (int k = threadIdx.x; k < n_times; k += blockDim.x) times_s[k] = tick_times[k];
  __syncthreads();

  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= U) return;

  const int64_t base = static_cast<int64_t>(u) * max_adc;
  for (int a = 0; a < max_adc; ++a) {
    integrals[base + a] = 0.0f;
    ticks_out[base + a] = 0.0f;
    reset_start[base + a] = -1;
    latch_end[base + a] = -1;
  }

  const float thr = thresholds[u];
  float s_filt = 0.0f;
  float q_sum = q_init[u];
  int busy = 0, integ_rem = 0, skip_rem = 0, iadc = 0, last_reset = 0;

  for (int t = 0; t < n_scan; ++t) {
    const float cur = sig_rows[static_cast<int64_t>(t) * U + u];
    const float* nz = noise + static_cast<int64_t>(t) * 5 * U + u;
    const float n_q = nz[0];
    const float n_disc = nz[U];
    const float n_adc = nz[2 * U];
    const float n_disc2 = nz[3 * U];
    const float n_reset = nz[4 * U];

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
          __fsub_rn(__fadd_rn(times_s[crossing], time_padding), 2.0f),
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
  const size_t smem = static_cast<size_t>(n_times) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fee_fsm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = (U + kBlock - 1) / kBlock;
  fee_fsm_kernel<<<grid, kBlock, smem, stream>>>(
      sig_rows, noise, q_init, thresholds, tick_times, integrals, ticks_out,
      n_adc, reset_start, latch_end, A, dt, C, sigma_uncorr, sigma_disc,
      sigma_reset, time_padding, U, n_scan, n_times, max_adc, interval,
      reset_ticks, busy_ticks);
  return static_cast<int>(cudaGetLastError());
}
