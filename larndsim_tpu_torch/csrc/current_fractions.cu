// Per-(pixel, ADC, track slot) current fractions on NVIDIA Hopper (sm_90a).
//
// Replaces larndsim_tpu/ops/fee.py:228, current_fractions, which is not a
// pallas_call but XLA ops shaped for the TPU: a lax.scan over the ADC slots
// whose body evaluates every tick of every (segment, pixel) entry against
// the slot's window and scatter-adds the sums.  The weight of current I(j)
// in an ADC with accumulation window [r, e] is dt * (1 - A^(e - j + 1));
// num[u, a, k] is the weighted sum over the ticks of the entry in track
// slot k of pixel u, and the fractions are num / sum_k num (0 where that
// sum is not positive), as ops/fee.current_fractions_plain computes them.
// The sums are taken in another order than the plain version's (whose
// order on the card is the reduction's own) and powf is not torch.pow, so
// the two agree at rtol 1e-5 / atol 1e-6, the JAX package's tolerance for
// this op; the order here is fixed, so two launches give the same bits.
//
// What bounds it: bytes.  The (S, P, T) signals are read once, the
// (U, max_adc) windows of the scanned slots once, the (U, max_adc,
// max_tracks) fractions written once.  Design: one warp per (segment,
// pixel) entry; padding and entries without a track slot leave at once.
// For each scanned slot a the warp reads r = reset_start[u, a] and
// e = latch_end[u, a], skips the slot when e < 0, and sums only the ticks
// of the entry's row inside [r, e] (st = round(track_start / dt), not
// clamped): each lane a strided run of them (coalesced), then a fixed tree
// of shuffles.  Every (pixel, slot) gets one entry per ADC slot
// (ops/accumulate.track_pixel_map), so lane 0 writes num[u, a, k] once and
// no atomics are needed; the row is read again per slot from L1 / L2, not
// from device memory, and the (S, P, T) temporaries of the plain version's
// per-slot pass are gone.  A second kernel normalises each (u, a) row of
// the scanned slots, summing k in ascending order.  num starts as zeros
// (cudaMemsetAsync on the same stream).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kNormThreads = 256;

__global__ void __launch_bounds__(kWarps * 32) fraction_sums_kernel(
    const float* __restrict__ signals, const int* __restrict__ pix_idx,
    const int* __restrict__ slot, const int* __restrict__ start,
    const int* __restrict__ reset_start, const int* __restrict__ latch_end,
    const float* __restrict__ A_ptr, float dt, float* __restrict__ num,
    int64_t n_entries, int P, int T, int max_adc, int max_tracks,
    int n_scan) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kWarps
                    + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (i >= n_entries) return;
  const int u = __ldg(pix_idx + i);
  const int k = __ldg(slot + i);
  if (u < 0 || k < 0) return;
  const int st = __ldg(start + i / P);
  const float A = __ldg(A_ptr);
  const float* row = signals + i * T;
  const int64_t w0 = static_cast<int64_t>(u) * max_adc;
  for (int a = 0; a < n_scan; ++a) {
    const int e = __ldg(latch_end + w0 + a);
    if (e < 0) continue;
    const int r = __ldg(reset_start + w0 + a);
    // ticks t of the row with r <= st + t <= e
    const int t_lo = max(r - st, 0);
    const int t_hi = min(e - st, T - 1);
    if (t_lo > t_hi) continue;
    float part = 0.0f;
    for (int t = t_lo + lane; t <= t_hi; t += 32) {
      const float expo = static_cast<float>(e - (st + t) + 1);
      const float w = __fmul_rn(dt, __fsub_rn(1.0f, powf(A, expo)));
      part = __fadd_rn(part, __fmul_rn(__ldg(row + t), w));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      part = __fadd_rn(part, __shfl_down_sync(0xffffffffu, part, o));
    if (lane == 0) num[(w0 + a) * max_tracks + k] = part;
  }
}

__global__ void __launch_bounds__(kNormThreads) fraction_norm_kernel(
    float* __restrict__ num, int U, int max_adc, int max_tracks,
    int n_scan) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kNormThreads
                    + threadIdx.x;
  if (j >= static_cast<int64_t>(U) * n_scan) return;
  const int64_t u = j / n_scan;
  const int a = static_cast<int>(j % n_scan);
  float* q = num + (u * max_adc + a) * max_tracks;
  float total = 0.0f;
  for (int k = 0; k < max_tracks; ++k) total = __fadd_rn(total, q[k]);
  for (int k = 0; k < max_tracks; ++k)
    q[k] = total > 0.0f ? __fdiv_rn(q[k], total) : 0.0f;
}

}  // namespace

extern "C" int current_fractions_launch(
    const float* signals, const int* pix_idx, const int* slot,
    const int* start, const int* reset_start, const int* latch_end,
    const float* A, float dt, float* num, int S, int P, int T, int U,
    int max_adc, int max_tracks, int n_scan, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(
      num, 0, sizeof(float) * static_cast<size_t>(U) * max_adc * max_tracks,
      stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_entries = static_cast<int64_t>(S) * P;
  const int64_t grid = (n_entries + kWarps - 1) / kWarps;
  if (grid > 0) {
    fraction_sums_kernel<<<static_cast<unsigned>(grid), kWarps * 32, 0,
                           stream>>>(signals, pix_idx, slot, start,
                                     reset_start, latch_end, A, dt, num,
                                     n_entries, P, T, max_adc, max_tracks,
                                     n_scan);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t rows = static_cast<int64_t>(U) * n_scan;
  if (rows == 0) return 0;
  fraction_norm_kernel<<<static_cast<unsigned>(
                             (rows + kNormThreads - 1) / kNormThreads),
                         kNormThreads, 0, stream>>>(num, U, max_adc,
                                                    max_tracks, n_scan);
  return static_cast<int>(cudaGetLastError());
}
