// Per-pixel waveform sum on NVIDIA Hopper (sm_90a).
//
// Replaces larndsim_tpu/ops/accumulate.py:153, sum_pixel_signals, which is
// not a pallas_call but XLA ops shaped for the TPU: each (segment, pixel)
// row is aligned to global ticks and summed per unique pixel by a one-hot
// matmul on the MXU.  Here: wave[u, g] is the sum, from 0.0 and in
// ascending flat (s * P + p) order, of signals[s, p, g - start[s]] over the
// entries of pixel u whose window [start[s], start[s] + T) holds g, for
// 0 <= g < n_ticks.  The order is that of ops/accumulate.
// sum_pixel_signals_plain (pass k adds every pixel's k-th entry), and each
// add rounds on its own (__fadd_rn, -fmad=false), so the output equals the
// plain version's bit for bit.
//
// What bounds it: bytes.  The (S, P, T) signals are read about once and the
// (U, n_ticks) waveforms written once; the adds are one per covered tick.
// Design: the wrapper gives each pixel's entries as a CSR list (the plain
// version's stable sort by pixel, and offsets from a search of its keys),
// so nothing is read back to the host and nothing is scattered.  A block
// owns one pixel and a tile of kTile ticks; each thread owns kPerThread
// ticks of it, kThreads apart, with a sum in a register each.  The block
// walks the pixel's entries in CSR order; an entry whose window misses the
// tile is skipped by the whole block, and otherwise each thread adds the
// row's values at its ticks, neighbouring threads on neighbouring words
// (coalesced).  Every output element of every u < U is written once,
// zeros included: no memset, no atomics, the same bits on every run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;

__global__ void __launch_bounds__(kThreads) pixel_sum_kernel(
    const float* __restrict__ signals, const int64_t* __restrict__ entries,
    const int* __restrict__ offsets, const int* __restrict__ start,
    float* __restrict__ out, int P, int T, int n_ticks) {
  const int u = blockIdx.x;
  const int g0 = blockIdx.y * kTile;
  const int g_end = min(g0 + kTile, n_ticks);
  float acc[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) acc[k] = 0.0f;

  const int lo = __ldg(offsets + u), hi = __ldg(offsets + u + 1);
  for (int i = lo; i < hi; ++i) {
    const int64_t e = __ldg(entries + i);
    const int st = __ldg(start + e / P);
    if (st >= g_end || st + T <= g0) continue;
    const float* row = signals + e * T;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int g = g0 + threadIdx.x + k * kThreads;
      if (g < g_end && g >= st && g < st + T)
        acc[k] = __fadd_rn(acc[k], __ldg(row + (g - st)));
    }
  }
  float* o = out + static_cast<int64_t>(u) * n_ticks;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int g = g0 + threadIdx.x + k * kThreads;
    if (g < g_end) o[g] = acc[k];
  }
}

}  // namespace

extern "C" int pixel_sum_launch(const float* signals, const int64_t* entries,
                                const int* offsets, const int* start,
                                float* out, int U, int P, int T, int n_ticks,
                                cudaStream_t stream) {
  const dim3 grid(U, (n_ticks + kTile - 1) / kTile);
  pixel_sum_kernel<<<grid, kThreads, 0, stream>>>(signals, entries, offsets,
                                                  start, out, P, T, n_ticks);
  return static_cast<int>(cudaGetLastError());
}
