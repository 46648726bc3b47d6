// Per-pixel waveform sum on NVIDIA Hopper (sm_90a), written as the FSM's
// tick-major input rows.
//
// Replaces larndsim_tpu/ops/accumulate.py:153, sum_pixel_signals, which is
// not a pallas_call but XLA ops shaped for the TPU: each (segment, pixel)
// row is aligned to global ticks and summed per unique pixel by a one-hot
// matmul on the MXU.  Here: out[g, u] is the sum, from 0.0 and in
// ascending flat (s * P + p) order, of signals[s, p, g - start[s]] over the
// entries of pixel u whose window [start[s], start[s] + T) holds g, for
// 0 <= g < min(n_ticks, n_rows); rows from min(n_ticks, n_rows) up to
// n_rows are zeros.  That is the (n_rows, U) float32 tick-major buffer the
// FSM kernel (csrc/fee_fsm.cu) reads, written directly.  The order is that
// of ops/accumulate.sum_pixel_signals_plain (pass k adds every pixel's
// k-th entry), and each add rounds on its own (__fadd_rn, -fmad=false), so
// the output equals the plain version's (zero-padded, transposed) bit for
// bit.  start is round(track_start / dt), not clamped: the plain version's
// clamp only moves windows that lie wholly outside [0, n_ticks), which add
// nothing either way.
//
// What bounds it: bytes.  The (n_rows, U) output is written once and the
// signal values the adds need are read once; the adds are one per covered
// tick.  Design: the wrapper gives each pixel's entries as a CSR list of
// (entry, start tick) pairs (ops/accumulate.pixel_csr: the plain version's
// stable sort by pixel, each start gathered once per position), made on
// the card with no read to the host.  A block owns kGroup consecutive
// pixels and a tile of kTile ticks; a warp owns one pixel at a time, each
// lane kPerLane ticks of the tile, 32 apart, with a sum in a register
// each.  The warp loads 32 of the pixel's pairs in one coalesced 8-byte
// load a lane, keeps those whose window meets the tile (a ballot), and
// walks them in CSR order, broadcasting each by a shuffle: the loads of a
// row's values do not wait on an index chain.  The tile then goes out
// through shared memory transposed, so each tick row is written as one
// 128-byte run of kGroup consecutive pixels (a block per pixel writing a
// column would store one 4-byte word per 32-byte sector).  A group whose
// pixels have no entry, and a tile past the sums, is written as zeros
// without touching the lists.  Every element is written once: no memset,
// no atomics, the same bits on every run.  8 warps over 128 ticks timed
// fastest on an H100 among 8-32 warps and 128-256 ticks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 32;
constexpr int kWarps = 8;
constexpr int kTile = 128;
constexpr int kPerLane = kTile / 32;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32) pixel_rows_kernel(
    const float* __restrict__ signals, const int2* __restrict__ pairs,
    const int* __restrict__ offsets, float* __restrict__ out, int U, int T,
    int n_ticks, int n_rows) {
  __shared__ float tile[kTile][kGroup + 1];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int u0 = blockIdx.x * kGroup;
  const int g0 = blockIdx.y * kTile;
  const int n_pix = min(kGroup, U - u0);
  const int g_sum = min(n_ticks, n_rows);
  const int g_hi = min(g0 + kTile, g_sum);
  const bool summed = g0 < g_sum
                      && __ldg(offsets + u0) < __ldg(offsets + u0 + n_pix);

  if (summed) {
    for (int p = warp; p < kGroup; p += kWarps) {
      float acc[kPerLane];
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) acc[k] = 0.0f;
      if (p < n_pix) {
        const int lo = __ldg(offsets + u0 + p);
        const int hi = __ldg(offsets + u0 + p + 1);
        for (int c = lo; c < hi; c += 32) {
          int2 pr = make_int2(0, 0);
          bool meets = false;
          if (c + lane < hi) {
            pr = __ldg(pairs + c + lane);
            meets = pr.y < g_hi && static_cast<int64_t>(pr.y) + T > g0;
          }
          unsigned live = __ballot_sync(kFull, meets);
          while (live) {
            const int j = __ffs(live) - 1;
            live &= live - 1;
            const int e = __shfl_sync(kFull, pr.x, j);
            const int st = __shfl_sync(kFull, pr.y, j);
            const float* row = signals + static_cast<int64_t>(e) * T;
#pragma unroll
            for (int k = 0; k < kPerLane; ++k) {
              const int g = g0 + lane + 32 * k;
              const int t = g - st;
              if (g < g_hi && t >= 0 && t < T)
                acc[k] = __fadd_rn(acc[k], __ldg(row + t));
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) tile[lane + 32 * k][p] = acc[k];
    }
    __syncthreads();
  }
  const int r_end = min(kTile, n_rows - g0);
  for (int r = warp; r < r_end; r += kWarps) {
    if (lane < n_pix)
      out[static_cast<int64_t>(g0 + r) * U + u0 + lane] =
          summed ? tile[r][lane] : 0.0f;
  }
}

}  // namespace

extern "C" int pixel_sum_launch(const float* signals, const int* pairs,
                                const int* offsets, float* out, int U, int T,
                                int n_ticks, int n_rows,
                                cudaStream_t stream) {
  const dim3 grid((U + kGroup - 1) / kGroup, (n_rows + kTile - 1) / kTile);
  pixel_rows_kernel<<<grid, kWarps * 32, 0, stream>>>(
      signals, reinterpret_cast<const int2*>(pairs), offsets, out, U, T,
      n_ticks, n_rows);
  return static_cast<int>(cudaGetLastError());
}
