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
// What bounds it: bytes.  The signal values inside the windows are read
// once, the (U, max_adc) windows of the scanned slots once, the (U,
// max_adc, max_tracks) fractions written once.  Design: the weight depends
// only on m = e - j + 1, so a first kernel tables W[m] = dt * (1 -
// powf(A, m)) for m < n_w once per launch (the FSM's windows need m <=
// n_scan); the second reads it through L1 and computes the expression
// itself only for ticks with m past the table, so every weight has the
// bits it would have per tick.  A block owns one pixel u and walks u's run
// of the CSR of ops/accumulate.pixel_csr ((entry, start tick) pairs,
// shared with the waveform sum): it stages u's scanned windows in shared
// memory with one coalesced load and leaves, writing zeros, when none
// latched or u has no entry.  It then stages kChunk of u's pairs at a time
// with each entry's track slot, and its warps take the staged entries in
// turn, so a pixel with many entries (up to max_tracks and past it) is
// summed by all of them.  For an entry with a slot, the windows that meet
// its row are found by a ballot and taken in ascending order; each lane
// sums a strided run of the ticks inside the window (coalesced), kUnroll
// loads in flight and the adds in tick order, then a fixed tree of
// shuffles.  A pixel's windows are disjoint, so each row value is read
// once.  Every (pixel, slot) gets one entry per ADC slot (ops/accumulate.
// track_pixel_map), so lane 0 writes num[a, k] into the block's
// shared-memory table once; the block then normalises each slot over k in
// ascending order and writes u's (max_adc, max_tracks) block once, zeros
// included, coalesced: no memset, no second pass over the output.  8
// warps timed fastest on an H100 among 4-16, 4 loads in flight about as
// fast as 8 and ahead of 1 or 2, and blocks of 2-8 pixels slower than
// one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = kThreads;
constexpr int kTableThreads = 256;
// a lane's ticks loaded ahead of their adds in a window sum
constexpr int kUnroll = 4;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ __forceinline__ size_t table_floats(int n_scan,
                                                        int max_tracks) {
  // windows (int2), totals, num
  return static_cast<size_t>(n_scan) * (3 + max_tracks);
}

__device__ __forceinline__ float weight(float A, float dt, int m) {
  return __fmul_rn(dt, __fsub_rn(1.0f, powf(A, static_cast<float>(m))));
}

__global__ void __launch_bounds__(kTableThreads) weight_table_kernel(
    const float* __restrict__ A_ptr, float dt, float* __restrict__ W,
    int n_w) {
  const int m = blockIdx.x * kTableThreads + threadIdx.x;
  if (m < n_w) W[m] = weight(__ldg(A_ptr), dt, m);
}

// The weighted sum of row[t] over t in [t_lo, t_hi] with the window's
// end e (m = e - st - t + 1): lane l takes ticks t_lo + l + 32 i in
// ascending i, one add each, then the shuffle tree; lane 0's result.
__device__ __forceinline__ float window_sum(
    const float* __restrict__ row, const float* __restrict__ W, int n_w,
    float A, float dt, int st, int e, int t_lo, int t_hi, int lane) {
  float part = 0.0f;
  int t = t_lo + lane;
  // ticks whose m is past the table: only windows longer than it
  const int t_tab = max(t_lo, e - st + 2 - n_w);
  for (; t < t_tab && t <= t_hi; t += 32)
    part = __fadd_rn(part, __fmul_rn(__ldg(row + t),
                                     weight(A, dt, e - st - t + 1)));
  // kUnroll of a lane's ticks loaded (those inside the window) before
  // their adds, which run in tick order
  for (; t <= t_hi; t += 32 * kUnroll) {
    float v[kUnroll], w[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const int tq = t + 32 * q;
      v[q] = tq <= t_hi ? __ldg(row + tq) : 0.0f;
      w[q] = tq <= t_hi ? __ldg(W + (e - st - tq + 1)) : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q)
      if (t + 32 * q <= t_hi) part = __fadd_rn(part, __fmul_rn(v[q], w[q]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    part = __fadd_rn(part, __shfl_down_sync(kFull, part, off));
  return part;
}

__global__ void __launch_bounds__(kThreads) fractions_kernel(
    const float* __restrict__ signals, const int2* __restrict__ pairs,
    const int* __restrict__ offsets, const int* __restrict__ slot,
    const int* __restrict__ reset_start, const int* __restrict__ latch_end,
    const float* __restrict__ W, int n_w, const float* __restrict__ A_ptr,
    float dt, float* __restrict__ out, int T, int max_adc, int max_tracks,
    int n_scan) {
  extern __shared__ float smem[];
  __shared__ int2 c_pair[kChunk];
  __shared__ int c_slot[kChunk];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int u = blockIdx.x;
  int2* win = reinterpret_cast<int2*>(smem);
  float* total = smem + 2 * n_scan;
  float* num = total + n_scan;
  const int n_out = max_adc * max_tracks;
  float* o = out + static_cast<int64_t>(u) * n_out;

  int latched = 0;
  for (int a = tid; a < n_scan; a += kThreads) {
    const int64_t w = static_cast<int64_t>(u) * max_adc + a;
    const int2 rw = make_int2(__ldg(reset_start + w), __ldg(latch_end + w));
    win[a] = rw;
    latched |= rw.y >= 0;
  }
  const int lo = __ldg(offsets + u), hi = __ldg(offsets + u + 1);
  if (!__syncthreads_or(latched) || lo == hi) {
    for (int f = tid; f < n_out; f += kThreads) o[f] = 0.0f;
    return;
  }
  for (int f = tid; f < n_scan * max_tracks; f += kThreads) num[f] = 0.0f;

  const float A = __ldg(A_ptr);
  for (int c = lo; c < hi; c += kChunk) {
    __syncthreads();
    {
      int2 pr = make_int2(0, 0);
      int k = -1;
      if (c + tid < hi) {
        pr = __ldg(pairs + c + tid);
        k = __ldg(slot + pr.x);
      }
      c_pair[tid] = pr;
      c_slot[tid] = k;
    }
    __syncthreads();
    const int n_c = min(kChunk, hi - c);
    for (int j = warp; j < n_c; j += kWarps) {
      const int k = c_slot[j];
      if (k < 0) continue;
      const int2 pr = c_pair[j];
      const int st = pr.y;
      const float* row = signals + static_cast<int64_t>(pr.x) * T;
      for (int a0 = 0; a0 < n_scan; a0 += 32) {
        bool meets = false;
        if (a0 + lane < n_scan) {
          const int2 rw = win[a0 + lane];
          // ticks t of the row with r <= st + t <= e
          meets = rw.y >= 0 && max(rw.x - st, 0) <= min(rw.y - st, T - 1);
        }
        unsigned slots = __ballot_sync(kFull, meets);
        while (slots) {
          const int b = __ffs(slots) - 1;
          slots &= slots - 1;
          const int2 rw = win[a0 + b];
          const float part = window_sum(
              row, W, n_w, A, dt, st, rw.y, max(rw.x - st, 0),
              min(rw.y - st, T - 1), lane);
          if (lane == 0) num[(a0 + b) * max_tracks + k] = part;
        }
      }
    }
  }
  __syncthreads();
  for (int a = tid; a < n_scan; a += kThreads) {
    float s = 0.0f;
    for (int q = 0; q < max_tracks; ++q)
      s = __fadd_rn(s, num[a * max_tracks + q]);
    total[a] = s;
  }
  __syncthreads();
  for (int f = tid; f < n_out; f += kThreads) {
    const int a = f / max_tracks;
    float v = 0.0f;
    if (a < n_scan) {
      const float s = total[a];
      if (s > 0.0f) v = __fdiv_rn(num[f], s);
    }
    o[f] = v;
  }
}

}  // namespace

extern "C" int current_fractions_launch(
    const float* signals, const int* pairs, const int* offsets,
    const int* slot, const int* reset_start, const int* latch_end,
    const float* A, float dt, float* W, float* out, int n_w, int U, int T,
    int max_adc, int max_tracks, int n_scan, cudaStream_t stream) {
  if (n_w > 0) {
    weight_table_kernel<<<(n_w + kTableThreads - 1) / kTableThreads,
                          kTableThreads, 0, stream>>>(A, dt, W, n_w);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t smem = sizeof(float) * table_floats(n_scan, max_tracks);
  // beside the 3 KB of the staged chunk, past the 48 KB a block gets
  // without asking
  if (smem > 40 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fractions_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fractions_kernel<<<U, kThreads, smem, stream>>>(
      signals, reinterpret_cast<const int2*>(pairs), offsets, slot,
      reset_start, latch_end, W, n_w, A, dt, out, T, max_adc, max_tracks,
      n_scan);
  return static_cast<int>(cudaGetLastError());
}
