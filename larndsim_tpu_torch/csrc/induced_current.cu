// Induced current per (segment, pixel, tick) on NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel larndsim_tpu/ops/current_pallas.py:
// _current_kernel_folded (production) and _current_kernel (the `rows`
// variant), built by _kernel_fn and called by current_pallas.  It computes
//
//   out[s, p, t] = scale[s, t] * sum_{i < nstep[s]} R[row(s, p, i), t - shift[s, i]]
//
// R is the phase-split response (n_rows = nx*ny*ratio + 1 rows of ntp
// ticks, the last row all zero); reads outside [0, ntp) contribute 0.
// row() is the LUT bin of |pixel centre - sample point| (zero row when out
// of range), with the float32 operations of _row_table in their order;
// build with -fmad=false so that nothing is contracted into an FMA.  The
// sum runs over the steps in ascending order, the order of the JAX step
// loop and of the plain version, so every output is bit-identical to it.
//
// What bounds it: one float32 add per (live step, pixel, covered tick),
// 15.5 G at production shapes (S 4096, P 32, 512 steps, 2048 ticks), each
// fed by one response value.  A design that reads each value from the L2
// cache with a gathered load moves ~62 GB through L2 and spends most of its
// instructions on per-tick index arithmetic.  Only a third of the pairs are
// real pixels (the rest pad the neighbour bucket); a real pair touches ~42
// distinct response rows and its shifts span ~20 ticks, so the columns that
// one tick tile needs fit in shared memory.  Design:
//   * one block per (segment, pixel) pair; a padding pixel writes zeros with
//     16-byte stores and exits; ticks outside [tick_lo, tick_hi + ntp) are
//     zeros;
//   * per chunk of kChunk steps, at once: every step's x, y, shift and phase
//     loaded together, its row computed once, the live steps (not the zero
//     row) compacted in step order (ballots and one table of counts), each
//     distinct row given a slot (a bitmap over the rows, then a prefix
//     popcount), and the byte offset (slot, shift) of each step tabled;
//   * per tick tile of kThreads x R ticks: each slot's window of columns
//     [t0 - max shift, t0 + tile - min shift) copied into shared memory by
//     4-byte cp.async (zero-filled outside [0, ntp), so no per-tick compare
//     remains); one buffer per block, and four blocks on an SM, so that the
//     other blocks' step loops overlap a block's copy (two buffers per
//     block halve the tile or the blocks on an SM, and measured slower);
//   * the step loop reads the offsets 8 at a time (two 16-byte loads) and
//     adds one conflict-free shared value per output tick: R ticks per
//     thread, lanes on consecutive ticks;
//   * R (at most kMaxTicks) shrinks until the windows fit; a chunk whose
//     windows do not fit at R = 1 (too many distinct rows) is tabled again
//     with half as many steps, and the pair's later chunks keep that size;
//   * chunk after chunk, in step order, the partial sums go through the
//     output (a float32 store and load is exact).
// Given a stats buffer of 7 ints (zeroed by the caller; null: not kept),
// the launch also counts its tile choice: the pairs with live steps and,
// over their chunks, those run at R 2 and at R 1 and the halvings (sums);
// the most distinct rows (slots) and the widest shift span that a chunk
// tabled, and the window floats (maxima).
// The floor is then shared-memory bandwidth, one 4-byte load per add
// (~2.1 ms on an H100 at production shapes).  Measured there (PERF.md),
// the adds take ~2.6 ms, the window copies (~16 GB from L2) add ~1.5 ms
// that the other blocks do not hide, and the per-pair set-up ~0.6 ms.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// steps whose rows and slots are tabled at once
constexpr int kChunk = 512;
constexpr int kRounds = kChunk / kThreads;
// ticks per thread at most (the tile is kThreads x R ticks)
// (4 or 8 measured no faster: most real pairs fit only R = 2 or 1)
constexpr int kMaxTicks = 2;
// dynamic shared memory per block: four blocks on an SM
constexpr int kSmemBytes = 56 * 1024;

// Shared-memory layout: crow, csh, qoff, slot_row (kChunk ints each),
// bitmap and its prefix (nwords each), kRounds x kWarps rank counts and 4
// ints of scratch, then the windows, 16-byte aligned.
__host__ __device__ constexpr int window_offset(int nwords) {
  return (4 * kChunk * 4 + 2 * nwords * 4 + (kRounds * kWarps + 4) * 4 +
          15) & ~15;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4-byte asynchronous copy; src_size 0 writes a zero
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ void fill_zero(float* o, int a, int b) {
  for (int t = a + threadIdx.x; t < b; t += kThreads) o[t] = 0.0f;
}

// One step of R ticks: the thread's ticks read the window at byte offset
// q from its own first tick.
template <int R>
__device__ __forceinline__ void add_step(float (&acc)[R], const char* wb,
                                         int q) {
  const float* w = reinterpret_cast<const float*>(wb + q);
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = __fadd_rn(acc[r], w[r * kThreads]);
}

// The chunk's sum over tiles of kThreads x R ticks from [ta, tb), each
// slot's window of W = kThreads * R + span columns staged in shared memory.
// qoff[j] = 4 * (slot * W + hi - shift) for live step j, so that tick
// t0 + k of the tile reads float k + qoff / 4 of the buffer.
template <int R>
__device__ void staged_tiles(const float* __restrict__ resp,
                             const int* slot_row, const int* qoff, float* win,
                             int n_slots, int n_live, int W, int hi, int ntp,
                             int ta, int tb, float* o,
                             const float* __restrict__ sc, bool first,
                             bool last) {
  constexpr int kTile = kThreads * R;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_tiles = (tb - ta + kTile - 1) / kTile;

  for (int k = 0; k < n_tiles; ++k) {
    // slot sl's window of columns [col0, col0 + W) at float sl * W
    const int col0 = ta + k * kTile - hi;
    for (int sl = warp; sl < n_slots; sl += kWarps) {
      const float* src = resp + static_cast<int64_t>(slot_row[sl]) * ntp;
      float* d = win + sl * W;
      for (int c = lane; c < W; c += 32) {
        const int col = col0 + c;
        const bool in = static_cast<unsigned>(col) < static_cast<unsigned>(ntp);
        cp_async4(d + c, in ? src + col : src, in);
      }
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    const char* wb = reinterpret_cast<const char*>(win + threadIdx.x);
    const int t0 = ta + k * kTile + threadIdx.x;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = t0 + r * kThreads;
      acc[r] = (first || t >= tb) ? 0.0f : o[t];
    }
    const int4* q4 = reinterpret_cast<const int4*>(qoff);
    int j = 0;
    for (; j + 8 <= n_live; j += 8) {
      const int4 u = q4[j >> 2];
      const int4 v = q4[(j >> 2) + 1];
      add_step<R>(acc, wb, u.x);
      add_step<R>(acc, wb, u.y);
      add_step<R>(acc, wb, u.z);
      add_step<R>(acc, wb, u.w);
      add_step<R>(acc, wb, v.x);
      add_step<R>(acc, wb, v.y);
      add_step<R>(acc, wb, v.z);
      add_step<R>(acc, wb, v.w);
    }
    for (; j < n_live; ++j) add_step<R>(acc, wb, qoff[j]);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = t0 + r * kThreads;
      if (t < tb) o[t] = last ? __fmul_rn(acc[r], sc[t]) : acc[r];
    }
    __syncthreads();  // the windows are staged again for tile k + 1
  }
}

__global__ void __launch_bounds__(kThreads) induced_current_kernel(
    const float* __restrict__ xs, const float* __restrict__ ys,
    const int* __restrict__ shift, const int* __restrict__ phase,
    const float* __restrict__ pxc, const float* __restrict__ pyc,
    const int* __restrict__ nstep, const int* __restrict__ tick_lo,
    const int* __restrict__ tick_hi, const float* __restrict__ scale,
    const float* __restrict__ resp, float* __restrict__ out, int P,
    int n_steps, int t_sig, int ntp, int nx_r, int ny_r, int ratio,
    float inv_bin, float lim_x, float lim_y, float max_x, float max_y,
    int* __restrict__ stats) {
  const int64_t sp = blockIdx.x;
  const int s = static_cast<int>(sp / P);
  float* o = out + sp * t_sig;
  const float px = pxc[sp];
  const float py = pyc[sp];
  const int ns = max(0, min(nstep[s], n_steps));
  // ticks that can be nonzero: from tick_lo (scale 0 below) to the last
  // shift (tick_hi) + ntp
  const int ta = max(tick_lo[s], 0);
  const int tb = min(tick_hi[s] + ntp, t_sig);
  // a padding pixel (centre at the far sentinel) reads only the zero row
  if (!(fabsf(px) < 1e8f) || ns == 0 || ta >= tb) {  // uniform
    if ((t_sig & 3) == 0) {
      float4* o4 = reinterpret_cast<float4*>(o);
      for (int k = threadIdx.x; k < (t_sig >> 2); k += kThreads)
        o4[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    } else {
      fill_zero(o, 0, t_sig);
    }
    return;
  }
  fill_zero(o, 0, ta);
  fill_zero(o, tb, t_sig);

  extern __shared__ __align__(16) unsigned char smem[];
  const int zero_row = nx_r * ny_r * ratio;
  const int nwords = (zero_row + 1 + 31) >> 5;
  int* crow = reinterpret_cast<int*>(smem);
  int* csh = crow + kChunk;
  int* qoff = csh + kChunk;
  int* slot_row = qoff + kChunk;
  unsigned* bitmap = reinterpret_cast<unsigned*>(slot_row + kChunk);
  int* wpre = reinterpret_cast<int*>(bitmap + nwords);
  int* counts = wpre + nwords;          // [kRounds][kWarps]
  int* red = counts + kRounds * kWarps;  // live shift min, max; slots
  float* win = reinterpret_cast<float*>(smem + window_offset(nwords));
  const int win_floats = (kSmemBytes - window_offset(nwords)) / 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  const int64_t seg = static_cast<int64_t>(s) * n_steps;
  const float* sc = scale + static_cast<int64_t>(s) * t_sig;
  // steps [c0, c0 + nc) at a time: kChunk at first, halved for the rest of
  // the pair while a chunk's windows do not fit even at R = 1 (one step
  // always fits, see the launch)
  int len = kChunk;
  // the pair's tile choice, for the stats buffer (uniform over the block)
  int n_r2 = 0, n_r1 = 0, n_halve = 0, max_slots = 0, max_span = 0;
  bool any_live = false;
  for (int c0 = 0; c0 < ns;) {
    const int nc = min(ns - c0, len);
    // the chunk's steps, all loads in flight at once, and their rows
    float x[kRounds], y[kRounds];
    int sh[kRounds], ph[kRounds], row[kRounds];
#pragma unroll
    for (int k = 0; k < kRounds; ++k) {
      const int i = k * kThreads + threadIdx.x;
      if (i < nc) {
        x[k] = xs[seg + c0 + i];
        y[k] = ys[seg + c0 + i];
        sh[k] = shift[seg + c0 + i];
        ph[k] = phase[seg + c0 + i];
      }
    }
    unsigned live[kRounds];
#pragma unroll
    for (int k = 0; k < kRounds; ++k) {
      row[k] = zero_row;
      if (k * kThreads + threadIdx.x < nc) {
        const float x_dist = fminf(fabsf(__fsub_rn(px, x[k])), lim_x);
        const float y_dist = fminf(fabsf(__fsub_rn(py, y[k])), lim_y);
        // jnp.round rounds half to even, as __float2int_rn does
        const int ii =
            __float2int_rn(__fsub_rn(__fmul_rn(x_dist, inv_bin), 0.5f));
        const int jj =
            __float2int_rn(__fsub_rn(__fmul_rn(y_dist, inv_bin), 0.5f));
        const bool ok = x_dist <= max_x && y_dist <= max_y && ii >= 0 &&
                        ii < nx_r && jj >= 0 && jj < ny_r;
        if (ok) row[k] = (ii * ny_r + jj) * ratio + ph[k];
      }
      live[k] = __ballot_sync(0xffffffffu, row[k] != zero_row);
      if (lane == 0) counts[k * kWarps + warp] = __popc(live[k]);
    }
    for (int w = threadIdx.x; w < nwords; w += kThreads) bitmap[w] = 0u;
    if (threadIdx.x == 0) {
      red[0] = INT_MAX;
      red[1] = INT_MIN;
    }
    __syncthreads();
    // the live steps (row not the zero row) compacted in step order; the
    // bitmap of their rows and the range of their shifts
    int n_live = 0, lo = INT_MAX, hi = INT_MIN;
#pragma unroll
    for (int k = 0; k < kRounds; ++k) {
      int before = n_live;
      for (int w = 0; w < kWarps; ++w) {
        const int cnt = counts[k * kWarps + w];
        before += w < warp ? cnt : 0;
        n_live += cnt;
      }
      if (row[k] != zero_row) {
        const int j = before + __popc(live[k] & ((1u << lane) - 1u));
        crow[j] = row[k];
        csh[j] = sh[k];
        atomicOr(bitmap + (row[k] >> 5), 1u << (row[k] & 31));
        lo = min(lo, sh[k]);
        hi = max(hi, sh[k]);
      }
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if (lane == 0) {
      atomicMin(red, lo);
      atomicMax(red + 1, hi);
    }
    __syncthreads();
    // slot of row r: the set bits before it (exclusive prefix, one warp)
    if (warp == 0) {
      int carry = 0;
      for (int w0 = 0; w0 < nwords; w0 += 32) {
        const int w = w0 + lane;
        const int cnt = w < nwords ? __popc(bitmap[w]) : 0;
        int incl = cnt;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int v = __shfl_up_sync(0xffffffffu, incl, d);
          if (lane >= d) incl += v;
        }
        if (w < nwords) wpre[w] = carry + incl - cnt;
        carry += __shfl_sync(0xffffffffu, incl, 31);
      }
      if (lane == 0) red[2] = carry;
    }
    __syncthreads();
    const int n_slots = red[2];
    const int lo_c = n_live > 0 ? red[0] : 0, hi_c = n_live > 0 ? red[1] : 0;
    any_live = any_live || n_live > 0;
    max_slots = max(max_slots, n_slots);
    max_span = max(max_span, hi_c - lo_c);

    // the widest tile (R ticks per thread) whose windows fit, no wider
    // than the tick range needs
    int R = kMaxTicks;
    while (R > 1 && kThreads * (R >> 1) >= tb - ta) R >>= 1;
    while (R > 0 && static_cast<int64_t>(n_slots) *
                           (kThreads * R + hi_c - lo_c) > win_floats)
      R >>= 1;
    if (R == 0) {  // uniform: the same steps again, half as many
      len = (nc + 1) >> 1;
      ++n_halve;
      __syncthreads();  // the tables are rewritten
      continue;
    }
    const bool first = c0 == 0, last = c0 + nc == ns;
    const int W = kThreads * R + hi_c - lo_c;
    for (int j = threadIdx.x; j < n_live; j += kThreads) {
      const int r = crow[j], w = r >> 5;
      const int slot = wpre[w] + __popc(bitmap[w] & ((1u << (r & 31)) - 1u));
      slot_row[slot] = r;  // steps of one row write the same value
      qoff[j] = 4 * (slot * W + hi_c - csh[j]);
    }
    __syncthreads();
    if (R == 2) {
      ++n_r2;
      staged_tiles<2>(resp, slot_row, qoff, win, n_slots, n_live, W, hi_c,
                      ntp, ta, tb, o, sc, first, last);
    } else {
      ++n_r1;
      staged_tiles<1>(resp, slot_row, qoff, win, n_slots, n_live, W, hi_c,
                      ntp, ta, tb, o, sc, first, last);
    }
    c0 += nc;
    __syncthreads();  // the next chunk rewrites the tables
  }
  if (stats != nullptr && threadIdx.x == 0) {
    atomicMax(stats + 6, win_floats);
    if (any_live) {
      atomicAdd(stats, 1);
      atomicAdd(stats + 1, n_r2);
      atomicAdd(stats + 2, n_r1);
      atomicAdd(stats + 3, n_halve);
      atomicMax(stats + 4, max_slots);
      atomicMax(stats + 5, max_span);
    }
  }
}

}  // namespace

extern "C" int induced_current_launch(
    const float* xs, const float* ys, const int* shift, const int* phase,
    const float* pxc, const float* pyc, const int* nstep, const int* tick_lo,
    const int* tick_hi, const float* scale, const float* resp, float* out,
    int S, int P, int n_steps, int t_sig, int ntp, int nx_r, int ny_r,
    int ratio, float inv_bin, float lim_x, float lim_y, float max_x,
    float max_y, int* stats, cudaStream_t stream) {
  const int64_t n_blocks = static_cast<int64_t>(S) * P;
  const int nwords = (nx_r * ny_r * ratio + 1 + 31) / 32;
  // the windows must hold at least one step's (one slot of kThreads ticks)
  if (n_blocks > 0x7fffffff ||
      window_offset(nwords) + 4 * kThreads > kSmemBytes)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaError_t e = cudaFuncSetAttribute(
      induced_current_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  induced_current_kernel<<<static_cast<unsigned>(n_blocks), kThreads,
                           kSmemBytes, stream>>>(
      xs, ys, shift, phase, pxc, pyc, nstep, tick_lo, tick_hi, scale, resp,
      out, P, n_steps, t_sig, ntp, nx_r, ny_r, ratio, inv_bin, lim_x, lim_y,
      max_x, max_y, stats);
  return static_cast<int>(cudaGetLastError());
}
