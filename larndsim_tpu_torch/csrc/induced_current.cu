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
// build with -fmad=false so that nothing is contracted into an FMA.
//
// What bounds it: each (segment, pixel, tick) reads nstep response values
// (~400 at production sampling), so the kernel is bound by load traffic
// from the L2 cache: the whole response (45x45x1891 float32, ~15 MB) sits
// in the 50 MB L2, and neighbouring threads read neighbouring ticks of one
// row.  Design: one block per (segment, pixel, 256-tick block), one thread
// per tick, no atomics.  The block computes the row index and shift of 256
// steps at a time into shared memory (one step per thread), then every
// thread walks those steps in ascending order, the order of the JAX step
// loop, so the sum has the same rounding as the plain version.  Blocks
// whose ticks all lie below tick_lo (scale 0) or at/after tick_hi + ntp
// (past every row), and blocks of padding pixels, write zeros and return.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;

__global__ void induced_current_kernel(
    const float* __restrict__ xs, const float* __restrict__ ys,
    const int* __restrict__ shift, const int* __restrict__ phase,
    const float* __restrict__ pxc, const float* __restrict__ pyc,
    const int* __restrict__ nstep, const int* __restrict__ tick_lo,
    const int* __restrict__ tick_hi, const float* __restrict__ scale,
    const float* __restrict__ resp, float* __restrict__ out,
    int P, int n_steps, int t_sig, int ntp, int n_tblk,
    int nx_r, int ny_r, int ratio,
    float inv_bin, float lim_x, float lim_y, float max_x, float max_y) {
  __shared__ int row_s[kBlock];
  __shared__ int shift_s[kBlock];

  const int64_t b = blockIdx.x;
  const int tb = static_cast<int>(b % n_tblk);
  const int64_t sp = b / n_tblk;
  const int p = static_cast<int>(sp % P);
  const int s = static_cast<int>(sp / P);
  const int t = tb * kBlock + threadIdx.x;
  float* o = out + sp * t_sig;

  const int lo = tick_lo[s];
  const int hi = tick_hi[s] + ntp;
  const float px = pxc[sp];
  const float py = pyc[sp];
  // a padding pixel (centre at the far sentinel) reads only the zero row
  if (tb * kBlock + kBlock <= lo || tb * kBlock >= hi || !(fabsf(px) < 1e8f)) {
    if (t < t_sig) o[t] = 0.0f;
    return;  // uniform across the block
  }

  const int zero_row = nx_r * ny_r * ratio;
  const int ns = nstep[s];
  const float* xs_s = xs + static_cast<int64_t>(s) * n_steps;
  const float* ys_s = ys + static_cast<int64_t>(s) * n_steps;
  const int* sh_s = shift + static_cast<int64_t>(s) * n_steps;
  const int* ph_s = phase + static_cast<int64_t>(s) * n_steps;

  float acc = 0.0f;
  for (int i0 = 0; i0 < ns; i0 += kBlock) {
    const int i = i0 + threadIdx.x;
    if (i < ns) {
      const float x_dist = fminf(fabsf(__fsub_rn(px, xs_s[i])), lim_x);
      const float y_dist = fminf(fabsf(__fsub_rn(py, ys_s[i])), lim_y);
      // jnp.round rounds half to even, as __float2int_rn does
      const int ii = __float2int_rn(__fsub_rn(__fmul_rn(x_dist, inv_bin), 0.5f));
      const int jj = __float2int_rn(__fsub_rn(__fmul_rn(y_dist, inv_bin), 0.5f));
      const bool ok = x_dist <= max_x && y_dist <= max_y && ii >= 0 &&
                      ii < nx_r && jj >= 0 && jj < ny_r;
      row_s[threadIdx.x] = ok ? (ii * ny_r + jj) * ratio + ph_s[i] : zero_row;
      shift_s[threadIdx.x] = sh_s[i];
    }
    __syncthreads();
    const int n = min(kBlock, ns - i0);
    for (int k = 0; k < n; ++k) {
      const int row = row_s[k];
      const int col = t - shift_s[k];
      if (row != zero_row && col >= 0 && col < ntp) {
        acc = __fadd_rn(acc, __ldg(resp + static_cast<int64_t>(row) * ntp + col));
      }
    }
    __syncthreads();
  }
  if (t < t_sig) {
    o[t] = (t >= lo && t < hi)
               ? __fmul_rn(acc, scale[static_cast<int64_t>(s) * t_sig + t])
               : 0.0f;
  }
}

}  // namespace

extern "C" int induced_current_launch(
    const float* xs, const float* ys, const int* shift, const int* phase,
    const float* pxc, const float* pyc, const int* nstep, const int* tick_lo,
    const int* tick_hi, const float* scale, const float* resp, float* out,
    int S, int P, int n_steps, int t_sig, int ntp, int nx_r, int ny_r,
    int ratio, float inv_bin, float lim_x, float lim_y, float max_x,
    float max_y, cudaStream_t stream) {
  const int n_tblk = (t_sig + kBlock - 1) / kBlock;
  const int64_t n_blocks = static_cast<int64_t>(S) * P * n_tblk;
  if (n_blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  induced_current_kernel<<<static_cast<unsigned>(n_blocks), kBlock, 0, stream>>>(
      xs, ys, shift, phase, pxc, pyc, nstep, tick_lo, tick_hi, scale, resp,
      out, P, n_steps, t_sig, ntp, n_tblk, nx_r, ny_r, ratio, inv_bin, lim_x,
      lim_y, max_x, max_y);
  return static_cast<int>(cudaGetLastError());
}
