// Card probe P1 of the induced-current kernel's slab windowing, on NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU probe tools/probe_folded.py: run_case, whose seven
// pallas_calls (:55, :74, :92, :115, :138) bisected a Mosaic fault in the
// folded variant of _current_kernel_folded by moving exactly one window of
// an (8, 32, 128) float32 slab each.  The same data movement here:
//
//   probe_window_kernel      cases a, b, e: out[q, l] = slab[row, q0 + q, l];
//                            row and q0 are kernel arguments, as the JAX
//                            probe passes them through SMEM;
//   probe_roll_kernel        cases c, d: a roll along the middle axis of an
//                            (outer, n, inner) view (pltpu.roll);
//   probe_async_copy_kernel  cases f, g: block b copies the window
//                            slab[:, b*q_step : b*q_step + q_sz, :] into
//                            shared memory with cp.async, 16 bytes a thread
//                            (make_async_copy into a VMEM scratch), waits for
//                            the copies, then stores the window to out[b].
//
// What bounds them: a few kilobytes each, so launch latency; they exist to
// show that each access pattern is exact on the card, not to be fast.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;

__global__ void probe_window_kernel(const float* __restrict__ slab,
                                    float* __restrict__ out, int n_sub,
                                    int lanes, int row, int q0, int n_q) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n_q * lanes) return;
  const int q = k / lanes;
  const int l = k % lanes;
  out[k] = slab[(static_cast<int64_t>(row) * n_sub + q0 + q) * lanes + l];
}

__global__ void probe_roll_kernel(const float* __restrict__ x,
                                  float* __restrict__ out, int outer, int n,
                                  int inner, int shift) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k >= static_cast<int64_t>(outer) * n * inner) return;
  const int64_t o = k / (static_cast<int64_t>(n) * inner);
  const int j = static_cast<int>((k / inner) % n);
  const int i = static_cast<int>(k % inner);
  const int dst = (j + shift) % n;  // 0 <= shift < n
  out[(o * n + dst) * inner + i] = x[k];
}

__global__ void probe_async_copy_kernel(const float* __restrict__ slab,
                                        float* __restrict__ out, int n_sub,
                                        int lanes, int q_step, int q_sz,
                                        int n_vec) {
  extern __shared__ float4 win[];
  const int b = blockIdx.x;
  const int vec_per_row = q_sz * lanes / 4;  // float4s of one slab row's window
  const float4* src = reinterpret_cast<const float4*>(slab);
  for (int v = threadIdx.x; v < n_vec; v += blockDim.x) {
    const int r = v / vec_per_row;
    const int w = v % vec_per_row;
    const float4* g =
        src + (static_cast<int64_t>(r) * n_sub + b * q_step) * lanes / 4 + w;
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(win + v));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(g));
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  float4* o = reinterpret_cast<float4*>(out) + static_cast<int64_t>(b) * n_vec;
  for (int v = threadIdx.x; v < n_vec; v += blockDim.x) o[v] = win[v];
}

}  // namespace

extern "C" int probe_window_launch(const float* slab, float* out, int n_sub,
                                   int lanes, int row, int q0, int n_q,
                                   cudaStream_t stream) {
  const int n = n_q * lanes;
  probe_window_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0, stream>>>(
      slab, out, n_sub, lanes, row, q0, n_q);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_roll_launch(const float* x, float* out, int outer, int n,
                                 int inner, int shift, cudaStream_t stream) {
  const int64_t total = static_cast<int64_t>(outer) * n * inner;
  const int64_t grid = (total + kBlock - 1) / kBlock;
  if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  probe_roll_kernel<<<static_cast<unsigned>(grid), kBlock, 0, stream>>>(
      x, out, outer, n, inner, shift);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_async_copy_launch(const float* slab, float* out,
                                       int n_rows, int n_sub, int lanes,
                                       int q_step, int q_sz, int n_windows,
                                       cudaStream_t stream) {
  const int n_vec = n_rows * q_sz * lanes / 4;
  const size_t smem = static_cast<size_t>(n_vec) * sizeof(float4);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        probe_async_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  probe_async_copy_kernel<<<n_windows, kBlock, smem, stream>>>(
      slab, out, n_sub, lanes, q_step, q_sz, n_vec);
  return static_cast<int>(cudaGetLastError());
}
