// Card probe P1 of the induced-current kernel's slab windowing, on NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU probe tools/probe_folded.py: run_case, whose seven
// pallas_calls (:55, :74, :92, :115, :138) bisected a Mosaic fault in the
// folded variant of _current_kernel_folded by moving exactly one window of
// an (8, 32, 128) float32 slab each.  The same data movement here:
//
//   probe_window_kernel      cases a, b, e: out[q, l] = slab[row, q0 + q, l],
//                            a block a row; row and q0 are kernel
//                            arguments, as the JAX probe passes them
//                            through SMEM;
//   probe_roll_kernel        cases c, d: a roll along the middle axis of an
//                            (outer, n, inner) view (pltpu.roll);
//   probe_async_copy_kernel  cases f, g: block b copies the window
//                            slab[:, b*q_step : b*q_step + q_sz, :] into
//                            shared memory with one TMA tensor load (the
//                            JAX probe's make_async_copy of the window into
//                            a VMEM scratch: one descriptor, one semaphore),
//                            waits on the load's mbarrier, then stores the
//                            window to out[b] with coalesced 16-byte stores.
//
// The TMA load is a 3-D box (lanes, q_sz, n_rows) at (0, b*q_step, 0) of a
// CUtensorMap over the (n_rows, n_sub, lanes) slab, whose row and sub-row
// strides may be any multiples of 16 bytes (a strided view moves as it
// is).  The launch encodes the map with cuTensorMapEncodeTiled, found
// through the runtime's entry-point query, so nothing links libcuda; a map
// that cuTensorMapEncodeTiled refuses is returned as -CUresult and raised
// by the wrapper, with no other copy path.
//
// What bounds them: a few kilobytes to 128 KiB each, so the launch (the
// host's and the card's); they exist to show that each access pattern is
// exact on the card, not to be fast.  The copy's window passes through one
// SM: its stores, not the TMA load, take most of a 64 KiB window's time.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
// slack for aligning the TMA destination to 128 bytes, then the mbarrier
constexpr int kTmaAlign = 128;
constexpr int kSmemExtra = kTmaAlign + 8;

// Block q copies window row q, a thread a lane (the shape that measured
// fastest of those tried: no index division, the rows' loads on n_q SMs).
__global__ void probe_window_kernel(const float* __restrict__ slab,
                                    float* __restrict__ out, int n_sub,
                                    int lanes, int row, int q0) {
  const int q = blockIdx.x;
  const float* src = slab + (static_cast<int64_t>(row) * n_sub + q0 + q) * lanes;
  for (int l = threadIdx.x; l < lanes; l += blockDim.x)
    out[static_cast<int64_t>(q) * lanes + l] = __ldg(src + l);
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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Spin until the mbarrier at `bar` has completed the phase of parity `phase`.
__device__ __forceinline__ void wait_phase(unsigned bar, unsigned phase) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(phase)
        : "memory");
  }
}

// n_vec: float4s of one window (n_rows * q_sz * lanes / 4).
__global__ void __launch_bounds__(kBlock) probe_async_copy_kernel(
    const __grid_constant__ CUtensorMap slab_map, float* __restrict__ out,
    int q_step, int n_vec) {
  extern __shared__ unsigned char smem_raw[];
  const unsigned raw = smem_addr(smem_raw);
  const unsigned pad = ((raw + kTmaAlign - 1) & ~(kTmaAlign - 1u)) - raw;
  float4* win = reinterpret_cast<float4*>(smem_raw + pad);
  const unsigned win_s = raw + pad;
  const unsigned bar_s = win_s + static_cast<unsigned>(n_vec) * 16u;
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_s)
                 : "memory");
    // the initialised barrier visible to the async proxy (the TMA unit)
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar_s),
        "r"(static_cast<unsigned>(n_vec) * 16u)
        : "memory");
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(win_s),
        "l"(reinterpret_cast<uint64_t>(&slab_map)), "r"(bar_s), "r"(0),
        "r"(static_cast<int>(blockIdx.x) * q_step), "r"(0)
        : "memory");
  }
  // no thread reads the barrier before thread 0 has initialised it
  __syncthreads();
  wait_phase(bar_s, 0);
  float4* o = reinterpret_cast<float4*>(out) + static_cast<int64_t>(blockIdx.x) * n_vec;
  for (int v = threadIdx.x; v < n_vec; v += blockDim.x) o[v] = win[v];
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, or null with the runtime's error.
EncodeTiled encode_tiled(cudaError_t* err) {
  static cudaError_t status = cudaSuccess;
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    status = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                              12000, cudaEnableDefault, &found);
#else
    status = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                     cudaEnableDefault, &found);
#endif
    if (status == cudaSuccess && found != cudaDriverEntryPointSuccess)
      status = cudaErrorSymbolNotFound;
    return status == cudaSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  *err = status;
  return fn;
}

}  // namespace

extern "C" int probe_window_launch(const float* slab, float* out, int n_sub,
                                   int lanes, int row, int q0, int n_q,
                                   cudaStream_t stream) {
  const int threads = lanes < 1024 ? lanes : 1024;
  probe_window_kernel<<<n_q, threads, 0, stream>>>(slab, out, n_sub, lanes,
                                                   row, q0);
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

// row_stride, sub_stride: the slab's strides in floats (its lanes are
// contiguous).  Returns a cudaError_t, or -CUresult where
// cuTensorMapEncodeTiled refuses the tensor map.
extern "C" int probe_async_copy_launch(const float* slab, float* out,
                                       int n_rows, int n_sub, int lanes,
                                       long long row_stride,
                                       long long sub_stride, int q_step,
                                       int q_sz, int n_windows,
                                       cudaStream_t stream) {
  cudaError_t e;
  const EncodeTiled encode = encode_tiled(&e);
  if (encode == nullptr) return static_cast<int>(e);
  CUtensorMap map;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(lanes),
                              static_cast<cuuint64_t>(n_sub),
                              static_cast<cuuint64_t>(n_rows)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(sub_stride) * 4,
                                 static_cast<cuuint64_t>(row_stride) * 4};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(lanes),
                             static_cast<cuuint32_t>(q_sz),
                             static_cast<cuuint32_t>(n_rows)};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      &map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(slab), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  const int n_vec = n_rows * q_sz * lanes / 4;
  const size_t smem = static_cast<size_t>(n_vec) * sizeof(float4) + kSmemExtra;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(probe_async_copy_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  probe_async_copy_kernel<<<n_windows, kBlock, smem, stream>>>(map, out,
                                                               q_step, n_vec);
  return static_cast<int>(cudaGetLastError());
}
