// Card probes P2 and P3 of the FEE FSM kernel, on NVIDIA Hopper (sm_90a).
//
// P2 replaces tools/probe_fee.py: make_call (pallas_call at :133), a
// non-physical 7-state recurrence shaped like the tick loop of
// ops/fee_pallas.py: _fee_kernel, with ablation variants that take one part
// of the per-tick work away each.  Per pixel and tick t < n_scan (the guard):
//
//   a = 0.99 a + sig[t]
//   b = a > 0.5 ? b + n0 : b        c = a > 0.5 ? c + n1 : c
//   d = b > c ? d + n2 : d          e = d > 0 ? e + n3 : e
//   f = e > 0 ? f + n4 : f          g = f > 1e9 ? 0 : g + 1
//
// with n0..n4 the five noise rows of tick t; the output is the final a.
// Flags (template parameter, names as in make_call's `ablate` string):
// consts (four unused constant inputs, staged as the SMEM/VMEM blocks were),
// outs (four (max_adc, U) output planes set to 0 / -1), noguard (no tick
// guard), nosig / nonoise (state 7 in place of the signal / noise rows),
// nostate (a = sig + n0 + ... + n4, no carried state), intops (the FSM's
// int32 counters and selects), anyred (a block-wide any() over the JAX tile
// of 1024 pixels that bumps state 7 of the whole tile).
//
// P3 replaces tools/probe_fee2.py: make_call (pallas_call at :133, :146),
// the one-state scan s = 0.99 s + sig[t] with K2's structural features
// added one at a time; each Mosaic construct becomes its nearest Hopper
// counterpart:
//
//   prefetch    scalar prefetch -> the 6 scalars and the tick times staged
//               in shared memory at block start;
//   anyio       2 inputs and 5 outputs in ANY space, never touched -> passed
//               as pointers and never touched;
//   vmouts(5)   1 (5) per-chunk VMEM output blocks -> 1 (5) (n_c, max_adc, U)
//               planes, each written at the end of every 256-tick chunk (with
//               the state s: the JAX kernel never stores into them, the
//               pipeline writes them back all the same);
//   bigscratch  a 5.2 MB VMEM scratch -> the largest dynamic shared memory a
//               block may take (227 KB), which leaves one block per SM;
//   tailsplit   the tick guard only in the last chunk.
//
// The JAX P3 never stores its (1, U) output; here it holds the final state,
// so that the loop is kept and the card can hold kernel against plain.  The
// JAX P3 streams its noise block into VMEM every grid step and never reads
// it; here every thread reads its five noise values of every tick through
// inline-asm loads (asm volatile), which the compiler may not drop.  P2's
// unused `consts` inputs are read the same way.
//
// Both are one thread per pixel with the state in registers, as K2
// (fee_fsm.cu) is.  P2 runs on K2's structure, so that each ablation takes
// its part away from the kernel the charge chain ships: blocks of 64
// pixels, and a register ring of kAhead = 16 ticks of (sig, n0..n4) filled
// by unconditional loads of clamped rows (fee_fsm.cu explains why a load
// under a branch waits a round trip a tick); nosig and nonoise drop their
// streams from the ring.  anyred keeps the JAX tile, 1024 pixels a block,
// because its __syncthreads_or over the tile is what it measures; a thread
// of a 1024-thread block has 64 registers, so its ring holds 4 ticks (24
// registers).  P3 keeps 256-thread blocks and loads each tick under its
// guard.  Every float32 operation rounds on its own (__fmul_rn/__fadd_rn,
// -fmad=false), as the plain versions and the JAX probes do, in the order
// of the JAX probes' bodies.  What bounds them: the stream of signal and
// noise rows, (1 + 5) x n_scan x U float32, as for K2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 256;  // ticks per grid step of the JAX probes
constexpr int kBlock = 256;
constexpr int kTile = 1024;  // pixels per grid step of the JAX probes
constexpr int kBigScratch = 227 * 1024;

// P2 flags
constexpr unsigned kConsts = 1, kOuts = 2, kNoGuard = 4, kNoSig = 8,
                   kNoNoise = 16, kNoState = 32, kIntOps = 64, kAnyRed = 128;
// P3 flags
constexpr unsigned kPrefetch = 1, kAnyIO = 2, kVmOuts = 4, kVmOuts5 = 8,
                   kBig = 16, kTailSplit = 32;

// P2's block and register ring: K2's (fee_fsm.cu: kBlock 64, kAhead 16),
// anyred's over the JAX tile
template <unsigned F>
struct RingShape {
  static constexpr int kThreads = (F & kAnyRed) ? kTile : 64;
  static constexpr int kAhead = (F & kAnyRed) ? 4 : 16;
};

// A load that the compiler keeps although its value is unused.
__device__ __forceinline__ float kept_load(const float* p) {
  float v;
  asm volatile("ld.global.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

// A store to shared memory that the compiler keeps although nothing reads it.
__device__ __forceinline__ void kept_store(float* smem, float v) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("st.shared.f32 [%0], %1;" ::"r"(s), "f"(v));
}

// Stage n values of src in shared memory (the JAX SMEM / prefetch blocks).
__device__ __forceinline__ void stage(float* dst, const float* src, int n) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) kept_store(dst + k, kept_load(src + k));
}

template <unsigned F>
__global__ void __launch_bounds__(RingShape<F>::kThreads) probe_fee_kernel(
    const float* __restrict__ scal, const float* __restrict__ times,
    const float* __restrict__ thr, const float* __restrict__ q0,
    const float* __restrict__ sig, const float* __restrict__ noise,
    float* __restrict__ out, float* __restrict__ o1, int* __restrict__ o2,
    float* __restrict__ o3, int* __restrict__ o4, float* __restrict__ fstate,
    int* __restrict__ istate, int U, int n_c, int n_scan, int n_times,
    int max_adc) {
  constexpr int kAhead = RingShape<F>::kAhead;
  constexpr bool kSig = (F & kNoSig) == 0, kNoise = (F & kNoNoise) == 0;
  extern __shared__ float consts_s[];
  const int u = blockIdx.x * blockDim.x + threadIdx.x;  // U % blockDim == 0
  if constexpr ((F & kConsts) != 0) {
    stage(consts_s, scal, 6);
    stage(consts_s + 6, times, n_times);
    __syncthreads();
    kept_load(thr + u);
    kept_load(q0 + u);
  }
  if constexpr ((F & kOuts) != 0) {
    for (int a = 0; a < max_adc; ++a) {
      const int64_t k = static_cast<int64_t>(a) * U + u;
      o1[k] = 0.0f;
      o2[k] = -1;
      o3[k] = 0.0f;
      o4[k] = -1;
    }
  }
  float fs[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  int is[4] = {0, 0, 0, 0};

  // the ticks run: those under the guard, or every padded tick
  const int n_t = (F & kNoGuard) ? n_c * kChunk : min(n_scan, n_c * kChunk);
  const int last = max(n_t - 1, 0);
  const float* sp = sig + u;
  const float* np = noise + u;
  const int64_t U5 = 5LL * U;
  // ring slot d holds tick t with t % kAhead == d (as fee_fsm.cu's ring):
  // a load never waits on a branch; past the last tick it rereads the last
  // row
  float r_sig[kAhead], r_n[5][kAhead];
  auto load = [&](int d, int t) {
    const int64_t tt = min(t, last);
    if constexpr (kSig) r_sig[d] = __ldg(sp + tt * U);
    if constexpr (kNoise) {
#pragma unroll
      for (int j = 0; j < 5; ++j) r_n[j][d] = __ldg(np + tt * U5 + j * U);
    }
  };
  if (n_t > 0) {
#pragma unroll
    for (int d = 0; d < kAhead; ++d) load(d, d);
  }

  for (int t0 = 0; t0 < n_t; t0 += kAhead) {
#pragma unroll
    for (int d = 0; d < kAhead; ++d) {
      const int t = t0 + d;
      if (t >= n_t) break;  // block-uniform, as anyred's barrier needs
      const float cur = kSig ? r_sig[d] : fs[7];
      float r[5];
#pragma unroll
      for (int j = 0; j < 5; ++j) r[j] = kNoise ? r_n[j][d] : fs[7];

      if constexpr ((F & kNoState) != 0) {
        fs[0] = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(cur, r[0]), r[1]), r[2]), r[3]), r[4]);
      } else if constexpr ((F & kIntOps) != 0) {
        const int b0 = is[0], i0 = is[1], s0 = is[2];
        const bool skipping = s0 > 0;
        const bool integrating = i0 > 0;
        int ir = (integrating && !skipping) ? i0 - 1 : i0;
        const bool latch = integrating && !skipping && ir == 0;
        const float a = __fadd_rn(__fmul_rn(fs[0], 0.99f), cur);
        const bool fire = !skipping && !integrating && __fadd_rn(a, r[0]) >= r[1];
        if (fire) ir = 7;
        int sr = s0 > 0 ? s0 - 1 : 0;
        if (latch) sr = 3;
        const int lr = latch ? t + 4 : is[3];
        int busy = (!skipping && !integrating) ? max(b0 - 1, 0) : b0;
        if (latch) busy = 9;
        fs[0] = latch ? 0.0f : a;
        is[0] = busy;
        is[1] = ir;
        is[2] = sr;
        is[3] = lr;
      } else {
        const float a = __fadd_rn(__fmul_rn(fs[0], 0.99f), cur);
        const float b = a > 0.5f ? __fadd_rn(fs[1], r[0]) : fs[1];
        const float cc = a > 0.5f ? __fadd_rn(fs[2], r[1]) : fs[2];
        const float d2 = b > cc ? __fadd_rn(fs[3], r[2]) : fs[3];
        const float e = d2 > 0.0f ? __fadd_rn(fs[4], r[3]) : fs[4];
        const float f = e > 0.0f ? __fadd_rn(fs[5], r[4]) : fs[5];
        const float g = f > 1e9f ? 0.0f : __fadd_rn(fs[6], 1.0f);
        if constexpr ((F & kAnyRed) != 0) {
          // jnp.any over the tile: the block is the tile; t is block-uniform
          if (__syncthreads_or(b > 1e30f)) fs[7] = __fadd_rn(fs[7], 1.0f);
        }
        fs[0] = a;
        fs[1] = b;
        fs[2] = cc;
        fs[3] = d2;
        fs[4] = e;
        fs[5] = f;
        fs[6] = g;
      }
      // the slot is free again: bring tick t + kAhead
      load(d, t + kAhead);
    }
  }
  out[u] = fs[0];
#pragma unroll
  for (int k = 0; k < 8; ++k) fstate[static_cast<int64_t>(k) * U + u] = fs[k];
#pragma unroll
  for (int k = 0; k < 4; ++k) istate[static_cast<int64_t>(k) * U + u] = is[k];
}

__device__ __forceinline__ float scan_chunk(const float* __restrict__ sig,
                                            const float* __restrict__ noise,
                                            float s, int c, int u, int U,
                                            int n_scan_p, int n_scan,
                                            bool guarded) {
  for (int i = 0; i < kChunk; ++i) {
    const int t = c * kChunk + i;
    // the noise block arrives whether or not the tick runs
#pragma unroll
    for (int j = 0; j < 5; ++j)
      kept_load(noise + (static_cast<int64_t>(j) * n_scan_p + t) * U + u);
    if (!guarded || t < n_scan)
      s = __fadd_rn(__fmul_rn(s, 0.99f), sig[static_cast<int64_t>(t) * U + u]);
  }
  return s;
}

template <unsigned F>
__global__ void probe_fee2_kernel(
    const float* __restrict__ scal, const float* __restrict__ times,
    const float* __restrict__ sig, const float* __restrict__ noise,
    float* __restrict__ state, float* __restrict__ planes, int U, int n_c,
    int n_scan, int n_times, int max_adc) {
  extern __shared__ float prefetch_s[];
  const int u = blockIdx.x * blockDim.x + threadIdx.x;  // U % blockDim == 0
  if constexpr ((F & kPrefetch) != 0) {
    stage(prefetch_s, scal, 6);
    stage(prefetch_s + 6, times, n_times);
    __syncthreads();
  }
  constexpr int n_planes = (F & kVmOuts5) ? 5 : 1;
  const int n_scan_p = n_c * kChunk;
  float s = 0.0f;
  for (int c = 0; c < n_c; ++c) {
    const bool guarded = (F & kTailSplit) == 0 || c == n_c - 1;
    s = scan_chunk(sig, noise, s, c, u, U, n_scan_p, n_scan, guarded);
    if constexpr ((F & kVmOuts) != 0) {
      for (int k = 0; k < n_planes; ++k)
        for (int a = 0; a < max_adc; ++a)
          planes[((static_cast<int64_t>(k) * n_c + c) * max_adc + a) * U + u] = s;
    }
  }
  state[u] = s;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <unsigned F>
int launch_fee(const float* scal, const float* times, const float* thr,
               const float* q0, const float* sig, const float* noise,
               float* out, float* o1, int* o2, float* o3, int* o4,
               float* fstate, int* istate, int U, int n_c, int n_scan,
               int n_times, int max_adc, cudaStream_t stream) {
  const int block = RingShape<F>::kThreads;
  const size_t smem = (F & kConsts) ? (6 + static_cast<size_t>(n_times)) * sizeof(float) : 0;
  cudaError_t e = allow_smem(probe_fee_kernel<F>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  probe_fee_kernel<F><<<U / block, block, smem, stream>>>(
      scal, times, thr, q0, sig, noise, out, o1, o2, o3, o4, fstate, istate,
      U, n_c, n_scan, n_times, max_adc);
  return static_cast<int>(cudaGetLastError());
}

template <unsigned F>
int launch_fee2(const float* scal, const float* times, const float* sig,
                const float* noise, float* state, float* planes, int U,
                int n_c, int n_scan, int n_times, int max_adc,
                cudaStream_t stream) {
  size_t smem = (F & kPrefetch) ? (6 + static_cast<size_t>(n_times)) * sizeof(float) : 0;
  if ((F & kBig) != 0) smem = kBigScratch;
  cudaError_t e = allow_smem(probe_fee2_kernel<F>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  probe_fee2_kernel<F><<<U / kBlock, kBlock, smem, stream>>>(
      scal, times, sig, noise, state, planes, U, n_c, n_scan, n_times, max_adc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The variants built (flags as larndsim_tpu_torch/tools/probe_fee.py and
// probe_fee2.py parse them); any other flag set returns cudaErrorInvalidValue.
#define PROBE_FEE_VARIANTS(X) \
  X(0) X(kConsts) X(kOuts) X(kNoGuard) X(kNoSig) X(kNoNoise) X(kNoState) \
  X(kIntOps) X(kAnyRed)
#define PROBE_FEE2_VARIANTS(X)                                              \
  X(0) X(kPrefetch) X(kPrefetch | kAnyIO) X(kPrefetch | kVmOuts)            \
  X(kPrefetch | kVmOuts | kVmOuts5) X(kPrefetch | kBig)                     \
  X(kPrefetch | kTailSplit) X(kPrefetch | kVmOuts | kBig)                   \
  X(kPrefetch | kVmOuts | kTailSplit) X(kPrefetch | kVmOuts | kBig | kTailSplit)

extern "C" int probe_fee_launch(
    unsigned flags, const float* scal, const float* times, const float* thr,
    const float* q0, const float* sig, const float* noise, float* out,
    float* o1, int* o2, float* o3, int* o4, float* fstate, int* istate, int U,
    int n_c, int n_scan, int n_times, int max_adc, cudaStream_t stream) {
  switch (flags) {
#define CASE(F)                                                              \
  case (F):                                                                  \
    return launch_fee<(F)>(scal, times, thr, q0, sig, noise, out, o1, o2, o3, \
                           o4, fstate, istate, U, n_c, n_scan, n_times,      \
                           max_adc, stream);
    PROBE_FEE_VARIANTS(CASE)
#undef CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// a0..a4: the `anyio` outputs, passed and never touched.
extern "C" int probe_fee2_launch(
    unsigned flags, const float* scal, const float* times, const float* sig,
    const float* noise, const float* thr, const float* q0, float* state,
    float* planes, float* a0, float* a1, int* a2, int* a3, int* a4, int U,
    int n_c, int n_scan, int n_times, int max_adc, cudaStream_t stream) {
  (void)thr, (void)q0, (void)a0, (void)a1, (void)a2, (void)a3, (void)a4;
  switch (flags) {
#define CASE(F)                                                              \
  case (F):                                                                  \
    return launch_fee2<(F)>(scal, times, sig, noise, state, planes, U, n_c,  \
                            n_scan, n_times, max_adc, stream);
    PROBE_FEE2_VARIANTS(CASE)
#undef CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
