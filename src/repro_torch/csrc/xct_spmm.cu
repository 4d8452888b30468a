// Blocked-ELL SpMM for XCT projection/backprojection on Hopper (sm_90a).
//
//   out[b, r, :] = sum_s sum_k vals[b, s, r, k] * x[winmap[b, s, inds[b, s, r, k]], :]
//
// Numeric contract (the reference's _fma_block): every stage's partial
// is summed in the compute type C from zero over k = 0..K-1, each step
// rounded as Arith<C>::step says, then added into an fp32 accumulator.
// The output is fp32 [B, R, F] for every pair, double included.
//
// Replaces the Pallas TPU kernel _spmm_fused_kernel_coalesced_sorted
// (src/repro/kernels/xct_spmm.py:249-305, wrapper
// _pallas_fused_coalesced_sorted at :629-660).  It computes what that
// kernel computes; it does not copy its structure:
//
//   * one CTA per row-block b, looping over the stages s in order, so
//     the TPU's sequential revisit of the output block becomes a loop
//     inside the CTA and no atomics are needed;
//   * per stage the CTA stages the window [BUF, F] in shared memory
//     from the plan's class-sorted segment table.  x is row-major
//     [C, F], so a segment {src, dst, len} is one contiguous len*F run.
//     The segments of one length class all have the same power-of-two
//     length, so the rows of a class flatten into one index space that
//     all threads stride through with 16-byte loads (segoff gives each
//     class's slot range; the pad slots after segoff[-1] are never
//     read).  The stage's R*K indices and values are staged beside it;
//   * after __syncthreads() each thread owns up to MAX_OUT (r, f)
//     outputs and loops over k.
//
// What bounds it on the card: the packed inds + vals stream, 4 B per
// padded slot at f16 storage (about 0.71 GB per application of the
// projector at n=512, 384 angles), read once from device memory.  x
// (8 MB at f16, [n_vox, 16]) sits in the 50 MB L2, so the window
// re-reads hit L2, not device memory.  Double buffering with cp.async,
// TMA and tensor cores are later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxOut = 4;  // outputs per thread: R * F <= 1024

// ---- one step part + v * x in the compute type C ---------------------
// Rounded as the reference computes it on its CPU validation platform
// (and as the plain version does): f16 evaluates the step in f32, where
// the product of two f16 values is exact, and rounds once to f16; bf16,
// f32 and f64 round the product and then the sum.  The _rn intrinsics
// keep nvcc from contracting a multiply and an add into one FMA.
template <typename C>
struct Arith;

template <>
struct Arith<double> {
  static __device__ __forceinline__ double zero() { return 0.0; }
  static __device__ __forceinline__ double step(double p, double v,
                                                double x) {
    return __dadd_rn(p, __dmul_rn(v, x));
  }
  static __device__ __forceinline__ float to_f32(double a) {
    return __double2float_rn(a);
  }
};

template <>
struct Arith<float> {
  static __device__ __forceinline__ float zero() { return 0.0f; }
  static __device__ __forceinline__ float step(float p, float v, float x) {
    return __fadd_rn(p, __fmul_rn(v, x));
  }
  static __device__ __forceinline__ float to_f32(float a) { return a; }
};

template <>
struct Arith<__half> {
  static __device__ __forceinline__ __half zero() {
    return __float2half_rn(0.0f);
  }
  static __device__ __forceinline__ __half step(__half p, __half v,
                                                __half x) {
    return __float2half_rn(__fadd_rn(
        __half2float(p), __fmul_rn(__half2float(v), __half2float(x))));
  }
  static __device__ __forceinline__ float to_f32(__half a) {
    return __half2float(a);
  }
};

template <>
struct Arith<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 zero() {
    return __float2bfloat16_rn(0.0f);
  }
  static __device__ __forceinline__ __nv_bfloat16 step(__nv_bfloat16 p,
                                                       __nv_bfloat16 v,
                                                       __nv_bfloat16 x) {
    const __nv_bfloat16 prod = __float2bfloat16_rn(
        __fmul_rn(__bfloat162float(v), __bfloat162float(x)));
    return __float2bfloat16_rn(
        __fadd_rn(__bfloat162float(p), __bfloat162float(prod)));
  }
  static __device__ __forceinline__ float to_f32(__nv_bfloat16 a) {
    return __bfloat162float(a);
  }
};

// ---- storage -> compute conversion (exact for every pair used) ------
template <typename C, typename S>
__device__ __forceinline__ C to_compute(S v) {
  return v;  // same type
}
template <>
__device__ __forceinline__ float to_compute<float, __half>(__half v) {
  return __half2float(v);
}
template <>
__device__ __forceinline__ float to_compute<float, __nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}

__host__ __device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

template <typename S>
__host__ __device__ __forceinline__ size_t smem_layout(int R, int K, int BUF,
                                                       int F, size_t* vals_at,
                                                       size_t* inds_at) {
  const size_t win = align16(static_cast<size_t>(BUF) * F * sizeof(S));
  const size_t vals = align16(static_cast<size_t>(R) * K * sizeof(S));
  const size_t inds = align16(static_cast<size_t>(R) * K * sizeof(int16_t));
  *vals_at = win;
  *inds_at = win + vals;
  return win + vals + inds;
}

template <typename S, typename C>
__global__ void __launch_bounds__(kThreads)
    xct_spmm_kernel(const int16_t* __restrict__ inds,
                    const S* __restrict__ vals, const S* __restrict__ x,
                    const int* __restrict__ winsegs,
                    const int* __restrict__ segoff, float* __restrict__ out,
                    int n_stage, int R, int K, int BUF, int F, int nseg,
                    int noff, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  size_t vals_at, inds_at;
  smem_layout<S>(R, K, BUF, F, &vals_at, &inds_at);
  S* win = reinterpret_cast<S*>(smem);
  S* vals_s = reinterpret_cast<S*>(smem + vals_at);
  int16_t* inds_s = reinterpret_cast<int16_t*>(smem + inds_at);

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int rf = R * F;
  const int rk = R * K;
  const size_t row_bytes = static_cast<size_t>(F) * sizeof(S);
  // copy unit: 16 bytes when rows are 16-byte multiples, else one element
  const int units_per_row = vec ? static_cast<int>(row_bytes / 16) : F;
  const int n_cls = noff - 1;

  float acc[kMaxOut];
#pragma unroll
  for (int j = 0; j < kMaxOut; ++j) acc[j] = 0.0f;

  for (int s = 0; s < n_stage; ++s) {
    const size_t bs = static_cast<size_t>(b) * n_stage + s;
    const int* segs = winsegs + bs * nseg * 3;
    const int* off = segoff + bs * noff;

    // ---- stage the window, one length class at a time ---------------
    for (int ci = 0; ci < n_cls; ++ci) {
      const int g0 = off[ci];
      const int g1 = off[ci + 1];
      if (g0 >= g1) continue;
      const int lg = n_cls - 1 - ci;  // class ci copies 2^lg rows
      const int n_items = ((g1 - g0) << lg) * units_per_row;
      for (int it = tid; it < n_items; it += kThreads) {
        const int row = it / units_per_row;
        const int unit = it - row * units_per_row;
        const int g = g0 + (row >> lg);
        const int rr = row & ((1 << lg) - 1);
        const size_t src = static_cast<size_t>(segs[3 * g]) + rr;
        const size_t dst = static_cast<size_t>(segs[3 * g + 1]) + rr;
        if (vec) {
          const uint4* from = reinterpret_cast<const uint4*>(
              reinterpret_cast<const unsigned char*>(x) + src * row_bytes);
          uint4* to = reinterpret_cast<uint4*>(
              reinterpret_cast<unsigned char*>(win) + dst * row_bytes);
          to[unit] = from[unit];
        } else {
          win[dst * F + unit] = x[src * F + unit];
        }
      }
    }
    // ---- stage this (b, s) tile of indices and values ---------------
    const int16_t* ib = inds + bs * rk;
    const S* vb = vals + bs * rk;
    for (int i = tid; i < rk; i += kThreads) {
      inds_s[i] = ib[i];
      vals_s[i] = vb[i];
    }
    __syncthreads();

    // ---- per-stage partial in C, then into the fp32 accumulator -----
#pragma unroll
    for (int j = 0; j < kMaxOut; ++j) {
      const int o = tid + j * kThreads;
      if (o < rf) {
        const int r = o / F;
        const int f = o - r * F;
        const int16_t* ir = inds_s + r * K;
        const S* vr = vals_s + r * K;
        C part = Arith<C>::zero();
        for (int k = 0; k < K; ++k) {
          const C xv = to_compute<C, S>(win[static_cast<int>(ir[k]) * F + f]);
          const C v = to_compute<C, S>(vr[k]);
          part = Arith<C>::step(part, v, xv);
        }
        acc[j] = __fadd_rn(acc[j], Arith<C>::to_f32(part));
      }
    }
    __syncthreads();  // the next stage overwrites the window
  }

#pragma unroll
  for (int j = 0; j < kMaxOut; ++j) {
    const int o = tid + j * kThreads;
    if (o < rf) out[static_cast<size_t>(b) * rf + o] = acc[j];
  }
}

template <typename S, typename C>
int launch(const void* inds, const void* vals, const void* x,
           const void* winsegs, const void* segoff, void* out, int B,
           int n_stage, int R, int K, int BUF, int F, int nseg, int noff,
           int vec, void* stream) {
  if (B == 0) return static_cast<int>(cudaSuccess);
  size_t vals_at, inds_at;
  const size_t smem = smem_layout<S>(R, K, BUF, F, &vals_at, &inds_at);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        xct_spmm_kernel<S, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  xct_spmm_kernel<S, C><<<B, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(inds), static_cast<const S*>(vals),
      static_cast<const S*>(x), static_cast<const int*>(winsegs),
      static_cast<const int*>(segoff), static_cast<float*>(out), n_stage, R,
      K, BUF, F, nseg, noff, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define XCT_SPMM_ENTRY(NAME, S, C)                                          \
  extern "C" int NAME(const void* inds, const void* vals, const void* x,    \
                      const void* winsegs, const void* segoff, void* out,   \
                      int B, int n_stage, int R, int K, int BUF, int F,     \
                      int nseg, int noff, int vec, void* stream) {          \
    return launch<S, C>(inds, vals, x, winsegs, segoff, out, B, n_stage, R, \
                        K, BUF, F, nseg, noff, vec, stream);                \
  }

XCT_SPMM_ENTRY(xct_spmm_f64_f64, double, double)
XCT_SPMM_ENTRY(xct_spmm_f32_f32, float, float)
XCT_SPMM_ENTRY(xct_spmm_f16_f16, __half, __half)
XCT_SPMM_ENTRY(xct_spmm_f16_f32, __half, float)
XCT_SPMM_ENTRY(xct_spmm_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
XCT_SPMM_ENTRY(xct_spmm_bf16_f32, __nv_bfloat16, float)
