// Blocked-ELL SpMM for XCT projection/backprojection on Hopper (sm_90a).
//
//   out[b, r, :] = sum_s sum_k vals[b, s, r, k] * x[winmap[b, s, inds[b, s, r, k]], :]
//
// Numeric contract (the reference's _fma_block): every stage's partial
// is summed in the compute type C from zero over k = 0..K-1, each step
// rounded as Arith<C>::step says, then added into an fp32 accumulator.
// The output is fp32 [B, R, F] for every pair, double included.  With
// the same window contents every staging mode below therefore gives the
// same bits.
//
// One kernel template, one CTA per row-block b, looping over the stages
// s in order (the TPU's sequential revisit of the output block becomes a
// loop inside the CTA; no atomics).  Per stage the CTA stages the window
// [BUF, F] in shared memory, stages the stage's R*K indices and values
// beside it, and after __syncthreads() each thread owns up to kMaxOut
// (r, f) outputs and loops over k.  The staging mode is the template
// parameter MODE; each mode replaces one Pallas TPU kernel of
// src/repro/kernels/xct_spmm.py and has its own extern "C" entries:
//
//   kSorted   (row 1)  replaces _spmm_fused_kernel_coalesced_sorted
//             (:249-305, wrapper _pallas_fused_coalesced_sorted :629-660).
//             The window comes from the class-sorted segment table: x is
//             row-major [C, F], so a segment {src, dst, len} is one
//             contiguous len*F run, and the segments of one length class
//             all have the same power-of-two length, so the rows of a
//             class flatten into one index space that all threads stride
//             through with 16-byte loads (segoff gives each class's slot
//             range; pad slots after segoff[-1] are never read).
//             Bound on this card: the packed inds + vals stream, 4 B per
//             padded slot at f16 (about 0.71 GB per projector application
//             at n=512, 384 angles), read once from device memory; x
//             (8 MB at f16, F=16) stays in the 50 MB L2.
//   kUnsorted (row 2)  replaces _spmm_fused_kernel_coalesced (:193-246,
//             wrapper _pallas_fused_coalesced :598-626).  The table is in
//             run order and carries no class offsets: every slot holds
//             its own len (0 = pad).  Each warp takes one slot at a time
//             and its lanes copy the slot's len rows.  Bound: the same
//             stream as row 1, plus the work of walking every slot.
//   kPerRow   (row 3)  replaces _spmm_fused_kernel (:141-190, wrapper
//             _pallas_fused_per_row :572-595).  Window row j is
//             x[winmap[b, s, j]]: BUF row copies per stage, all threads
//             striding through them.  Bound: the same stream as row 1
//             plus the BUF int32 winmap entries per stage.
//   kStaged   (row 4)  replaces _spmm_staged_kernel (:327-338, wrapper
//             spmm_block_ell_staged :685-726).  The caller pre-gathers the
//             windows into a [B, S, BUF, F] tensor in device memory; the
//             kernel copies stage s's contiguous [BUF, F] block.  Bound:
//             that window tensor, about 4.29 GB per projector application
//             at n=512 in f16 (6648*26*776*16*2 B), against 0.73 GB for
//             row 1, plus the gather that writes it.
//
// The quantized form (Q = true, row 1q) replaces the same three fused
// Pallas kernels with quantized=True (_block_scale :133-138, applied in
// _fma_block :88-114): vals are int8 or fp8-e4m3 (V), the window f16 and
// the compute f32.  Each (b, s) carries one int32 exponent e in
// [-100, 100]; the CTA builds 2^e exactly from its bits and forms
// float(q) * 2^e before the step, exact in f32 as the reference's
// vals.astype(f32) * scale is.  Bound: 3 B per padded slot (int16 index
// + 1-byte value) plus 4 B per (b, s).
//
// Double buffering with cp.async, TMA and tensor cores are later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxOut = 4;  // outputs per thread: R * F <= 1024

enum Staging : int { kSorted = 0, kUnsorted = 1, kPerRow = 2, kStaged = 3 };

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
template <typename C, typename T>
__device__ __forceinline__ C to_compute(T v) {
  return v;  // same type, or int8 -> float
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
template <>
__device__ __forceinline__ float to_compute<float, __nv_fp8_e4m3>(
    __nv_fp8_e4m3 v) {
  return static_cast<float>(v);  // e4m3 values are all exact in f32
}

// 2^e in f32 from its exponent bits (e in [-126, 127]; callers give
// [-100, 100]).
__device__ __forceinline__ float pow2f(int e) {
  return __int_as_float((e + 127) << 23);
}

__host__ __device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

template <typename V, typename S>
__host__ __device__ __forceinline__ size_t smem_layout(int R, int K, int BUF,
                                                       int F, size_t* vals_at,
                                                       size_t* inds_at) {
  const size_t win = align16(static_cast<size_t>(BUF) * F * sizeof(S));
  const size_t vals = align16(static_cast<size_t>(R) * K * sizeof(V));
  const size_t inds = align16(static_cast<size_t>(R) * K * sizeof(int16_t));
  *vals_at = win;
  *inds_at = win + vals;
  return win + vals + inds;
}

// Copy one unit of window row `dst` from source row `src`: 16 bytes when
// rows are 16-byte multiples (vec), else one element.
template <typename S>
__device__ __forceinline__ void copy_unit(S* __restrict__ win,
                                          const S* __restrict__ x, size_t src,
                                          size_t dst, int unit, int F,
                                          int vec) {
  if (vec) {
    const size_t row_bytes = static_cast<size_t>(F) * sizeof(S);
    const uint4* from = reinterpret_cast<const uint4*>(
        reinterpret_cast<const unsigned char*>(x) + src * row_bytes);
    uint4* to = reinterpret_cast<uint4*>(
        reinterpret_cast<unsigned char*>(win) + dst * row_bytes);
    to[unit] = from[unit];
  } else {
    win[dst * F + unit] = x[src * F + unit];
  }
}

// Stage the window of stage bs = b * n_stage + s into shared memory.
template <int MODE, typename S>
__device__ __forceinline__ void stage_window(
    S* __restrict__ win, const S* __restrict__ x,
    const int* __restrict__ table, const int* __restrict__ segoff,
    size_t bs, int BUF, int F, int nseg, int noff, int vec,
    int units_per_row) {
  const int tid = threadIdx.x;
  if constexpr (MODE == kSorted) {
    const int* segs = table + bs * nseg * 3;
    const int* off = segoff + bs * noff;
    const int n_cls = noff - 1;
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
        copy_unit(win, x, static_cast<size_t>(segs[3 * g]) + rr,
                  static_cast<size_t>(segs[3 * g + 1]) + rr, unit, F, vec);
      }
    }
  } else if constexpr (MODE == kUnsorted) {
    const int* segs = table + bs * nseg * 3;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    for (int g = warp; g < nseg; g += kWarps) {
      const int len = segs[3 * g + 2];
      if (len <= 0) continue;  // pad slot
      const size_t src = static_cast<size_t>(segs[3 * g]);
      const size_t dst = static_cast<size_t>(segs[3 * g + 1]);
      const int n_items = len * units_per_row;
      for (int it = lane; it < n_items; it += 32) {
        const int row = it / units_per_row;
        const int unit = it - row * units_per_row;
        copy_unit(win, x, src + row, dst + row, unit, F, vec);
      }
    }
  } else if constexpr (MODE == kPerRow) {
    const int* wm = table + bs * BUF;
    const int n_items = BUF * units_per_row;
    for (int it = tid; it < n_items; it += kThreads) {
      const int row = it / units_per_row;
      const int unit = it - row * units_per_row;
      copy_unit(win, x, static_cast<size_t>(wm[row]),
                static_cast<size_t>(row), unit, F, vec);
    }
  } else {  // kStaged: x is the pre-gathered [B, S, BUF, F] window tensor
    const S* block = x + bs * BUF * F;
    const int n_items = BUF * units_per_row;
    for (int it = tid; it < n_items; it += kThreads) {
      const int row = it / units_per_row;
      const int unit = it - row * units_per_row;
      copy_unit(win, block, static_cast<size_t>(row),
                static_cast<size_t>(row), unit, F, vec);
    }
  }
}

template <int MODE, typename V, typename S, typename C, bool Q>
__global__ void __launch_bounds__(kThreads)
    xct_spmm_kernel(const int16_t* __restrict__ inds,
                    const V* __restrict__ vals, const S* __restrict__ x,
                    const int* __restrict__ table,
                    const int* __restrict__ segoff,
                    const int* __restrict__ scales, float* __restrict__ out,
                    int n_stage, int R, int K, int BUF, int F, int nseg,
                    int noff, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  size_t vals_at, inds_at;
  smem_layout<V, S>(R, K, BUF, F, &vals_at, &inds_at);
  S* win = reinterpret_cast<S*>(smem);
  V* vals_s = reinterpret_cast<V*>(smem + vals_at);
  int16_t* inds_s = reinterpret_cast<int16_t*>(smem + inds_at);

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int rf = R * F;
  const int rk = R * K;
  const size_t row_bytes = static_cast<size_t>(F) * sizeof(S);
  const int units_per_row = vec ? static_cast<int>(row_bytes / 16) : F;

  float acc[kMaxOut];
#pragma unroll
  for (int j = 0; j < kMaxOut; ++j) acc[j] = 0.0f;

  for (int s = 0; s < n_stage; ++s) {
    const size_t bs = static_cast<size_t>(b) * n_stage + s;
    stage_window<MODE, S>(win, x, table, segoff, bs, BUF, F, nseg, noff, vec,
                          units_per_row);
    // ---- stage this (b, s) tile of indices and values ---------------
    const int16_t* ib = inds + bs * rk;
    const V* vb = vals + bs * rk;
    for (int i = tid; i < rk; i += kThreads) {
      inds_s[i] = ib[i];
      vals_s[i] = vb[i];
    }
    float scale = 1.0f;
    if constexpr (Q) scale = pow2f(scales[bs]);
    __syncthreads();

    // ---- per-stage partial in C, then into the fp32 accumulator -----
#pragma unroll
    for (int j = 0; j < kMaxOut; ++j) {
      const int o = tid + j * kThreads;
      if (o < rf) {
        const int r = o / F;
        const int f = o - r * F;
        const int16_t* ir = inds_s + r * K;
        const V* vr = vals_s + r * K;
        C part = Arith<C>::zero();
        for (int k = 0; k < K; ++k) {
          const C xv = to_compute<C, S>(win[static_cast<int>(ir[k]) * F + f]);
          C v = to_compute<C, V>(vr[k]);
          if constexpr (Q) v = __fmul_rn(v, scale);
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

template <int MODE, typename V, typename S, typename C, bool Q>
int launch(const void* inds, const void* vals, const void* x,
           const void* table, const void* segoff, const void* scales,
           void* out, int B, int n_stage, int R, int K, int BUF, int F,
           int nseg, int noff, int vec, void* stream) {
  if (B == 0) return static_cast<int>(cudaSuccess);
  size_t vals_at, inds_at;
  const size_t smem = smem_layout<V, S>(R, K, BUF, F, &vals_at, &inds_at);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        xct_spmm_kernel<MODE, V, S, C, Q>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  xct_spmm_kernel<MODE, V, S, C, Q><<<B, kThreads, smem,
                                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(inds), static_cast<const V*>(vals),
      static_cast<const S*>(x), static_cast<const int*>(table),
      static_cast<const int*>(segoff), static_cast<const int*>(scales),
      static_cast<float*>(out), n_stage, R, K, BUF, F, nseg, noff, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Entry xct_spmm_<staging>_<vals>_<window>_<compute>.  `table` is the
// segment table (sorted, unsorted), the int32 winmap (per_row) or unused
// (staged); `x` is the [C, F] slab, or the [B, S, BUF, F] window tensor
// for staged; `scales` is the [B, S] int32 exponent table of the
// quantized entries and unused elsewhere.
#define XCT_SPMM_ENTRY(NAME, MODE, V, S, C, Q)                              \
  extern "C" int NAME(const void* inds, const void* vals, const void* x,    \
                      const void* table, const void* segoff,                \
                      const void* scales, void* out, int B, int n_stage,    \
                      int R, int K, int BUF, int F, int nseg, int noff,     \
                      int vec, void* stream) {                              \
    return launch<MODE, V, S, C, Q>(inds, vals, x, table, segoff, scales,   \
                                    out, B, n_stage, R, K, BUF, F, nseg,    \
                                    noff, vec, stream);                     \
  }

// the six float pairs and the two quantized value types of one fused mode
#define XCT_SPMM_FUSED(TAG, MODE)                                           \
  XCT_SPMM_ENTRY(xct_spmm_##TAG##_f64_f64_f64, MODE, double, double,        \
                 double, false)                                             \
  XCT_SPMM_ENTRY(xct_spmm_##TAG##_f32_f32_f32, MODE, float, float, float,   \
                 false)                                                     \
  XCT_SPMM_ENTRY(xct_spmm_##TAG##_f16_f16_f16, MODE, __half, __half,        \
                 __half, false)                                             \
  XCT_SPMM_ENTRY(xct_spmm_##TAG##_f16_f16_f32, MODE, __half, __half, float, \
                 false)                                                     \
  XCT_SPMM_ENTRY(xct_spmm_##TAG##_bf16_bf16_bf16, MODE, __nv_bfloat16,      \
                 __nv_bfloat16, __nv_bfloat16, false)                       \
  XCT_SPMM_ENTRY(xct_spmm_##TAG##_bf16_bf16_f32, MODE, __nv_bfloat16,       \
                 __nv_bfloat16, float, false)                               \
  XCT_SPMM_ENTRY(xct_spmm_##TAG##_i8_f16_f32, MODE, int8_t, __half, float,  \
                 true)                                                      \
  XCT_SPMM_ENTRY(xct_spmm_##TAG##_e4m3_f16_f32, MODE, __nv_fp8_e4m3,        \
                 __half, float, true)

XCT_SPMM_FUSED(sorted, kSorted)
XCT_SPMM_FUSED(unsorted, kUnsorted)
XCT_SPMM_FUSED(per_row, kPerRow)

XCT_SPMM_ENTRY(xct_spmm_staged_f64_f64_f64, kStaged, double, double, double,
               false)
XCT_SPMM_ENTRY(xct_spmm_staged_f32_f32_f32, kStaged, float, float, float,
               false)
XCT_SPMM_ENTRY(xct_spmm_staged_f16_f16_f16, kStaged, __half, __half, __half,
               false)
XCT_SPMM_ENTRY(xct_spmm_staged_f16_f16_f32, kStaged, __half, __half, float,
               false)
XCT_SPMM_ENTRY(xct_spmm_staged_bf16_bf16_bf16, kStaged, __nv_bfloat16,
               __nv_bfloat16, __nv_bfloat16, false)
XCT_SPMM_ENTRY(xct_spmm_staged_bf16_bf16_f32, kStaged, __nv_bfloat16,
               __nv_bfloat16, float, false)
// the quantized tier under staging="gather": vals dequantized to f32
// before the call, f16 windows, f32 compute
XCT_SPMM_ENTRY(xct_spmm_staged_f32_f16_f32, kStaged, float, __half, float,
               false)
