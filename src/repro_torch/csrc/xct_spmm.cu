// Blocked-ELL SpMM for XCT projection/backprojection on Hopper (sm_90a).
//
//   out[b, r, :] = sum_s sum_k vals[b, s, r, k] * x[winmap[b, s, inds[b, s, r, k]], :]
//
// Numeric contract (the reference's _fma_block): every stage's partial
// is summed in the compute type C from zero over k = 0..K-1, each step
// rounded as Arith<C>::step says, then added into an fp32 accumulator
// in stage order s = 0..S-1.  The output is fp32 [B, R, F] for every
// pair, double included.  With the same window contents every staging
// mode below therefore gives the same bits.  Stage partials are
// independent of each other; only the final fold is ordered, and that
// is the freedom the design below uses.
//
// One kernel template.  A CTA of 256 threads owns one row-block b (or,
// for row 4, a range of its stages) and walks its stages in rounds of P
// stages computed at once:
//
//   * Compute core (all rows).  A thread owns one row r of one stage and
//     a 16-byte vector of f (8 values at f16, 4 at f32, 2 at f64; it
//     loops over vectors when R * F is wider than the CTA).  The row's K
//     indices and values go from device memory straight into registers,
//     8 at a time with 16-byte loads, the next 8 loading while these are
//     used; each k then costs one 16-byte window load from shared memory
//     for up to 8 multiply-adds (the first design made three
//     shared-memory loads per multiply-add).  A stage takes R * F /
//     vector threads (64 at R=32, F=16, f16), so a CTA computes up to 4
//     stages at once.  Each
//     stage's partial lands in an fp32 buffer in shared memory, and the
//     CTA folds the round's partials into the accumulator in stage
//     order.  Nothing bounds R * F but shared memory.
//   * Window ring.  The windows live in a ring of D = (L + 1) * P slots
//     filled L rounds ahead of the compute, each slot completing on its
//     own mbarrier.  kernels/xct_spmm.py:launch_geometry sizes it from
//     shared memory for two or three CTAs per SM, whichever keeps more
//     stages computing on an SM (three on a tie), and no more CTAs than
//     the entry's registers allow (<name>_occupancy below; the n=512
//     shards in f16: P = 2, D = 4 for two CTAs on proj and for three on
//     back), falling back to one CTA with the whole 227 KB (f64: D = 2)
//     and to a single slot where only one window fits.  Copies are issued
//     by the last warps of the CTA, which compute nothing while P < 4,
//     and issuing of round j also prefetches round j+1's table rows and
//     round j's inds / vals tiles into L2.  Rows whose bytes are not a
//     16-byte multiple (small F), or an x that is not 16-byte aligned,
//     are copied element by element by every thread instead.
//
// The staging mode is the template parameter MODE; each mode replaces
// one Pallas TPU kernel of src/repro/kernels/xct_spmm.py and has its
// own extern "C" entries:
//
//   kSorted   (row 1)  replaces _spmm_fused_kernel_coalesced_sorted
//             (:249-305, wrapper _pallas_fused_coalesced_sorted :629-660).
//             Redesigned for Hopper.  The first design staged each window
//             through registers in ten class loops (one strided loop per
//             length class, an integer divide per item), then synchronised,
//             computed and synchronised again: nothing overlapped, and it ran
//             at 6-8% of its bound.  Now a warp reads the stage's class-sorted
//             segments {src, dst, len}, each one contiguous len*F run of x as
//             the TPU kernel's DMA, and copies every segment of at least 256
//             bytes with one cp.async.bulk (1-D TMA) and the shorter ones
//             (most of a table: 1-4 rows) with 16-byte cp.async from its
//             lanes, all completing on the slot's mbarrier.  The copy engine
//             costs about the same per copy whatever its size, so one bulk
//             copy per segment was bound by the count of copies; kBulkMin
//             below is the threshold.  Filling the same ring through the
//             first design's class loops with 16-byte cp.async from every
//             thread took 2.3-2.8x as long (PERF.md), so the loops remain
//             only for rows that are not 16-byte multiples (small F) or an
//             x that is not 16-byte aligned, which copy element by element.
//             Bound on this card: the packed inds + vals stream, 4 B per
//             padded slot at f16 (about 0.71 GB per projector application at
//             n=512, 384 angles), read once from device memory, x (8 MB at
//             f16, F=16) staying in the 50 MB L2.  What bounds the design:
//             every stage stages its whole [BUF, F] window from L2 (4.29 GB
//             per proj application), and the window reads of the compute meet
//             bank conflicts (random rows of 32 B: about two wavefronts where
//             one would do).
//   kUnsorted (row 2)  replaces _spmm_fused_kernel_coalesced (:193-246,
//             wrapper _pallas_fused_coalesced :598-626).  Redesigned for
//             Hopper.  The table is in run order and carries no class
//             offsets: every slot holds its own len (0 = pad, which may
//             sit anywhere).  The first designs copied from all 256
//             threads, a warp walking its live slots one at a time (three
//             shuffles and a loop of len * F / 8 items over 32 lanes per
//             slot), so the copy issue sat in series with every warp's
//             compute and 24-30 lanes idled on the 1-4-row segments.  Now
//             the warps no stage computes on fill the ring as row 1's do:
//             lane q of a stage's issuing warps takes slots q, q + 32 *
//             warps, ..., loads kSegBatch descriptors before copying, skips
//             pads, and copies a run of at least kBulkMin bytes by one
//             cp.async.bulk, a shorter one by 16-byte cp.async.  Bound: row
//             1's stream plus the table of every slot (NSEG = 312 on the
//             n=512 proj shard, 0.65 GB per application); what bounds the
//             design is row 1's window staging from L2, plus the table.
//   kPerRow   (row 3)  replaces _spmm_fused_kernel (:141-190, wrapper
//             _pallas_fused_per_row :572-595).  Redesigned for Hopper.
//             Window row j is x[winmap[b, s, j]].  The first design strode
//             all 256 threads through BUF * F / 8 items, each an integer
//             divide and a dependent load of its row's winmap entry before
//             its cp.async.  Now the free warps issue (two per stage at P
//             = 2): the stage's 16-byte units go to their lanes in order,
//             a row's units on neighbouring lanes, each lane loading 8
//             entries ahead and stepping row and unit without a divide.
//             Measured against it (PERF.md): four rows a lane from 16-byte
//             winmap loads (a 128-byte stride between the lanes' writes,
//             half a sector per request) took 2.1x the previous design's
//             time, and bulk copies of the runs of consecutive sources
//             that a ballot finds, per 32-row chunk or whole, were slower
//             too.
//             Bound: row 1's stream plus the BUF int32 winmap entries of
//             every stage (0.54 GB per proj application); what bounds the
//             design is the 16-byte copies of every window row from L2.
//   kStaged   (row 4)  replaces _spmm_staged_kernel (:327-338, wrapper
//             spmm_block_ell_staged :685-726).  Redesigned for Hopper.  The
//             caller pre-gathers the windows into a [B, S, BUF, F] tensor in
//             64 MB chunks (24 row-blocks a launch on the n=512 proj shard),
//             so the first design's one CTA per row-block left 108 of 132 SMs
//             idle in each of 277 launches.  Now each row-block's stages are
//             split over a thread block cluster of up to 8 CTAs (7 at S=26),
//             each filling its slots with one bulk copy per stage (the [BUF,
//             F] block is contiguous) and computing its stages at once; CTA 0
//             of the cluster folds all stage partials in stage order, reading
//             the others' through distributed shared memory.  Bound: the
//             window tensor, about 4.29 GB per projector application at n=512
//             in f16 (6648*26*776*16*2 B), against 0.73 GB for row 1, plus the
//             gather that writes it; chunked, the host's launch of each chunk
//             (Python and the CUDA runtime, 10-30 microseconds) as well.
//
// The quantized form (Q = true, row 1q) replaces the same three fused
// Pallas kernels with quantized=True (_block_scale :133-138, applied in
// _fma_block :88-114): vals are int8 or fp8-e4m3 (V), the window f16 and
// the compute f32.  Each (b, s) carries one int32 exponent e in
// [-100, 100]; the thread that computes the stage builds 2^e exactly
// from its bits into a register and forms float(q) * 2^e before the
// step, exact in f32 as the reference's vals.astype(f32) * scale is.
// Bound: 3 B per padded slot (int16 index + 1-byte value) plus 4 B per
// (b, s), plus the table under rows 2 and 3.  It shares the staging of
// its table's row (1, 2 or 3), so the window traffic bounds it as it
// bounds that row.
//
// Registers per thread (nvcc 12.8, -O3, -Xptxas -v, sm_90a;
// chip_smoke.py logs every entry's line): row 1 f16/f32, f16/f16 and
// bf16/f32 76, bf16/bf16 122, f32 91, f64 100; row 1q int8 and fp8 72;
// row 2 f16/f32, f16/f16 and bf16/f32 72, bf16/bf16 122, f32 85, f64 94,
// int8 and fp8 71; row 3 f16/f32 and bf16/f32 78, f16/f16 77, bf16/bf16
// 123, f32 86, f64 116, int8 and fp8 72; row 4 f16/f32 and bf16/f32 72,
// f16/f16 64, f32 values on f16 windows 80, bf16/bf16 123, f32 88, f64
// 94.  No entry of the 31 spills.  __launch_bounds__ caps rows 2 and 3
// on 16-bit windows with f32 compute at 80, so that three CTAs fit an SM
// (kMinCtas below), and every other entry at 128 (two CTAs);
// launch_geometry asks each entry's occupancy rather than assume it.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;  // indices and values per register chunk

// kSorted copies a segment of at least this many bytes with one
// cp.async.bulk and shorter ones with 16-byte cp.async: the copy engine
// pays about the same per copy whatever its size, and most segments are
// 1-4 rows (a threshold of 512 B was slower on the n=512 shards)
constexpr uint32_t kBulkMin = 256;

enum Staging : int { kSorted = 0, kUnsorted = 1, kPerRow = 2, kStaged = 3 };

// ---- one step part + v * x in the compute type C ---------------------
// Rounded as the reference computes it on its CPU validation platform
// (and as the plain version does): f32 rounds the step once, one fused
// multiply-add, as XLA contracts the reference's acc + v * x; f16
// evaluates the step in f32, where the product of two f16 values is
// exact, and rounds once to f16; bf16 and f64 round the product and then
// the sum.  The _rn intrinsics say which: nvcc contracts none of them.
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
    return __fmaf_rn(v, x, p);
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

// ---- launch geometry and the shared-memory layout --------------------
struct Geom {
  int n_stage, R, K, BUF, F, nseg, noff;
  int depth;       // ring slots D = (L + 1) * inflight
  int inflight;    // stages computed at once, P
  int cluster;     // CTAs per row-block (row 4 only; 1 elsewhere)
  int nloc;        // stages per CTA: ceil(S / cluster)
  int vec;         // window rows are 16-byte multiples and x is aligned:
                   // producer warps fill the slots, else every thread
                   // copies element by element
  int issuers;     // warps issuing rows 2 and 3's copies (vec)
  int kvec;        // inds / vals chunks load as 16-byte vectors
  int row_stride;  // bytes per window row in shared memory
  int nvec;        // 16-byte vectors per window row
  int group;       // threads per stage
};

struct Layout {
  size_t win, part, acc, bars, total;
};

// [ring: depth x BUF x row_stride][partials: nparts x R*F fp32]
// [accumulator: R*F fp32, one CTA per row-block only][depth mbarriers].
// Mirrored by kernels/xct_spmm.py:smem_bytes.
__host__ __device__ __forceinline__ Layout smem_layout(const Geom& g) {
  Layout l;
  l.win = static_cast<size_t>(g.BUF) * g.row_stride;
  const size_t rf = static_cast<size_t>(g.R) * g.F * sizeof(float);
  const size_t nparts = g.cluster > 1 ? g.nloc : 2 * g.inflight;
  l.part = g.depth * l.win;
  l.acc = l.part + align16(nparts * rf);
  l.bars = l.acc + (g.cluster > 1 ? 0 : align16(rf));
  l.total = l.bars + static_cast<size_t>(g.depth) * sizeof(uint64_t);
  return l;
}

// ---- PTX: mbarriers, bulk and 16-byte asynchronous copies ------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// raise the bytes the current phase waits for, without arriving
__device__ __forceinline__ void mbar_expect_tx_only(uint64_t* bar,
                                                    uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n\t"
      ".reg .pred P1;\n\t"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra LAB_WAIT;\n\t"
      "DONE:\n\t"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// one contiguous global -> shared copy, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* src,
                                            uint32_t bytes) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (bytes & 15) == 0 &&
      bytes > 0) {
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(
                     reinterpret_cast<uint64_t>(src)),
                 "r"(bytes)
                 : "memory");
  }
}

// [src, src + bytes) into L2, from the 16-byte boundary at or below src
// to the one at or below its end
__device__ __forceinline__ void prefetch_span(const void* src,
                                              uint32_t bytes) {
  const uintptr_t lo = reinterpret_cast<uintptr_t>(src) & ~uintptr_t{15};
  const uintptr_t hi =
      (reinterpret_cast<uintptr_t>(src) + bytes) & ~uintptr_t{15};
  prefetch_l2(reinterpret_cast<const void*>(lo),
              static_cast<uint32_t>(hi - lo));
}

// No memory clobber: the staging loops may load their next descriptors
// while earlier copies are in flight.  Nothing reads a slot before the
// mbarrier wait, which does clobber memory.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(reinterpret_cast<uint64_t>(src)));
}

// arrive on `bar` once this thread's earlier cp.async copies are done
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(smem_u32(bar))
               : "memory");
}

// ---- the element path: rows that are not 16-byte multiples ---------
// (small F) or an x that is not 16-byte aligned; every thread copies
// element e of window row `dst` from source row `src` with plain loads and
// stores (the first design's staging loops).
template <typename S>
__device__ __forceinline__ void copy_element(unsigned char* __restrict__ win,
                                             const S* __restrict__ x,
                                             size_t src, size_t dst, int e,
                                             const Geom& g) {
  reinterpret_cast<S*>(win + dst * g.row_stride)[e] = x[src * g.F + e];
}

// Stage the window of stage bs = b * n_stage + s into `win`.
template <int MODE, typename S>
__device__ __forceinline__ void stage_window(
    unsigned char* __restrict__ win, const S* __restrict__ x,
    const int* __restrict__ table, const int* __restrict__ segoff,
    size_t bs, const Geom& g) {
  const int tid = threadIdx.x;
  const int upr = g.F;  // elements per row
  if constexpr (MODE == kSorted) {
    const int* segs = table + bs * g.nseg * 3;
    const int* off = segoff + bs * g.noff;
    const int n_cls = g.noff - 1;
    for (int ci = 0; ci < n_cls; ++ci) {
      const int g0 = off[ci];
      const int g1 = off[ci + 1];
      if (g0 >= g1) continue;
      const int lg = n_cls - 1 - ci;  // class ci copies 2^lg rows
      const int n_items = ((g1 - g0) << lg) * upr;
      for (int it = tid; it < n_items; it += kThreads) {
        const int row = it / upr;
        const int unit = it - row * upr;
        const int seg = g0 + (row >> lg);
        const int rr = row & ((1 << lg) - 1);
        copy_element(win, x, static_cast<size_t>(segs[3 * seg]) + rr,
                     static_cast<size_t>(segs[3 * seg + 1]) + rr, unit, g);
      }
    }
  } else if constexpr (MODE == kUnsorted) {
    // one slot a thread; a pad (len 0) may sit anywhere in the table
    const int* segs = table + bs * g.nseg * 3;
    for (int q = tid; q < g.nseg; q += kThreads) {
      const size_t src = static_cast<size_t>(segs[3 * q]);
      const size_t dst = static_cast<size_t>(segs[3 * q + 1]);
      const int n_items = segs[3 * q + 2] * upr;
      for (int it = 0; it < n_items; ++it) {
        const int row = it / upr;
        copy_element(win, x, src + row, dst + row, it - row * upr, g);
      }
    }
  } else if constexpr (MODE == kPerRow) {
    const int* wm = table + bs * g.BUF;
    const int n_items = g.BUF * upr;
    for (int it = tid; it < n_items; it += kThreads) {
      const int row = it / upr;
      const int unit = it - row * upr;
      copy_element(win, x, static_cast<size_t>(wm[row]),
                   static_cast<size_t>(row), unit, g);
    }
  } else {  // kStaged: x is the pre-gathered [B, S, BUF, F] window tensor
    const S* block = x + bs * g.BUF * g.F;
    const int n_items = g.BUF * upr;
    for (int it = tid; it < n_items; it += kThreads) {
      const int row = it / upr;
      const int unit = it - row * upr;
      copy_element(win, block, static_cast<size_t>(row),
                   static_cast<size_t>(row), unit, g);
    }
  }
}

// ---- the producer routes: 16-byte rows on an aligned x ---------------
// One contiguous run of `bytes` (a multiple of 16) from x into a slot: one
// cp.async.bulk from kBulkMin bytes on, raising the slot's expected bytes
// first, else 16-byte cp.async from this lane.
__device__ __forceinline__ void copy_run(unsigned char* to,
                                         const unsigned char* from,
                                         uint32_t bytes, uint64_t* bar) {
  if (bytes >= kBulkMin) {
    mbar_expect_tx_only(bar, bytes);
    bulk_copy(to, from, bytes, bar);
  } else {
    for (uint32_t u = 0; u < bytes; u += 16) cp_async16(to + u, from + u);
  }
}

// Segment descriptors a lane loads before it issues their copies.
constexpr int kSegBatch = 4;

// Row 2: lane li of the stage's nl issuing lanes takes slots li, li + nl,
// ... of the run-order table: a pad (len 0), wherever it sits, issues
// nothing, every other slot one copy_run.
__device__ __forceinline__ void fill_segments(unsigned char* __restrict__ win,
                                              const unsigned char* __restrict__ xb,
                                              const int* __restrict__ segs,
                                              uint64_t* bar, int li, int nl,
                                              const Geom& g) {
  for (int q0 = li; q0 < g.nseg; q0 += kSegBatch * nl) {
    int src[kSegBatch], dst[kSegBatch], len[kSegBatch];
#pragma unroll
    for (int i = 0; i < kSegBatch; ++i) {
      const int q = q0 + i * nl;
      src[i] = dst[i] = len[i] = 0;
      if (q < g.nseg) {
        src[i] = __ldg(segs + 3 * q);
        dst[i] = __ldg(segs + 3 * q + 1);
        len[i] = __ldg(segs + 3 * q + 2);
      }
    }
#pragma unroll
    for (int i = 0; i < kSegBatch; ++i)
      if (len[i] > 0)
        copy_run(win + static_cast<size_t>(dst[i]) * g.row_stride,
                 xb + static_cast<size_t>(src[i]) * g.row_stride,
                 static_cast<uint32_t>(len[i]) * g.row_stride, bar);
  }
}

// Row 3: window row j is x row wm[j].  The stage's BUF * nvec 16-byte
// units go to its nl issuing lanes in order, the units of one row on
// neighbouring lanes, so that one warp instruction reads whole 32-byte
// sectors of x and writes consecutive shared memory.  Each lane loads the
// winmap entries of kRowBatch units before it issues their copies,
// neighbouring lanes reading neighbouring entries, and steps row and unit
// without a divide.
constexpr int kRowBatch = 8;

__device__ __forceinline__ void fill_rows(unsigned char* __restrict__ win,
                                          const unsigned char* __restrict__ xb,
                                          const int* __restrict__ wm, int li,
                                          int nl, const Geom& g) {
  const int nv = g.nvec;
  const int drow = nl / nv;  // rows and units one step of nl units moves
  const int dunit = nl - drow * nv;
  int row = li / nv;
  int unit = li - row * nv;
  while (row < g.BUF) {
    int src[kRowBatch], to[kRowBatch], off[kRowBatch];
#pragma unroll
    for (int i = 0; i < kRowBatch; ++i) {
      src[i] = row < g.BUF ? __ldg(wm + row) : -1;
      to[i] = row * g.row_stride + unit * 16;
      off[i] = unit * 16;
      row += drow;
      unit += dunit;
      if (unit >= nv) {
        unit -= nv;
        ++row;
      }
    }
#pragma unroll
    for (int i = 0; i < kRowBatch; ++i)
      if (src[i] >= 0)
        cp_async16(win + to[i],
                   xb + static_cast<size_t>(src[i]) * g.row_stride + off[i]);
  }
}

// Warps issuing stage p of a round under kUnsorted and kPerRow: issuer
// warp w (counted from the CTA's last warp) takes stage w % P, so each
// stage gets every P-th issuer; where the P stages outnumber the issuers,
// each warp takes stages w, w + issuers, ... alone.
__device__ __forceinline__ int stage_warps(const Geom& g, int p) {
  const int P = g.inflight;
  return P <= g.issuers ? (g.issuers - p + P - 1) / P : 1;
}

// Issue the windows of local stages [first, first + count) into the
// slots [slot0, slot0 + count): by the producer routes (vec), else by the
// element loops on every thread; each issuing lane arrives once per slot.
template <int MODE, typename V, typename S>
__device__ __forceinline__ void issue_stages(
    unsigned char* __restrict__ ring, uint64_t* bars,
    const int16_t* __restrict__ inds, const V* __restrict__ vals,
    const S* __restrict__ x, const int* __restrict__ table,
    const int* __restrict__ segoff, size_t bs0, int slot0, int count,
    int next, size_t win_bytes, const Geom& g) {
  const int tid = threadIdx.x;
  const size_t rk = static_cast<size_t>(g.R) * g.K;
  const uint32_t window_bytes = static_cast<uint32_t>(g.BUF) * g.row_stride;
  // Copies are issued from the last warps of the CTA, which compute no
  // stage when the stages in flight leave them idle (P = 2 stages of 64
  // threads at R=32, F=16, f16 leave warps 4-7).
  const int rtid = kThreads - 1 - tid;
  if (rtid < count) {  // the round's inds / vals tiles, ahead into L2
    prefetch_l2(inds + (bs0 + rtid) * rk,
                static_cast<uint32_t>(rk * sizeof(int16_t)));
    prefetch_l2(vals + (bs0 + rtid) * rk,
                static_cast<uint32_t>(rk * sizeof(V)));
  } else if (rtid >= 32 && rtid < 32 + next) {
    // the next round's table rows, so that its issue chain (offsets,
    // then segments) hits L2
    const size_t bs = bs0 + count + (rtid - 32);
    if constexpr (MODE == kSorted) {
      const uintptr_t segs =
          reinterpret_cast<uintptr_t>(table + bs * g.nseg * 3);
      const uint32_t bytes = static_cast<uint32_t>(g.nseg) * 12;
      prefetch_l2(reinterpret_cast<const void*>(segs & ~uintptr_t{15}),
                  (bytes < 1024 ? bytes : 1024) & ~15u);
      const uintptr_t off =
          reinterpret_cast<uintptr_t>(segoff + bs * g.noff) & ~uintptr_t{15};
      prefetch_l2(reinterpret_cast<const void*>(off), 64);
    } else if constexpr (MODE == kUnsorted) {
      prefetch_span(table + bs * g.nseg * 3, static_cast<uint32_t>(g.nseg) * 12);
    } else if constexpr (MODE == kPerRow) {
      prefetch_span(table + bs * g.BUF, static_cast<uint32_t>(g.BUF) * 4);
    }
  }
  if (!g.vec) {
    for (int p = 0; p < count; ++p) {
      stage_window<MODE, S>(ring + (slot0 + p) * win_bytes, x, table, segoff,
                            bs0 + p, g);
    }
    for (int p = 0; p < count; ++p) cp_async_arrive(bars + slot0 + p);
    return;
  }
  const int warp = kWarps - 1 - (tid >> 5);
  const int lane = tid & 31;
  const unsigned char* xb = reinterpret_cast<const unsigned char*>(x);
  if constexpr (MODE == kSorted || MODE == kStaged) {
    for (int p = warp; p < count; p += kWarps) {
      const size_t bs = bs0 + p;
      unsigned char* dst = ring + (slot0 + p) * win_bytes;
      uint64_t* bar = bars + slot0 + p;
      // the slot was last read by the generic proxy (the compute)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      if constexpr (MODE == kSorted) {
        // segments of at least kBulkMin bytes go by one bulk copy each,
        // the short ones (most of a table) by 16-byte cp.async; each
        // lane expects the bytes of its own bulk copies before issuing
        // them and arrives once its cp.async copies have landed, so
        // the slot completes when all 32 lanes' copies have
        const int* segs = table + bs * g.nseg * 3;
        const int nreal = segoff[bs * g.noff + g.noff - 1];
        for (int q = lane; q < nreal; q += 32) {
          copy_run(dst + static_cast<size_t>(segs[3 * q + 1]) * g.row_stride,
                   xb + static_cast<size_t>(segs[3 * q]) * g.row_stride,
                   static_cast<uint32_t>(segs[3 * q + 2]) * g.row_stride, bar);
        }
        cp_async_arrive(bar);
      } else if (lane == 0) {
        mbar_expect_tx(bar, window_bytes);
        bulk_copy(dst, xb + bs * window_bytes, window_bytes, bar);
      }
    }
  } else {
    // kUnsorted and kPerRow: the issuer warps only (the warps no stage
    // computes on where there are any), stage_warps of them per stage;
    // every lane arrives once its cp.async copies have landed
    if (warp >= g.issuers) return;
    const int P = g.inflight;
    for (int p = warp % P; p < count; p += g.issuers) {
      const size_t bs = bs0 + p;
      unsigned char* dst = ring + (slot0 + p) * win_bytes;
      uint64_t* bar = bars + slot0 + p;
      const int li = (warp / P) * 32 + lane;
      const int nl = 32 * stage_warps(g, p);
      // the slot was last read by the generic proxy (the compute)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      if constexpr (MODE == kUnsorted) {
        fill_segments(dst, xb, table + bs * g.nseg * 3, bar, li, nl, g);
      } else {
        fill_rows(dst, xb, table + bs * g.BUF, li, nl, g);
      }
      cp_async_arrive(bar);
    }
  }
}

// ---- the compute core: one stage's partial for this thread's items ---
template <typename T>
__device__ __forceinline__ void load_chunk(T (&dst)[kChunk],
                                           const T* __restrict__ src, int n,
                                           int kvec) {
  if (kvec && n == kChunk) {
    if constexpr (sizeof(T) == 1) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(src));
      memcpy(dst, &u, sizeof(u));
    } else {
      constexpr int kVecs = sizeof(T) * kChunk / 16;
      uint4 u[kVecs];
#pragma unroll
      for (int i = 0; i < kVecs; ++i)
        u[i] = __ldg(reinterpret_cast<const uint4*>(src) + i);
      memcpy(dst, u, sizeof(u));
    }
  } else {
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (j < n) dst[j] = src[j];
  }
}

// acc[e] = step(acc[e], v, window[ind][f0 + e]) for the vector's values
template <typename V, typename S, typename C, bool Q>
__device__ __forceinline__ void step_k(C (&acc)[16 / sizeof(S)],
                                       const unsigned char* __restrict__ wv,
                                       int16_t ind, V val, float scale,
                                       int row_stride) {
  constexpr int kVw = 16 / sizeof(S);
  const uint4 w = *reinterpret_cast<const uint4*>(
      wv + static_cast<int>(ind) * row_stride);
  S xs[kVw];
  memcpy(xs, &w, sizeof(w));
  C v = to_compute<C, V>(val);
  if constexpr (Q) v = __fmul_rn(v, scale);
#pragma unroll
  for (int e = 0; e < kVw; ++e)
    acc[e] = Arith<C>::step(acc[e], v, to_compute<C, S>(xs[e]));
}

template <typename V, typename S, typename C, bool Q>
__device__ __forceinline__ void compute_stage(
    const int16_t* __restrict__ inds, const V* __restrict__ vals,
    const int* __restrict__ scales, const unsigned char* __restrict__ win,
    float* __restrict__ part, size_t bs, int lt, const Geom& g) {
  constexpr int kVw = 16 / sizeof(S);  // window values per 16 bytes
  float scale = 1.0f;
  if constexpr (Q) scale = pow2f(__ldg(scales + bs));
  const int items = g.R * g.nvec;
  for (int it = lt; it < items; it += g.group) {
    const int r = it / g.nvec;
    const int v = it - r * g.nvec;
    const size_t row = (bs * g.R + r) * static_cast<size_t>(g.K);
    const int16_t* ip = inds + row;
    const V* vp = vals + row;
    const unsigned char* wv = win + v * 16;
    C acc[kVw];
#pragma unroll
    for (int e = 0; e < kVw; ++e) acc[e] = Arith<C>::zero();
    int16_t ic[kChunk];
    V vc[kChunk];
    load_chunk(ic, ip, min(kChunk, g.K), g.kvec);
    load_chunk(vc, vp, min(kChunk, g.K), g.kvec);
    for (int k0 = 0; k0 < g.K; k0 += kChunk) {
      const int n = min(kChunk, g.K - k0);
      int16_t in[kChunk];
      V vn[kChunk];
      const int k1 = k0 + kChunk;
      if (k1 < g.K) {  // the next chunk loads while this one is used
        load_chunk(in, ip + k1, min(kChunk, g.K - k1), g.kvec);
        load_chunk(vn, vp + k1, min(kChunk, g.K - k1), g.kvec);
      }
      if (n == kChunk) {
#pragma unroll
        for (int j = 0; j < kChunk; ++j)
          step_k<V, S, C, Q>(acc, wv, ic[j], vc[j], scale, g.row_stride);
      } else {  // the last, partial chunk (K not a multiple of 8)
#pragma unroll
        for (int j = 0; j < kChunk; ++j)
          if (j < n)
            step_k<V, S, C, Q>(acc, wv, ic[j], vc[j], scale,
                                   g.row_stride);
      }
      if (k1 < g.K) {
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          ic[j] = in[j];
          vc[j] = vn[j];
        }
      }
    }
    const int f0 = v * kVw;
    float* pr = part + r * g.F + f0;
    if constexpr (kVw % 4 == 0) {
      if ((g.F & 3) == 0 && f0 + kVw <= g.F) {  // 16-byte stores
#pragma unroll
        for (int e = 0; e < kVw; e += 4)
          *reinterpret_cast<float4*>(pr + e) = make_float4(
              Arith<C>::to_f32(acc[e]), Arith<C>::to_f32(acc[e + 1]),
              Arith<C>::to_f32(acc[e + 2]), Arith<C>::to_f32(acc[e + 3]));
        continue;
      }
    }
#pragma unroll
    for (int e = 0; e < kVw; ++e)
      if (f0 + e < g.F) pr[e] = Arith<C>::to_f32(acc[e]);
  }
}

// CTAs per SM the launch bounds leave registers for: three (80 a
// thread) for rows 2 and 3 on 16-bit windows with f32 compute, whose
// rings launch_geometry sizes for three CTAs on the n=512 back shard;
// two (128 a thread) elsewhere
template <int MODE, typename S, typename C>
constexpr int kMinCtas = (MODE == kUnsorted || MODE == kPerRow) &&
                                 sizeof(S) == 2 && sizeof(C) == 4
                             ? 3
                             : 2;

template <int MODE, typename V, typename S, typename C, bool Q>
__global__ void __launch_bounds__(kThreads, (kMinCtas<MODE, S, C>))
    xct_spmm_kernel(const int16_t* __restrict__ inds,
                    const V* __restrict__ vals, const S* __restrict__ x,
                    const int* __restrict__ table,
                    const int* __restrict__ segoff,
                    const int* __restrict__ scales, float* __restrict__ out,
                    const Geom g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout lay = smem_layout(g);
  unsigned char* ring = smem;
  float* part = reinterpret_cast<float*>(smem + lay.part);
  float* acc = reinterpret_cast<float*>(smem + lay.acc);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bars);

  const int tid = threadIdx.x;
  const int b = blockIdx.x / g.cluster;
  const int rank = blockIdx.x - b * g.cluster;
  const int s_lo = rank * g.nloc;
  const int nst = max(0, min(g.nloc, g.n_stage - s_lo));
  const int rf = g.R * g.F;
  const int P = g.inflight;
  const int sets = g.depth / P;  // L + 1 slot sets of P slots
  const int rounds = (nst + P - 1) / P;
  const size_t bs0 = static_cast<size_t>(b) * g.n_stage + s_lo;

  if (tid == 0) {
    // arrivals per fill of a slot of stage p in its round: every thread
    // on the element path; else the one expect_tx of kStaged's bulk copy,
    // the issuing warp's 32 lanes under kSorted, the lanes of stage p's
    // stage_warps under kUnsorted and kPerRow
    for (int i = 0; i < g.depth; ++i) {
      const int arrivals =
          !g.vec ? kThreads
                 : MODE == kStaged ? 1
                 : MODE == kSorted ? 32 : 32 * stage_warps(g, i % P);
      mbar_init(bars + i, arrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (g.cluster == 1)
    for (int e = tid; e < rf; e += kThreads) acc[e] = 0.0f;
  __syncthreads();

  auto issue = [&](int j) {
    const int count = min(P, nst - j * P);
    const int next = max(0, min(P, nst - (j + 1) * P));
    issue_stages<MODE, V, S>(ring, bars, inds, vals, x, table, segoff,
                             bs0 + j * P, (j % sets) * P, count, next,
                             lay.win, g);
  };
  for (int j = 0; j < sets - 1 && j < rounds; ++j) issue(j);

  // the stage of the round this thread computes, and its place in it
  const int grp = tid / g.group;
  const int lt = tid - grp * g.group;
  for (int j = 0; j < rounds; ++j) {
    // round j + L goes into the slots round j - 1 released
    if (j + sets - 1 < rounds) issue(j + sets - 1);
    if (!g.vec) __syncthreads();  // element copies are plain stores
    const int ls = j * P + grp;
    if (grp < P && ls < nst) {
      const int slot = (j % sets) * P + grp;
      mbar_wait(bars + slot, (j / sets) & 1);
      float* pb = part + static_cast<size_t>(
                             g.cluster > 1 ? ls : (j & 1) * P + grp) * rf;
      compute_stage<V, S, C, Q>(inds, vals, scales, ring + slot * lay.win,
                                pb, bs0 + ls, lt, g);
    }
    __syncthreads();  // partials complete; round j's slots free
    if (g.cluster == 1) {
      // fold the round's partials into the accumulator in stage order
      const int count = min(P, nst - j * P);
      const float* pr = part + static_cast<size_t>((j & 1) * P) * rf;
      for (int e = tid; e < rf; e += kThreads) {
        float a = acc[e];
        for (int p = 0; p < count; ++p) a = __fadd_rn(a, pr[p * rf + e]);
        acc[e] = a;
      }
    }
  }

  float* ob = out + static_cast<size_t>(b) * rf;
  if (g.cluster == 1) {
    for (int e = tid; e < rf; e += kThreads) ob[e] = acc[e];
    return;
  }
  // row 4: CTA 0 folds every CTA's stage partials, in stage order,
  // through distributed shared memory
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  if (rank == 0) {
    for (int e = tid; e < rf; e += kThreads) {
      float a = 0.0f;
      for (int q = 0; q < g.cluster; ++q) {
        const int nq = max(0, min(g.nloc, g.n_stage - q * g.nloc));
        const float* rp = cl.map_shared_rank(part, q);
        for (int ls = 0; ls < nq; ++ls) a = __fadd_rn(a, rp[ls * rf + e]);
      }
      ob[e] = a;
    }
  }
  cl.sync();  // the others' partials stay alive until CTA 0 has read them
}

template <int MODE, typename V, typename S, typename C, bool Q>
int launch_with(const Geom& g, int B, const void* inds, const void* vals,
                const void* x, const void* table, const void* segoff,
                const void* scales, void* out, void* stream) {
  const size_t smem = smem_layout(g).total;
  auto kernel = xct_spmm_kernel<MODE, V, S, C, Q>;
  // the largest shared-memory opt-in set so far, per device: the
  // attribute call costs more than the launch on the chunked row 4 path
  constexpr int kDevices = 64;
  static int opted_in[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int* opted = dev < kDevices ? &opted_in[dev] : nullptr;
  if (smem > 48 * 1024 && (!opted || static_cast<int>(smem) > *opted)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (opted) *opted = static_cast<int>(smem);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B) * g.cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = g.cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const int16_t*>(inds),
      static_cast<const V*>(vals), static_cast<const S*>(x),
      static_cast<const int*>(table), static_cast<const int*>(segoff),
      static_cast<const int*>(scales), static_cast<float*>(out), g);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE, typename V, typename S, typename C, bool Q>
int launch(const void* inds, const void* vals, const void* x,
           const void* table, const void* segoff, const void* scales,
           void* out, int B, int n_stage, int R, int K, int BUF, int F,
           int nseg, int noff, int depth, int inflight, int cluster,
           void* stream) {
  if (B == 0) return static_cast<int>(cudaSuccess);
  Geom g;
  g.n_stage = n_stage;
  g.R = R;
  g.K = K;
  g.BUF = BUF;
  g.F = F;
  g.nseg = nseg;
  g.noff = noff;
  g.depth = depth;
  g.inflight = inflight;
  g.cluster = cluster;
  g.nloc = cluster > 0 ? (n_stage + cluster - 1) / cluster : 0;
  const size_t row_bytes = static_cast<size_t>(F) * sizeof(S);
  g.vec = row_bytes % 16 == 0 &&
          reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const size_t vals_align = sizeof(V) * kChunk < 16 ? sizeof(V) * kChunk : 16;
  g.kvec = K % kChunk == 0 && reinterpret_cast<uintptr_t>(inds) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(vals) % vals_align == 0;
  g.row_stride = static_cast<int>(align16(row_bytes));
  g.nvec = g.row_stride / 16;
  const int items = R * g.nvec;
  g.group = items < kThreads ? items : kThreads;
  if (inflight < 1 || depth < inflight || depth % inflight != 0 ||
      inflight * g.group > kThreads || cluster < 1 || cluster > 8 ||
      R < 1 || F < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // rows 2 and 3 issue from the warps no stage in flight computes on, and
  // from at least one warp per stage
  const int idle = kWarps - (inflight * g.group + 31) / 32;
  const int one_per_stage = inflight < kWarps ? inflight : kWarps;
  g.issuers = idle > one_per_stage ? idle : one_per_stage;
  return launch_with<MODE, V, S, C, Q>(g, B, inds, vals, x, table, segoff,
                                       scales, out, stream);
}

template <int MODE, typename V, typename S, typename C, bool Q>
int occupancy(int* ctas) {
  auto kernel = xct_spmm_kernel<MODE, V, S, C, Q>;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, kernel, kThreads, 0));
}

}  // namespace

// Entry xct_spmm_<staging>_<vals>_<window>_<compute>.  `table` is the
// segment table (sorted, unsorted), the int32 winmap (per_row) or unused
// (staged); `x` is the [C, F] slab, or the [B, S, BUF, F] window tensor
// for staged; `scales` is the [B, S] int32 exponent table of the
// quantized entries and unused elsewhere.  `depth`, `inflight` and
// `cluster` are the ring slots, the stages computed at once and the CTAs
// per row-block (kernels/xct_spmm.py:launch_geometry).
// <NAME>_occupancy(&ctas) gives the CTAs of the entry's kernel an SM can
// hold by its registers and threads (shared memory aside), for
// launch_geometry to size the ring by.  Each returns a cudaError_t.
#define XCT_SPMM_ENTRY(NAME, MODE, V, S, C, Q)                              \
  extern "C" int NAME(const void* inds, const void* vals, const void* x,    \
                      const void* table, const void* segoff,                \
                      const void* scales, void* out, int B, int n_stage,    \
                      int R, int K, int BUF, int F, int nseg, int noff,     \
                      int depth, int inflight, int cluster, void* stream) { \
    return launch<MODE, V, S, C, Q>(inds, vals, x, table, segoff, scales,   \
                                    out, B, n_stage, R, K, BUF, F, nseg,    \
                                    noff, depth, inflight, cluster,         \
                                    stream);                                \
  }                                                                         \
  extern "C" int NAME##_occupancy(int* ctas) {                              \
    return occupancy<MODE, V, S, C, Q>(ctas);                               \
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
