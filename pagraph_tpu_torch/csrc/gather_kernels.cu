// The gather kernels of a GraphSAGE block for Hopper (sm_90a): one fused
// forward and one fused backward of a block's two gathers of one source
// table, the two-source layer-0 assembly, the window reduction of long
// neighbor windows, and the backward of a row gather alone.
//
// What they replace (the two Pallas TPU kernels of the JAX package):
//   * pg_block_gather_fwd <- gather_rows_pallas (pagraph_tpu/ops/pallas_gather.py:58,
//     body _gather_rows_kernel :29) and gather_mean_pallas (:132, body
//     _gather_sum_kernel :86), with a 'sum' kind beside 'mean', and a 'max'
//     kind (the pool aggregator's, XLA in the JAX package:
//     pagraph_tpu/ops/aggregate.py:62-64).  A GraphSAGE
//     block gathers the same source table twice, for its self rows and for
//     its neighbor mean, so one launch writes both outputs; either half may
//     be absent, which makes it the forward of one gather alone.  Both
//     Pallas kernels compute at their source's dtype (:79, :157, :163), so
//     the table is f32 or bf16 (train.dtype="bfloat16"), and so are the
//     outputs.
//   * pg_assemble <- gather_rows_pallas, folding in the two-source cache
//     hit/miss selection of pagraph_tpu/storage/cache.py assemble_features
//     and the f32 promotion (int8: times a per-column scale) of its
//     dequantize_fused, both of which the JAX package leaves to XLA, and, at
//     bf16 compute, the cast of train/state.py cast_apply.
//   * pg_window_reduce <- gather_mean_pallas's neighbor reduction alone at
//     a fan-out with no unrolled instantiation of the block forward: device
//     inference's degree-bucketed window reduction (pagraph_tpu/models/
//     inference.py:152 _window_reduce, XLA in the JAX package) at fan-outs
//     32..4096, the hubs' windows and their second level.
//   * pg_block_gather_bwd: the backward of both halves.  The Pallas kernels
//     are forward-only (JAX differentiates jnp.take); the port trains through
//     these kernels, so their gradient is a kernel too: one launch takes both
//     incoming gradients and writes the one gradient table (in f32; bf16
//     gradients get a bf16 table, rounded from it by a second launch).  The
//     max kind's backward also re-reads the block's source rows: per output
//     row and column it recomputes the max and the number of valid slots
//     that reach it, and adds g / ties to each of those slots (JAX's
//     gradient of jnp.max, and torch's of amax, split it equally among
//     tied maxima; after a ReLU exact ties at 0 are common).
//   * pg_scatter_add_rows: the backward of the self half alone (the lstm
//     aggregator's row gather), one cooperative launch that zeroes its own
//     table: no memset, and at bf16 no second launch.
//   * pg_dropout_block_fwd / pg_dropout_block_bwd replace no Pallas kernel:
//     on the on-device sampler's prefix-layout blocks (no gather) the JAX
//     package leaves the model's dropout, the self slice and the masked
//     mean to XLA, whose fusions the port's eager PyTorch does not make (an
//     int32 tensor of bits, four full passes, a broadcast mask, padded
//     slices in the backward).  One forward reads a block's source and its
//     packed keep-mask (a bit an element) once and writes its two [n, D]
//     outputs; the backward writes each source row's gradient once.
//   * pg_dropout_bits replaces no Pallas kernel either: the JAX package
//     draws its dropout bits with jax.random in XLA.  It writes that mask
//     from the units torch.randint would draw from the same generator, one
//     bit a unit (section "the dropout keep-mask" below).
//   * pg_gat_attention_fwd / pg_gat_attention_bwd replace no Pallas kernel
//     either: GAT's attention over a prefix-layout block (the JAX package's
//     XLA einsums, masked softmax and weighted sum, models/gat.py).  The
//     forward reads each row of z once, the scores computed from the rows it
//     holds, and writes [n, heads, hd] with each row's max and denominator;
//     the backward writes each row of z's gradient once and the gradients of
//     the two attention vectors (section "GAT attention" below).
//
// What bounds them: device-memory bytes and latency, not FLOPs.  A row gather
// does no arithmetic; the reduction does fanout adds per output element.  The
// least traffic is the index bytes, the bytes of each distinct source row a
// launch reads, and the output bytes, each once; chip_smoke.py's bound_ms
// counts that at the main path's blocks (PERF.md).  Rows are 64-400 bytes, so
// each row is a few independent loads whose latency (not the bytes) sets the
// time unless enough rows are in flight; at block 1 the launch's fixed cost
// is most of it.
//
// What the design does about it:
//   * one launch a block for both gathers (the forward and the backward),
//     so each block pays the launch and the first memory round trip once;
//   * a group of G lanes serves one row, G the smallest power of two >= the
//     row's units (at most 32); a unit is 4 elements (a float4 of f32, 8
//     bytes of bf16) when D % 4 == 0 and every table is aligned to it, else
//     one element.  At D = 32 that is 8 lanes, 4 rows a warp, where one warp
//     a row left 24 lanes idle; at D = 100, one warp of 25 active lanes;
//   * a row's indices (its self position, its fan-out positions and mask
//     bytes) are loaded once and held in registers, with the fan-out a
//     template parameter so the slot loops unroll; fan-outs with no
//     instantiation of their own (FANOUT = 0) re-read the slots from memory
//     (training at odd fan-outs; the neighbor half alone at such fan-outs
//     is the window kernel, below);
//   * every data load of a row (the self unit and every valid neighbor unit)
//     is issued before its first add or store, so a row waits for memory
//     once; masked slots issue no load, as in the Pallas kernel, where
//     invalid slots start no DMA;
//   * values are f32 in registers at every element type: bf16 widens by a
//     shift, the neighbor sum accumulates in f32, the mean is one reciprocal
//     a row, not a division per element, and a bf16 output is rounded to
//     nearest even once; a self row is copied as it is;
//   * the forward's grid is one row per group of lanes.  A grid capped at
//     the blocks the card holds resident, each group walking rows with a
//     stride and loading the next row's indices first (the counterpart of
//     Pallas's scalar prefetch), measured no faster at the main path's
//     blocks (PERF.md) and was removed;
//   * the two-source assembly reads each output row from exactly one table,
//     in one launch, instead of gathering both and selecting.  The host plan
//     gives one signed index a row (the cache row, or -1 - the miss row), so
//     a row is one dependent trip to memory for its index, then its data;
//     a group of lanes serves 4 rows, loading their 4 indices at once and
//     issuing all 4 rows' loads before the first store; the rows are read at
//     the tier's own width (4, 2 or 1 byte a value, 4-column units of 16, 8
//     or 4 bytes) and widened in registers, so the bf16 and int8 tiers move
//     a half and a quarter of the f32 row bytes; at bf16 compute the output
//     is written as bf16, half the f32 output bytes;
//   * the backward's table (~1-2 MB, in the 50 MB L2) is f32 at every
//     element type: zeroed with cudaMemsetAsync and filled by one kernel in
//     the same C call, with one 16-byte reduction a 4-element unit
//     (atomicAdd(float4*), red.global.add.v4.f32 on sm_90) and scalar f32
//     reductions otherwise.  Bf16 gradients are widened as they are loaded,
//     and the f32 table is rounded to the bf16 gradient table by a second
//     kernel in the same call.  Adding in bf16 (red.global.add.noftz.bf16x2)
//     rounds every add, in an order the atomics choose: on the main path's
//     block 1 that missed 1e-2 of the sum, so the port adds in f32 and
//     rounds once (one more launch, PERF.md);
//   * the window kernel gives a long row (F >= 512) a whole CTA: its
//     indices staged in shared memory by the TMA's 1-D bulk copy, 8 unit
//     loads in flight a lane, the warps' partials reduced in a fixed order;
//     one group of lanes walking 4096 slots alone reached 3-4% of the bound;
//   * the scatter kernel zeroes its table, waits at a grid barrier and adds,
//     with its loads issued before the zeroing: the memset was a device
//     operation of its own.  A kernel whose CTAs each own a slice of the
//     table in shared memory (no barrier) measured slower: every CTA reads
//     every id, and a slice of hot rows gets all their adds (PERF.md).
//
// Interface: plain C, loaded with ctypes.  Pointers and the stream are void*;
// sizes are int64_t / int; element types are codes (0 f32, 1 bf16).  Kernels
// run on the caller's stream, allocate nothing and do not synchronize.  Each
// entry point returns cudaGetLastError() so a refused launch is reported to
// the caller.  Indices must be in range; the Python wrappers check shapes,
// dtypes, devices and contiguity.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarp * kWarpsPerBlock;

// ---------------------------------------------------------------------------
// element types and their units
// ---------------------------------------------------------------------------
// Rows hold float, uint16_t (bf16 bit patterns) or int8_t.  A unit is 4
// elements (VEC: a float4, a uint2, a char4) or one; in registers it is a
// float4 or a float.

template <typename T> struct Unit4;
template <> struct Unit4<float> { using type = float4; };
template <> struct Unit4<uint16_t> { using type = uint2; };
template <> struct Unit4<int8_t> { using type = char4; };

template <typename T, bool VEC>
using UnitOf = typename std::conditional<VEC, typename Unit4<T>::type, T>::type;
template <bool VEC>
using ValOf = typename std::conditional<VEC, float4, float>::type;

template <typename T, bool VEC>
__device__ __forceinline__ const UnitOf<T, VEC>* unit_row(const T* table, int64_t row, int d) {
  return reinterpret_cast<const UnitOf<T, VEC>*>(table + row * d);
}
template <typename T, bool VEC>
__device__ __forceinline__ UnitOf<T, VEC>* unit_row(T* table, int64_t row, int d) {
  return reinterpret_cast<UnitOf<T, VEC>*>(table + row * d);
}

// bf16 -> f32 is exact: the 16 bits are the top half of the f32.
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}
__device__ __forceinline__ float widen(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float4 widen(const float4& u) { return u; }
__device__ __forceinline__ float4 widen(const uint2& u) {    // little-endian pairs
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float4 widen(const char4& u) {
  return make_float4(static_cast<float>(u.x), static_cast<float>(u.y),
                     static_cast<float>(u.z), static_cast<float>(u.w));
}

// f32 -> bf16, rounded to nearest even (torch's .to(torch.bfloat16) on
// finite values)
__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// store f32 values as a unit of the output's element type
__device__ __forceinline__ void st_unit(float* p, float v) { *p = v; }
__device__ __forceinline__ void st_unit(uint16_t* p, float v) {
  *p = static_cast<uint16_t>(bf16_bits(v));
}
__device__ __forceinline__ void st_unit(float4* p, const float4& v) { *p = v; }
__device__ __forceinline__ void st_unit(uint2* p, const float4& v) {
  *p = make_uint2(bf16_bits(v.x) | (bf16_bits(v.y) << 16),
                  bf16_bits(v.z) | (bf16_bits(v.w) << 16));
}

// add f32 values into a unit of f32 device memory.  sm_90 declares
// atomicAdd for float4 (global memory only); with the result unused it
// compiles to a reduction (REDG.E.ADD.F32x4), not a fetch-and-add.
__device__ __forceinline__ void red_unit(float* p, float v) { atomicAdd(p, v); }
__device__ __forceinline__ void red_unit(float4* p, const float4& v) { atomicAdd(p, v); }

__device__ __forceinline__ void add_to(float& a, float b) { a += b; }
__device__ __forceinline__ void add_to(float4& a, const float4& b) {
  a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
}
__device__ __forceinline__ void max_to(float& a, float b) { a = fmaxf(a, b); }
__device__ __forceinline__ void max_to(float4& a, const float4& b) {
  a.x = fmaxf(a.x, b.x); a.y = fmaxf(a.y, b.y); a.z = fmaxf(a.z, b.z); a.w = fmaxf(a.w, b.w);
}
__device__ __forceinline__ void splat(float& a, float v) { a = v; }
__device__ __forceinline__ void splat(float4& a, float v) { a = make_float4(v, v, v, v); }
// ties += (v == mx), per column
__device__ __forceinline__ void count_ties(float& t, float v, float mx) { t += v == mx ? 1.f : 0.f; }
__device__ __forceinline__ void count_ties(float4& t, const float4& v, const float4& mx) {
  count_ties(t.x, v.x, mx.x); count_ties(t.y, v.y, mx.y);
  count_ties(t.z, v.z, mx.z); count_ties(t.w, v.w, mx.w);
}
// q = g / ties per column (IEEE division, as JAX's and torch's max gradients
// divide); columns with no tie are never read
__device__ __forceinline__ float tie_share(float g, float t) { return t > 0.f ? g / t : 0.f; }
__device__ __forceinline__ float4 tie_share(const float4& g, const float4& t) {
  return make_float4(tie_share(g.x, t.x), tie_share(g.y, t.y), tie_share(g.z, t.z),
                     tie_share(g.w, t.w));
}
// c = (v == mx) ? q : 0 per column; true if any column is a tie
__device__ __forceinline__ bool tie_select(float& c, float v, float mx, float q) {
  c = v == mx ? q : 0.f;
  return v == mx;
}
__device__ __forceinline__ bool tie_select(float4& c, const float4& v, const float4& mx,
                                           const float4& q) {
  const bool x = tie_select(c.x, v.x, mx.x, q.x), y = tie_select(c.y, v.y, mx.y, q.y);
  const bool z = tie_select(c.z, v.z, mx.z, q.z), w = tie_select(c.w, v.w, mx.w, q.w);
  return x || y || z || w;
}

// The neighbor reduction of a block, by the wrappers' kind codes.
enum Kind : int { kSum = 0, kMean = 1, kMax = 2 };
constexpr float kNegInf = -__builtin_huge_valf();

template <int KIND, typename V>
__device__ __forceinline__ void reduce_to(V& acc, const V& v) {
  if constexpr (KIND == kMax) {
    max_to(acc, v);
  } else {
    add_to(acc, v);
  }
}

__device__ __forceinline__ float scaled(float v, float s) { return v * s; }
__device__ __forceinline__ float4 scaled(float4 v, float s) {
  v.x *= s; v.y *= s; v.z *= s; v.w *= s;
  return v;
}
__device__ __forceinline__ float4 scaled(float4 v, const float4& s) {
  v.x *= s.x; v.y *= s.y; v.z *= s.z; v.w *= s.w;
  return v;
}

// log2 of the lanes that serve one row: the smallest power of two covering
// the row's units, at most a warp.
inline int lanes_lg(int units) {
  int lg = 0;
  while ((1 << lg) < units && (1 << lg) < kWarp) ++lg;
  return lg;
}

inline int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// A row's indices, held in registers (FANOUT > 0) or, for the runtime
// fan-out (FANOUT == 0), only its self position.  Rows past a half's end
// load nothing: position 0 and every slot masked.
template <int FANOUT>
struct RowIdx {
  static constexpr int kSlots = FANOUT > 0 ? FANOUT : 1;
  int32_t self;
  int32_t p[kSlots];
  bool m[kSlots];
};

template <int FANOUT>
__device__ __forceinline__ RowIdx<FANOUT> load_idx(
    int64_t row, const int32_t* __restrict__ self_pos, int64_t n_self,
    const int32_t* __restrict__ pos, const uint8_t* __restrict__ mask,
    int64_t n_neigh) {
  RowIdx<FANOUT> x;
  x.self = row < n_self ? __ldg(self_pos + row) : 0;
  const bool has_neigh = row < n_neigh;
#pragma unroll
  for (int k = 0; k < RowIdx<FANOUT>::kSlots; ++k) {
    x.p[k] = FANOUT > 0 && has_neigh ? __ldg(pos + row * FANOUT + k) : 0;
    x.m[k] = FANOUT > 0 && has_neigh && __ldg(mask + row * FANOUT + k) != 0;
  }
  return x;
}

// One row of both outputs:
//   out_self[row]  = src[x.self]                                   row < n_self
//   out_neigh[row] = sum_k mask[row,k] * src[pos[row,k]]  (* 1/max(count,1) for kMean)
//                  | max over the valid k of src[pos[row,k]], 0 if none   (kMax)
// The reduction is f32 in registers, rounded once to T (a max of bf16
// values is one of them, so it rounds to itself).  The max is the JAX
// package's where(mask, msgs, -1e30), max, where(count > 0, m, 0).
template <typename T, int FANOUT, int KIND, bool VEC>
__device__ __forceinline__ void block_fwd_row(
    const RowIdx<FANOUT>& x, int64_t row, const T* __restrict__ src,
    int64_t n_self, const int32_t* __restrict__ pos,
    const uint8_t* __restrict__ mask, int64_t n_neigh, int fanout_rt,
    T* __restrict__ out_self, T* __restrict__ out_neigh, int d,
    int group, int sub) {
  using Unit = UnitOf<T, VEC>;
  using Val = ValOf<VEC>;
  constexpr int kSlots = RowIdx<FANOUT>::kSlots;
  const bool has_self = row < n_self, has_neigh = row < n_neigh;
  const int F = FANOUT > 0 ? FANOUT : fanout_rt;
  const int32_t* p = pos + row * F;        // read only for FANOUT == 0
  const uint8_t* m = mask + row * F;
  int count = 0;
  if (FANOUT > 0) {
#pragma unroll
    for (int k = 0; k < kSlots; ++k) count += x.m[k] ? 1 : 0;
  } else if (has_neigh) {
    for (int k = 0; k < F; ++k) count += m[k] ? 1 : 0;
  }
  const float s = KIND == kMean && count > 0 ? 1.f / static_cast<float>(count) : 1.f;
  const Unit* src_self = unit_row<T, VEC>(src, x.self, d);
  Unit* os = has_self ? unit_row<T, VEC>(out_self, row, d) : nullptr;
  Unit* on = has_neigh ? unit_row<T, VEC>(out_neigh, row, d) : nullptr;
  const int units = VEC ? d / 4 : d;
  for (int i = sub; i < units; i += group) {
    const Unit vs = has_self ? __ldg(src_self + i) : Unit{};
    Val acc{};
    if (KIND == kMax) splat(acc, kNegInf);
    if (FANOUT > 0) {
      Unit v[kSlots];
#pragma unroll
      for (int k = 0; k < kSlots; ++k)
        v[k] = x.m[k] ? __ldg(unit_row<T, VEC>(src, x.p[k], d) + i) : Unit{};
#pragma unroll
      for (int k = 0; k < kSlots; ++k)
        if (x.m[k]) reduce_to<KIND>(acc, widen(v[k]));
    } else if (has_neigh) {
      for (int k = 0; k < F; ++k)
        if (m[k]) reduce_to<KIND>(acc, widen(__ldg(unit_row<T, VEC>(src, p[k], d) + i)));
    }
    if (KIND == kMax && count == 0) acc = Val{};    // DGL's empty-mailbox zero
    if (has_self) os[i] = vs;                       // a copy, at any T
    if (has_neigh) st_unit(on + i, KIND == kMean ? scaled(acc, s) : acc);
  }
}

// Forward of a block's two gathers of one source table.  A group of
// 1 << lg lanes serves one row.
template <typename T, int FANOUT, int KIND, bool VEC>
__global__ void __launch_bounds__(kThreads)
block_gather_fwd_kernel(const T* __restrict__ src,
                        const int32_t* __restrict__ self_pos, int64_t n_self,
                        const int32_t* __restrict__ pos,
                        const uint8_t* __restrict__ mask, int64_t n_neigh,
                        int fanout_rt, T* __restrict__ out_self,
                        T* __restrict__ out_neigh, int d, int lg) {
  const int64_t rows = n_self > n_neigh ? n_self : n_neigh;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads >> lg) + (threadIdx.x >> lg);
  if (row >= rows) return;
  const int group = 1 << lg;
  const int sub = threadIdx.x & (group - 1);
  const RowIdx<FANOUT> x = load_idx<FANOUT>(row, self_pos, n_self, pos, mask, n_neigh);
  block_fwd_row<T, FANOUT, KIND, VEC>(x, row, src, n_self, pos, mask, n_neigh,
                                      fanout_rt, out_self, out_neigh, d, group, sub);
}

template <typename T>
struct BlockFwdArgs {
  const T* src;
  const int32_t* self_pos;
  int64_t n_self;
  const int32_t* pos;
  const uint8_t* mask;
  int64_t n_neigh;
  int fanout;
  T* out_self;
  T* out_neigh;
  int d;
};

template <typename T, int FANOUT, int KIND, bool VEC>
void launch_block_fwd_as(const BlockFwdArgs<T>& a, cudaStream_t st) {
  const int lg = lanes_lg(VEC ? a.d / 4 : a.d);
  const int64_t rows = a.n_self > a.n_neigh ? a.n_self : a.n_neigh;
  const dim3 grid(static_cast<unsigned>(ceil_div(rows, kThreads >> lg)));
  block_gather_fwd_kernel<T, FANOUT, KIND, VEC><<<grid, kThreads, 0, st>>>(
      a.src, a.self_pos, a.n_self, a.pos, a.mask, a.n_neigh, a.fanout,
      a.out_self, a.out_neigh, a.d, lg);
}

template <typename T, int FANOUT, int KIND>
void launch_block_fwd_kind(const BlockFwdArgs<T>& a, bool vec, cudaStream_t st) {
  if (vec) {
    launch_block_fwd_as<T, FANOUT, KIND, true>(a, st);
  } else {
    launch_block_fwd_as<T, FANOUT, KIND, false>(a, st);
  }
}

template <typename T, int FANOUT>
void launch_block_fwd(const BlockFwdArgs<T>& a, int kind, bool vec, cudaStream_t st) {
  switch (kind) {
    case kMean: launch_block_fwd_kind<T, FANOUT, kMean>(a, vec, st); break;
    case kMax: launch_block_fwd_kind<T, FANOUT, kMax>(a, vec, st); break;
    default: launch_block_fwd_kind<T, FANOUT, kSum>(a, vec, st); break;
  }
}

// ---------------------------------------------------------------------------
// shared-memory staging: the TMA's 1-D bulk copy, completed on an mbarrier
// ---------------------------------------------------------------------------
// Without __CUDA_ARCH__ (nvcc's host pass, or a serial CPU build of this
// file) the copy is a byte loop and the barrier does nothing: the callers
// follow every wait with __syncthreads().

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
#ifdef __CUDA_ARCH__
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(bar));
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(a) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
#endif
}

// one thread: the barrier's phase completes once `bytes` have landed
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
#ifdef __CUDA_ARCH__
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(bar));
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(a), "r"(bytes)
               : "memory");
#endif
}

// dst (shared) and src (global) 16-byte aligned, bytes a multiple of 16
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
#ifdef __CUDA_ARCH__
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const uint32_t b = static_cast<uint32_t>(__cvta_generic_to_shared(bar));
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(d), "l"(src), "r"(bytes), "r"(b) : "memory");
#else
  for (uint32_t i = 0; i < bytes; ++i)
    static_cast<unsigned char*>(dst)[i] = static_cast<const unsigned char*>(src)[i];
#endif
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
#ifdef __CUDA_ARCH__
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(bar));
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  }
#endif
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ float shfl_xor(float v, int off) {
  return __shfl_xor_sync(0xffffffffu, v, off);
}
__device__ __forceinline__ float4 shfl_xor(const float4& v, int off) {
  return make_float4(shfl_xor(v.x, off), shfl_xor(v.y, off), shfl_xor(v.z, off),
                     shfl_xor(v.w, off));
}

// ---------------------------------------------------------------------------
// window reduction: the neighbor half alone at a fan-out with no unrolled
// instantiation (device inference's degree buckets, 32 to 4096 and more)
// ---------------------------------------------------------------------------

constexpr int kWinBatch = 8;      // slots a worker loads before it reduces
constexpr int kWinTile = 4096;    // slots of indices a CTA stages at a time

// Shared memory of a window CTA with R rows and `tile` slots a stage: the
// mbarrier (16 bytes), R x stride positions, R x stride mask bytes (stride =
// tile rounded up to 16, so every row's staging is 16-byte aligned), then a
// partial unit for each thread and a count for each warp.
inline int window_smem_bytes(int rows_per_cta, int tile) {
  const int stride = (tile + 15) & ~15;
  return 16 + 5 * rows_per_cta * stride + kThreads * 16 + kWarpsPerBlock * 4;
}

// out[row] = the masked sum / mean / max over src[pos[row, k]] (kind as in
// block_fwd_row), one row to 1 << wlg warps, 8 >> wlg rows a CTA.
//   * the row's positions and mask bytes, `tile` slots at a time, are staged
//     in shared memory: by 1-D bulk copies (cp.async.bulk, the TMA's 1-D
//     form) completed on an mbarrier where the global slice is 16-byte
//     aligned and a multiple of 16 bytes long, else by the CTA's threads
//     (the threads alone measured 3-12% slower at F = 4096, PERF.md);
//   * a group of G = 1 << lg lanes serves one unit column set (units sub,
//     sub + G, ... a pass); a row has (warps a row) x (32 / G) such
//     workers, and worker w takes the chunks of kWinBatch consecutive slots
//     w, w + workers, ...: so the valid slots, a prefix of the window in
//     every table inference builds, spread evenly over the workers;
//   * a worker reads a chunk's kWinBatch positions and masks from shared
//     memory, issues every valid slot's unit load, then reduces them: a lane
//     has up to kWinBatch loads in flight, and no index round trip to
//     global memory;
//   * the workers' partials are reduced in a fixed order, with no atomics:
//     a butterfly over the groups of a warp (__shfl_xor_sync), then the
//     row's warps 0, 1, ... through shared memory; the count of valid slots
//     likewise (mean divides by it, max writes 0 where it is 0);
//   * a table wider than a tile (F > kWinTile / rows a CTA) is staged tile
//     by tile; with more than G units a row, each pass re-reads the tiles.
// Every thread reaches every barrier: rows past the end take no slot.
template <typename T, int KIND, bool VEC>
__global__ void __launch_bounds__(kThreads)
window_reduce_kernel(const T* __restrict__ src, const int32_t* __restrict__ pos,
                     const uint8_t* __restrict__ mask, int64_t rows, int fanout,
                     T* __restrict__ out, int d, int lg, int wlg, int tile) {
  using Unit = UnitOf<T, VEC>;
  using Val = ValOf<VEC>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = kWarpsPerBlock >> wlg;
  const int stride = (tile + 15) & ~15;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  int32_t* pos_s = reinterpret_cast<int32_t*>(smem + 16);
  uint8_t* mask_s = smem + 16 + 4 * R * stride;
  Val* part = reinterpret_cast<Val*>(smem + 16 + 5 * R * stride);
  int* cnt_s = reinterpret_cast<int*>(smem + 16 + 5 * R * stride + kThreads * 16);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = warp >> wlg, wi = warp & ((1 << wlg) - 1);
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * R;
  const int rows_here = static_cast<int>(rows - row0 < R ? rows - row0 : R);
  const int64_t row = row0 + r;
  const bool has_row = r < rows_here;
  const int group = 1 << lg, sub = lane & (group - 1);
  const int workers = (1 << wlg) << (5 - lg);
  const int worker = (wi << (5 - lg)) + (lane >> lg);
  const int units = VEC ? d / 4 : d;
  const int32_t* ps = pos_s + r * stride;
  const uint8_t* ms = mask_s + r * stride;

  if (threadIdx.x == 0) mbar_init(bar);
  uint32_t phase = 0;
  // stage slots [t0, t0 + len) of the CTA's rows
  auto stage = [&](int t0, int len) {
    __syncthreads();    // the previous tile is read; the barrier is initialised
    // a row's slice goes by bulk copy where its global start is 16-byte
    // aligned and its length a multiple of 16 bytes
    auto pos_bulk = [&](int64_t off) { return aligned16(pos + off) && len % 4 == 0; };
    auto mask_bulk = [&](int64_t off) { return aligned16(mask + off) && len % 16 == 0; };
    uint32_t bulk = 0;
    for (int q = 0; q < rows_here; ++q) {
      const int64_t off = (row0 + q) * fanout + t0;
      bulk += (pos_bulk(off) ? 4u * len : 0u) + (mask_bulk(off) ? len : 0u);
    }
    if (threadIdx.x == 0 && bulk) {
      mbar_expect(bar, bulk);
      for (int q = 0; q < rows_here; ++q) {
        const int64_t off = (row0 + q) * fanout + t0;
        if (pos_bulk(off)) bulk_load(pos_s + q * stride, pos + off, 4u * len, bar);
        if (mask_bulk(off)) bulk_load(mask_s + q * stride, mask + off, len, bar);
      }
    }
    for (int q = 0; q < rows_here; ++q) {
      const int64_t off = (row0 + q) * fanout + t0;
      for (int k = threadIdx.x; k < len; k += kThreads) {
        if (!pos_bulk(off)) pos_s[q * stride + k] = __ldg(pos + off + k);
        if (!mask_bulk(off)) mask_s[q * stride + k] = __ldg(mask + off + k);
      }
    }
    if (bulk) {
      mbar_wait(bar, phase);
      phase ^= 1;
    }
    __syncthreads();
  };

  const bool one_tile = fanout <= tile;
  if (one_tile) stage(0, fanout);
  for (int base = 0; base < units; base += group) {
    const int i = base + sub;
    Val acc;
    splat(acc, KIND == kMax ? kNegInf : 0.f);
    int cnt = 0;
    for (int t0 = 0; t0 < fanout; t0 += tile) {
      const int len = fanout - t0 < tile ? fanout - t0 : tile;
      if (!one_tile) stage(t0, len);
      if (!has_row) continue;
      for (int c0 = worker * kWinBatch; c0 < len; c0 += workers * kWinBatch) {
        int32_t p[kWinBatch];
        bool m[kWinBatch];
#pragma unroll
        for (int j = 0; j < kWinBatch; ++j) {
          const int k = c0 + j;
          m[j] = k < len && ms[k] != 0;
          p[j] = m[j] ? ps[k] : 0;
        }
        Unit v[kWinBatch];
#pragma unroll
        for (int j = 0; j < kWinBatch; ++j)
          v[j] = m[j] && i < units ? __ldg(unit_row<T, VEC>(src, p[j], d) + i) : Unit{};
#pragma unroll
        for (int j = 0; j < kWinBatch; ++j) {
          cnt += m[j] ? 1 : 0;
          if (m[j]) reduce_to<KIND>(acc, widen(v[j]));
        }
      }
    }
    // the groups of a warp: a butterfly, the same order in every lane
    for (int off = group; off < kWarp; off <<= 1) {
      const Val o = shfl_xor(acc, off);
      cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
      reduce_to<KIND>(acc, o);
    }
    if (wlg > 0) {    // the row's warps, in order, through shared memory
      if (lane < group) part[warp * kWarp + lane] = acc;
      if (lane == 0) cnt_s[warp] = cnt;
      __syncthreads();
      if (wi == 0) {
        for (int w = 1; w < (1 << wlg); ++w) {
          if (lane < group) reduce_to<KIND>(acc, part[(warp + w) * kWarp + lane]);
          cnt += cnt_s[warp + w];
        }
      }
      __syncthreads();
    }
    if (has_row && wi == 0 && lane < group && i < units) {
      if (KIND == kMax && cnt == 0) acc = Val{};    // DGL's empty-mailbox zero
      if (KIND == kMean) acc = scaled(acc, cnt > 0 ? 1.f / static_cast<float>(cnt) : 1.f);
      st_unit(unit_row<T, VEC>(out, row, d) + i, acc);
    }
  }
}

template <typename T, int KIND>
void launch_window_kind(const T* src, const int32_t* pos, const uint8_t* mask, int64_t rows,
                        int fanout, T* out, int d, bool vec, int wlg, int lg, int tile,
                        int smem, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(ceil_div(rows, kWarpsPerBlock >> wlg)));
  if (vec) {
    window_reduce_kernel<T, KIND, true><<<grid, kThreads, smem, st>>>(
        src, pos, mask, rows, fanout, out, d, lg, wlg, tile);
  } else {
    window_reduce_kernel<T, KIND, false><<<grid, kThreads, smem, st>>>(
        src, pos, mask, rows, fanout, out, d, lg, wlg, tile);
  }
}

template <typename T>
int window_reduce(const void* src, const void* pos, const void* mask, int64_t rows, int fanout,
                  void* out, int d, int kind, bool vec, int wlg, int lg, int tile, int smem,
                  cudaStream_t st) {
  const T* s = static_cast<const T*>(src);
  const int32_t* p = static_cast<const int32_t*>(pos);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  T* o = static_cast<T*>(out);
  switch (kind) {
    case kMean: launch_window_kind<T, kMean>(s, p, m, rows, fanout, o, d, vec, wlg, lg, tile, smem, st); break;
    case kMax: launch_window_kind<T, kMax>(s, p, m, rows, fanout, o, d, vec, wlg, lg, tile, smem, st); break;
    default: launch_window_kind<T, kSum>(s, p, m, rows, fanout, o, d, vec, wlg, lg, tile, smem, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// layer-0 assembly
// ---------------------------------------------------------------------------

// Rows a group of lanes serves, in flight together.
constexpr int kRowsPerGroup = 4;

// s = src_row[r];  row = s >= 0 ? cache[s] : miss[-1 - s]
// out[r] = Out(float(row) (* scale for int8))
// The cache tiers: T is float, uint16_t (bf16) or int8_t; a unit is 4
// columns at every tier (16, 8 or 4 bytes), widened to a float4 in
// registers; int8 is then multiplied by its 4 per-column scales, one f32
// multiply a value, which is the IEEE result of the JAX package's
// dequantize_fused.  Out is float, or uint16_t: the f32 value rounded to
// bf16 (nearest even), which is that result cast by cast_apply.
// A group of 1 << lg lanes serves kRowsPerGroup consecutive rows: their
// indices first (one 16-byte load, one round trip), then one unit of each
// row (and the int8 scale unit, which needs no index and stays in L1), then
// the stores.  Each row waits for memory twice, index then data, and a lane
// has kRowsPerGroup units in flight; at D = 100 a warp serves 4 rows and
// the main path's 25,344 rows are 6,336 warps, one wave (32-40 registers a
// thread: 48-64 resident warps an SM).  A lane serves units sub, sub + G,
// ...: where a row has more units than the group has lanes (D > 128 on the
// unit path, D > 32 on the scalar one), each such pass loads before it
// stores.  VEC: 4-column units (D % 4 == 0, tables aligned to their unit);
// else one column a unit.
template <typename T, typename Out, bool VEC>
__global__ void __launch_bounds__(kThreads)
assemble_kernel(const T* __restrict__ cache, const T* __restrict__ miss,
                const int32_t* __restrict__ src_row,
                const float* __restrict__ scale,
                Out* __restrict__ out, int64_t n, int d, int lg) {
  using Unit = UnitOf<T, VEC>;
  using Val = ValOf<VEC>;
  constexpr bool kScale = std::is_same<T, int8_t>::value;
  constexpr int R = kRowsPerGroup;
  static_assert(R == 4, "a group's indices are one int4");
  const int64_t row0 =
      (static_cast<int64_t>(blockIdx.x) * (kThreads >> lg) + (threadIdx.x >> lg)) * R;
  if (row0 >= n) return;
  const int group = 1 << lg;
  const int sub = threadIdx.x & (group - 1);
  const int units = VEC ? d / 4 : d;
  // the indices, held as 32-bit values (a pointer each costs registers and
  // so resident warps).  Rows past n repeat row0's source row into the
  // padding rows of out
  int32_t s[R];
  if (row0 + R <= n && (reinterpret_cast<uintptr_t>(src_row) & 15) == 0) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(src_row + row0));
    s[0] = v.x; s[1] = v.y; s[2] = v.z; s[3] = v.w;
  } else {
    s[0] = __ldg(src_row + row0);
#pragma unroll
    for (int j = 1; j < R; ++j) s[j] = row0 + j < n ? __ldg(src_row + row0 + j) : s[0];
  }
  for (int i = sub; i < units; i += group) {
    Val f{};
    if constexpr (kScale) f = __ldg(reinterpret_cast<const Val*>(scale) + i);
    // No test on the loads or the stores: a load that only a conditional
    // store reads is sunk below the first store by the compiler.  The rows
    // are read with ld.global.cg (L2 only: each is read once), which ptxas
    // keeps ahead of the stores; it moves ld.global.nc (__ldg) behind them.
    Unit u[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const T* row = s[j] >= 0 ? cache + static_cast<int64_t>(s[j]) * d
                               : miss + (-1 - static_cast<int64_t>(s[j])) * d;
      u[j] = __ldcg(reinterpret_cast<const Unit*>(row) + i);
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      Val v = widen(u[j]);
      if constexpr (kScale) v = scaled(v, f);
      st_unit(unit_row<Out, VEC>(out, row0 + j, d) + i, v);
    }
  }
}

template <typename T, typename Out>
void launch_assemble(const void* cache, const void* miss, const int32_t* src_row,
                     const float* scale, void* out, int64_t n, int d, bool vec,
                     cudaStream_t st) {
  const int lg = lanes_lg(vec ? d / 4 : d);
  const dim3 grid(static_cast<unsigned>(ceil_div(n, (kThreads >> lg) * kRowsPerGroup)));
  const T* c = static_cast<const T*>(cache);
  const T* m = static_cast<const T*>(miss);
  Out* o = static_cast<Out*>(out);
  if (vec) {
    assemble_kernel<T, Out, true><<<grid, kThreads, 0, st>>>(c, m, src_row, scale, o, n, d, lg);
  } else {
    assemble_kernel<T, Out, false><<<grid, kThreads, 0, st>>>(c, m, src_row, scale, o, n, d, lg);
  }
}

template <typename T>
void launch_assemble_to(const void* cache, const void* miss, const int32_t* src_row,
                        const float* scale, void* out, int64_t n, int d, bool vec,
                        bool out_bf16, cudaStream_t st) {
  if (out_bf16) {
    launch_assemble<T, uint16_t>(cache, miss, src_row, scale, out, n, d, vec, st);
  } else {
    launch_assemble<T, float>(cache, miss, src_row, scale, out, n, d, vec, st);
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// Backward of a block's two gathers of one source table, into the f32 table
// grad that the caller zeroed:
//   grad[self_pos[r]]  += g_self[r]                      r < n_self
//   grad[pos[r, k]]    += g_neigh[r] / max(count_r, 1)   r < n_neigh, mask[r, k]
// (undivided for !MEAN), the gradients T (f32 or bf16) widened to f32.  A
// group of 1 << lg lanes serves one row.  Every load of a row (its indices,
// mask and both gradient units) is issued before its first reduction.
// Padded rows need no test: they carry a zero gradient (self_pos 0) and no
// valid slot.  The division is one f32 multiply by the row's reciprocal.
template <typename T, int FANOUT, bool MEAN, bool VEC>
__global__ void __launch_bounds__(kThreads)
block_gather_bwd_kernel(const T* __restrict__ g_self,
                        const int32_t* __restrict__ self_pos, int64_t n_self,
                        const T* __restrict__ g_neigh,
                        const int32_t* __restrict__ pos,
                        const uint8_t* __restrict__ mask, int64_t n_neigh,
                        int fanout_rt, float* __restrict__ grad, int d, int lg) {
  using Unit = UnitOf<T, VEC>;
  using Acc = UnitOf<float, VEC>;
  using Val = ValOf<VEC>;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads >> lg) + (threadIdx.x >> lg);
  const bool has_self = row < n_self, has_neigh = row < n_neigh;
  if (!has_self && !has_neigh) return;
  const int group = 1 << lg;
  const int sub = threadIdx.x & (group - 1);
  const int units = VEC ? d / 4 : d;
  const int F = FANOUT > 0 ? FANOUT : fanout_rt;
  const int32_t* p = pos + row * F;
  const uint8_t* m = mask + row * F;
  constexpr int kSlots = FANOUT > 0 ? FANOUT : 1;
  int32_t p_reg[kSlots];
  bool m_reg[kSlots];
  Acc* dst_self = has_self ? unit_row<float, VEC>(grad, self_pos[row], d) : nullptr;
  int count = 0;
#pragma unroll
  for (int k = 0; k < F; ++k) {
    const bool on = has_neigh && m[k] != 0;
    if (FANOUT > 0) {
      p_reg[k] = has_neigh ? p[k] : 0;
      m_reg[k] = on;
    }
    count += on ? 1 : 0;
  }
  const float s = MEAN && count > 0 ? 1.f / static_cast<float>(count) : 1.f;
  const Unit* gs = unit_row<T, VEC>(g_self, row, d);
  const Unit* gn = unit_row<T, VEC>(g_neigh, row, d);
  for (int i = sub; i < units; i += group) {
    const Val vs = has_self ? widen(__ldg(gs + i)) : Val{};
    Val vn = has_neigh ? widen(__ldg(gn + i)) : Val{};
    if (has_self) red_unit(dst_self + i, vs);
    if (MEAN) vn = scaled(vn, s);
#pragma unroll
    for (int k = 0; k < F; ++k) {
      const bool on = FANOUT > 0 ? m_reg[k] : has_neigh && m[k] != 0;
      const int32_t pk = FANOUT > 0 ? p_reg[k] : p[k];
      if (on) red_unit(unit_row<float, VEC>(grad, pk, d) + i, vn);
    }
  }
}

// Backward of the max kind, into the f32 table grad that the caller zeroed:
//   grad[self_pos[r]] += g_self[r]                                 r < n_self
//   grad[pos[r, k]]   += (src[pos[r,k]] == mx_r) ? g_neigh[r] / ties_r : 0
//                        per column, r < n_neigh, mask[r, k]
// where mx_r is the column's max over row r's valid slots and ties_r the
// number of valid slots equal to it: the gradient of JAX's jnp.max (and of
// torch's amax), which splits each output gradient equally among tied
// maxima.  A slot repeated in a row is a tie of its own each time, as a
// gathered message is.  The source rows are re-read: with FANOUT > 0 each
// valid slot's unit is loaded once into registers; the runtime fan-out
// (FANOUT == 0) reads the slots three times (max, ties, add).  A unit adds
// only where one of its columns is a tie (the others add 0).
template <typename T, int FANOUT, bool VEC>
__global__ void __launch_bounds__(kThreads)
block_gather_bwd_max_kernel(const T* __restrict__ src, const T* __restrict__ g_self,
                            const int32_t* __restrict__ self_pos, int64_t n_self,
                            const T* __restrict__ g_neigh,
                            const int32_t* __restrict__ pos,
                            const uint8_t* __restrict__ mask, int64_t n_neigh,
                            int fanout_rt, float* __restrict__ grad, int d, int lg) {
  using Unit = UnitOf<T, VEC>;
  using Acc = UnitOf<float, VEC>;
  using Val = ValOf<VEC>;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads >> lg) + (threadIdx.x >> lg);
  const bool has_self = row < n_self, has_neigh = row < n_neigh;
  if (!has_self && !has_neigh) return;
  const int group = 1 << lg;
  const int sub = threadIdx.x & (group - 1);
  const int units = VEC ? d / 4 : d;
  const int F = FANOUT > 0 ? FANOUT : fanout_rt;
  const int32_t* p = pos + row * F;
  const uint8_t* m = mask + row * F;
  constexpr int kSlots = FANOUT > 0 ? FANOUT : 1;
  int32_t p_reg[kSlots];
  bool m_reg[kSlots];
  bool any = false;
  if (FANOUT > 0) {
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      m_reg[k] = has_neigh && m[k] != 0;
      p_reg[k] = has_neigh ? p[k] : 0;
      any |= m_reg[k];
    }
  } else if (has_neigh) {
    for (int k = 0; k < F; ++k) any |= m[k] != 0;
  }
  Acc* dst_self = has_self ? unit_row<float, VEC>(grad, self_pos[row], d) : nullptr;
  const Unit* gs = unit_row<T, VEC>(g_self, row, d);
  const Unit* gn = unit_row<T, VEC>(g_neigh, row, d);
  for (int i = sub; i < units; i += group) {
    const Val vs = has_self ? widen(__ldg(gs + i)) : Val{};
    const Val g = any ? widen(__ldg(gn + i)) : Val{};
    if (has_self) red_unit(dst_self + i, vs);
    if (!any) continue;
    Val mx, ties{}, c;
    splat(mx, kNegInf);
    if (FANOUT > 0) {
      Val v[kSlots];
#pragma unroll
      for (int k = 0; k < kSlots; ++k)
        v[k] = m_reg[k] ? widen(__ldg(unit_row<T, VEC>(src, p_reg[k], d) + i)) : Val{};
#pragma unroll
      for (int k = 0; k < kSlots; ++k)
        if (m_reg[k]) max_to(mx, v[k]);
#pragma unroll
      for (int k = 0; k < kSlots; ++k)
        if (m_reg[k]) count_ties(ties, v[k], mx);
      const Val q = tie_share(g, ties);
#pragma unroll
      for (int k = 0; k < kSlots; ++k)
        if (m_reg[k] && tie_select(c, v[k], mx, q))
          red_unit(unit_row<float, VEC>(grad, p_reg[k], d) + i, c);
    } else {
      for (int k = 0; k < F; ++k)
        if (m[k]) max_to(mx, widen(__ldg(unit_row<T, VEC>(src, p[k], d) + i)));
      for (int k = 0; k < F; ++k)
        if (m[k]) count_ties(ties, widen(__ldg(unit_row<T, VEC>(src, p[k], d) + i)), mx);
      const Val q = tie_share(g, ties);
      for (int k = 0; k < F; ++k)
        if (m[k] && tie_select(c, widen(__ldg(unit_row<T, VEC>(src, p[k], d) + i)), mx, q))
          red_unit(unit_row<float, VEC>(grad, p[k], d) + i, c);
    }
  }
}

template <typename T>
struct BlockBwdArgs {
  const T* src;            // read by the max kind only
  const T* g_self;
  const int32_t* self_pos;
  int64_t n_self;
  const T* g_neigh;
  const int32_t* pos;
  const uint8_t* mask;
  int64_t n_neigh;
  int fanout;
  float* grad;
  int d;
};

template <typename T, int FANOUT, bool MEAN, bool VEC>
void launch_block_bwd_as(const BlockBwdArgs<T>& a, cudaStream_t st) {
  const int lg = lanes_lg(VEC ? a.d / 4 : a.d);
  const int64_t rows = a.n_self > a.n_neigh ? a.n_self : a.n_neigh;
  const dim3 grid(static_cast<unsigned>(ceil_div(rows, kThreads >> lg)));
  block_gather_bwd_kernel<T, FANOUT, MEAN, VEC><<<grid, kThreads, 0, st>>>(
      a.g_self, a.self_pos, a.n_self, a.g_neigh, a.pos, a.mask, a.n_neigh,
      a.fanout, a.grad, a.d, lg);
}

template <typename T, int FANOUT, bool VEC>
void launch_block_bwd_max_as(const BlockBwdArgs<T>& a, cudaStream_t st) {
  const int lg = lanes_lg(VEC ? a.d / 4 : a.d);
  const int64_t rows = a.n_self > a.n_neigh ? a.n_self : a.n_neigh;
  const dim3 grid(static_cast<unsigned>(ceil_div(rows, kThreads >> lg)));
  block_gather_bwd_max_kernel<T, FANOUT, VEC><<<grid, kThreads, 0, st>>>(
      a.src, a.g_self, a.self_pos, a.n_self, a.g_neigh, a.pos, a.mask, a.n_neigh,
      a.fanout, a.grad, a.d, lg);
}

template <typename T, int FANOUT>
void launch_block_bwd(const BlockBwdArgs<T>& a, int kind, bool vec, cudaStream_t st) {
  if (kind == kMax) {
    if (vec) {
      launch_block_bwd_max_as<T, FANOUT, true>(a, st);
    } else {
      launch_block_bwd_max_as<T, FANOUT, false>(a, st);
    }
  } else if (kind == kMean && vec) {
    launch_block_bwd_as<T, FANOUT, true, true>(a, st);
  } else if (kind == kMean) {
    launch_block_bwd_as<T, FANOUT, true, false>(a, st);
  } else if (vec) {
    launch_block_bwd_as<T, FANOUT, false, true>(a, st);
  } else {
    launch_block_bwd_as<T, FANOUT, false, false>(a, st);
  }
}

// out[i] = in[i] rounded to bf16 (nearest even) for n values: the f32
// gradient table to the bf16 one.  VEC: a float4 in, 8 bytes out a thread
// (n % 4 == 0, both tables aligned to their unit); a grid-stride loop.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
to_bf16_kernel(const float* __restrict__ in, uint16_t* __restrict__ out, int64_t n) {
  using Val = ValOf<VEC>;
  using Unit = UnitOf<uint16_t, VEC>;
  const int64_t units = VEC ? n / 4 : n;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < units;
       i += stride)
    st_unit(reinterpret_cast<Unit*>(out) + i, __ldcs(reinterpret_cast<const Val*>(in) + i));
}

void launch_to_bf16(const float* in, uint16_t* out, int64_t n, cudaStream_t st) {
  const bool vec = n % 4 == 0 && (reinterpret_cast<uintptr_t>(in) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 7) == 0;
  const int64_t blocks = ceil_div(vec ? n / 4 : n, kThreads);
  const dim3 grid(static_cast<unsigned>(blocks < 4096 ? (blocks > 0 ? blocks : 1) : 4096));
  if (vec) {
    to_bf16_kernel<true><<<grid, kThreads, 0, st>>>(in, out, n);
  } else {
    to_bf16_kernel<false><<<grid, kThreads, 0, st>>>(in, out, n);
  }
}

// ---------------------------------------------------------------------------
// scatter_add_rows: the self half of the backward alone, in one launch
// ---------------------------------------------------------------------------

constexpr int kCoopItems = 8;   // (row, unit) items a thread loads before the barrier

// out[s] = sum of g[r] over the r with ids[r] == s, for every s < num_src
// (0 where none), in one cooperative launch and no memset:
//   * every thread first loads its first kCoopItems (row, unit) items, item
//     w = thread + k * (threads of the grid), row w / units, unit w % units
//     (its id and its gradient unit, widened to f32), so their latency
//     overlaps what follows;
//   * the grid zeroes the f32 table (grid-stride, coalesced), then waits at
//     one grid barrier (cooperative_groups::this_grid().sync());
//   * each thread adds its items with one 16-byte reduction a unit
//     (red.global.add.v4.f32, scalar f32 reductions otherwise), then the
//     rest of its items in a grid-stride loop, as the block backward does;
//   * a bf16 table is the f32 scratch `acc`, rounded once into out after a
//     second grid barrier.
// Ids must be in [0, num_src); the reductions add in no fixed order.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
scatter_add_rows_kernel(const T* __restrict__ g, const int32_t* __restrict__ ids,
                        int64_t n, T* __restrict__ out, float* __restrict__ acc,
                        int64_t num_src, int d) {
  using Val = ValOf<VEC>;
  using Acc = UnitOf<float, VEC>;
  namespace cg = cooperative_groups;
  const int units = VEC ? d / 4 : d;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t items = n * units, cells = num_src * units;
  int32_t row[kCoopItems], col[kCoopItems];
  Val v[kCoopItems];
#pragma unroll
  for (int j = 0; j < kCoopItems; ++j) {
    const int64_t w = t + j * stride;
    const int64_t r = w < items ? w / units : 0;
    col[j] = w < items ? static_cast<int32_t>(w - r * units) : 0;
    row[j] = w < items ? __ldg(ids + r) : -1;
    v[j] = w < items ? widen(__ldg(unit_row<T, VEC>(g, r, d) + col[j])) : Val{};
  }
  Acc* table = reinterpret_cast<Acc*>(acc);
  for (int64_t k = t; k < cells; k += stride) table[k] = Acc{};
  cg::this_grid().sync();
#pragma unroll
  for (int j = 0; j < kCoopItems; ++j)
    if (row[j] >= 0) red_unit(unit_row<float, VEC>(acc, row[j], d) + col[j], v[j]);
  for (int64_t w = t + kCoopItems * stride; w < items; w += stride) {
    const int64_t r = w / units;
    const int i = static_cast<int>(w - r * units);
    red_unit(unit_row<float, VEC>(acc, __ldg(ids + r), d) + i,
             widen(__ldg(unit_row<T, VEC>(g, r, d) + i)));
  }
  if constexpr (!std::is_same<T, float>::value) {
    cg::this_grid().sync();
    UnitOf<T, VEC>* o = reinterpret_cast<UnitOf<T, VEC>*>(out);
    for (int64_t k = t; k < cells; k += stride) st_unit(o + k, __ldcg(table + k));
  }
}

template <typename T, bool VEC>
int launch_scatter(const T* g, const int32_t* ids, int64_t n, T* out, float* acc,
                   int64_t num_src, int d, int grid, cudaStream_t st) {
  auto kernel = &scatter_add_rows_kernel<T, VEC>;
  // a cooperative grid must be co-resident: refuse more CTAs than the card holds
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (grid > sms * per_sm) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, g, ids, n, out, acc, num_src, d));
}

// Fan-outs the samplers use get an unrolled instantiation; others run the
// runtime-fanout instantiation (FANOUT = 0).
#define PG_FANOUT_SWITCH(fanout, LAUNCH)          \
  switch (fanout) {                               \
    case 1: LAUNCH(1); break;                     \
    case 2: LAUNCH(2); break;                     \
    case 3: LAUNCH(3); break;                     \
    case 4: LAUNCH(4); break;                     \
    case 5: LAUNCH(5); break;                     \
    case 8: LAUNCH(8); break;                     \
    case 10: LAUNCH(10); break;                   \
    case 15: LAUNCH(15); break;                   \
    case 16: LAUNCH(16); break;                   \
    case 20: LAUNCH(20); break;                   \
    case 25: LAUNCH(25); break;                   \
    default: LAUNCH(0); break;                    \
  }

template <typename T>
int block_gather_fwd(const void* src, const void* self_pos, int64_t n_self,
                     const void* pos, const void* mask, int64_t n_neigh, int fanout,
                     void* out_self, void* out_neigh, int d, int kind, bool vec,
                     cudaStream_t st) {
  const BlockFwdArgs<T> a{static_cast<const T*>(src),
                          static_cast<const int32_t*>(self_pos), n_self,
                          static_cast<const int32_t*>(pos),
                          static_cast<const uint8_t*>(mask), n_neigh,
                          n_neigh > 0 ? fanout : 0,
                          static_cast<T*>(out_self), static_cast<T*>(out_neigh), d};
#define PG_LAUNCH_BLOCK_FWD(F) launch_block_fwd<T, F>(a, kind, vec, st)
  PG_FANOUT_SWITCH(a.fanout, PG_LAUNCH_BLOCK_FWD)
#undef PG_LAUNCH_BLOCK_FWD
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int block_gather_bwd(const void* src, const void* g_self, const void* self_pos,
                     int64_t n_self, const void* g_neigh, const void* pos,
                     const void* mask, int64_t n_neigh, int fanout, float* grad,
                     int64_t num_src, int d, int kind, bool vec, cudaStream_t st) {
  const cudaError_t rc = cudaMemsetAsync(
      grad, 0, static_cast<size_t>(num_src) * d * sizeof(float), st);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if ((n_self == 0 && n_neigh == 0) || d == 0) return static_cast<int>(cudaGetLastError());
  const BlockBwdArgs<T> a{static_cast<const T*>(src), static_cast<const T*>(g_self),
                          static_cast<const int32_t*>(self_pos), n_self,
                          static_cast<const T*>(g_neigh),
                          static_cast<const int32_t*>(pos),
                          static_cast<const uint8_t*>(mask), n_neigh,
                          n_neigh > 0 ? fanout : 0, grad, d};
#define PG_LAUNCH_BLOCK_BWD(F) launch_block_bwd<T, F>(a, kind, vec, st)
  PG_FANOUT_SWITCH(a.fanout, PG_LAUNCH_BLOCK_BWD)
#undef PG_LAUNCH_BLOCK_BWD
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// dropout and a prefix-layout block's two halves, forward and backward
// ---------------------------------------------------------------------------
// A prefix-layout block (the on-device sampler's) holds its n destinations'
// self rows as source rows [0, n) and destination r's fan-out messages as
// rows n + r * fanout + k: no gather, each source row feeds one output.  The
// pair below fuses inverted dropout (keep an element iff its bit of the
// packed keep-mask is set, then times inv_keep) into the block's self half
// and masked sum / mean, reading the source and its mask once; the backward
// is a pure map, each source row's gradient written once (no memset, no
// atomics).  Element e = row * D + col of the source is bit e % 32 of mask
// word e / 32 (pg_dropout_bits writes it).
//
// A W-element unit of a row (W = 4, 2 or 1: D % W == 0 and every table
// aligned to it) in memory, for the rows (float, uint16_t bf16).
template <typename T, int W> struct PackOf;
template <> struct PackOf<float, 4> { using type = float4; };
template <> struct PackOf<float, 2> { using type = float2; };
template <> struct PackOf<float, 1> { using type = float; };
template <> struct PackOf<uint16_t, 4> { using type = uint2; };
template <> struct PackOf<uint16_t, 2> { using type = unsigned int; };
template <> struct PackOf<uint16_t, 1> { using type = unsigned short; };

// The mask word that holds element e's bit.  The W elements of a unit from
// e (a multiple of W) share one word; a unit keeps its word in one register
// until use, when kept() picks element e + j's bit by e's low bits alone
// (e32: e modulo 2^32, recomputed then, not held).
__device__ __forceinline__ uint32_t keep_word(const uint32_t* __restrict__ keep, int64_t e) {
  return __ldg(keep + (e >> 5));
}

__device__ __forceinline__ bool kept(uint32_t word, uint32_t e32, int j) {
  return ((word >> ((e32 + j) & 31)) & 1u) != 0;
}

template <typename T, int W>
union Pack {
  typename PackOf<T, W>::type u;
  T e[W];
};

// unit i of a row, packed as it lies in memory: kept packed in registers
// until it is used (a bf16 unit of 4 takes 2 registers, not 4)
template <typename T, int W>
__device__ __forceinline__ Pack<T, W> load_pack(const T* __restrict__ row, int i) {
  Pack<T, W> p;
  p.u = __ldg(reinterpret_cast<const typename PackOf<T, W>::type*>(row) + i);
  return p;
}

template <typename T, int W>
__device__ __forceinline__ void unpack(const Pack<T, W>& p, float (&v)[W]) {
#pragma unroll
  for (int j = 0; j < W; ++j) v[j] = widen(p.e[j]);
}

// values already representable in T (rounded by round_to)
template <typename T, int W>
__device__ __forceinline__ void store_unit(T* __restrict__ row, int i, const float (&v)[W]) {
  Pack<T, W> p;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    if constexpr (std::is_same<T, float>::value) {
      p.e[j] = v[j];
    } else {
      p.e[j] = static_cast<uint16_t>(bf16_bits(v[j]));
    }
  }
  reinterpret_cast<typename PackOf<T, W>::type*>(row)[i] = p.u;
}

// v rounded to T (bf16: nearest even), as f32: where torch rounds one op's
// result at bf16, the kernels round the same value
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    return __uint_as_float(bf16_bits(v) << 16);
  }
}

// slots a row's mask word holds; slot k >= kMaskWord is read from memory
constexpr int kMaskWord = 64;
// message rows whose loads a lane issues before it adds them
constexpr int kDropChunk = 8;

__device__ __forceinline__ uint64_t mask_word(const uint8_t* __restrict__ m, int fanout,
                                              int* count) {
  uint64_t w = 0;
  int c = 0;
  for (int k = 0; k < fanout; ++k) {
    const bool on = __ldg(m + k) != 0;
    c += on ? 1 : 0;
    if (on && k < kMaskWord) w |= uint64_t{1} << k;
  }
  *count = c;
  return w;
}

__device__ __forceinline__ bool slot_on(uint64_t w, const uint8_t* __restrict__ m, int k) {
  return k < kMaskWord ? ((w >> k) & 1) != 0 : __ldg(m + k) != 0;
}

// Forward, one destination row r < n to a group of 1 << lg lanes (at most
// a warp), each lane its units i = sub, sub + G, ...:
//   drop(v) = kept ? round_T(v * inv_keep) : 0    (keep null: v)
//   out_self[r]  = drop(x[r])                        (out_self null: not written)
//   out_neigh[r] = sum_k mask[r,k] * drop(x[n + r * fanout + k]), k in order,
//                  in f32; for mean rounded to T, then divided by the count of
//                  valid slots and rounded again (a row with none: 0)
// which is the plain version's arithmetic up to the order of the sum (torch
// rounds the sum and the quotient at bf16 too).  The row's mask word comes
// first (one round trip); then a lane issues the self unit's loads and
// those of kDropChunk valid message rows (values and mask words) before its first
// store or add, and keeps them packed.  Masked slots load nothing.  Loading
// every slot regardless of the mask (no wait for it), and 64-256 lanes a
// row at D = 256 and 602, measured no faster (PERF.md).  f32 rows of
// 2-element units (D % 4 == 2: GCN's 602-wide block 0) ask for 4 blocks a
// SM, which holds them to 64 registers: unbounded they took 72 (3 blocks)
// and ran 12% slower there; the other units ran 1-26% slower under that
// cap (PERF.md).
template <typename T, int W>
__global__ void __launch_bounds__(kThreads, (sizeof(T) == 4 && W == 2) ? 4 : 1)
dropout_block_fwd_kernel(const T* __restrict__ x, const uint32_t* __restrict__ keep,
                         float inv_keep, const uint8_t* __restrict__ mask, int64_t n,
                         int fanout, int d, T* __restrict__ out_self,
                         T* __restrict__ out_neigh, int mean, int lg) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * (kThreads >> lg) + (threadIdx.x >> lg);
  if (r >= n) return;
  const int group = 1 << lg, sub = threadIdx.x & (group - 1);
  const uint8_t* m = mask + r * fanout;
  int count = 0;
  const uint64_t mw = mask_word(m, fanout, &count);
  const int64_t msg0 = n + r * fanout;
  const int units = d / W;
  const bool drop = keep != nullptr;
  // the low 32 bits of the first message row's and the self row's first elements
  const uint32_t msg_e32 = static_cast<uint32_t>(msg0 * d), self_e32 = static_cast<uint32_t>(r * d);
  for (int i = sub; i < units; i += group) {
    Pack<T, W> sx;
    uint32_t sb = 0;
    if (out_self != nullptr) {
      sx = load_pack<T, W>(x + r * d, i);
      if (drop) sb = keep_word(keep, r * d + i * W);
    }
    float acc[W];
#pragma unroll
    for (int j = 0; j < W; ++j) acc[j] = 0.f;
    for (int k0 = 0; k0 == 0 || k0 < fanout; k0 += kDropChunk) {    // once at fanout 0
      Pack<T, W> vx[kDropChunk];
      uint32_t vb[kDropChunk];
      bool on[kDropChunk];
#pragma unroll
      for (int c = 0; c < kDropChunk; ++c) {
        const int k = k0 + c;
        on[c] = k < fanout && slot_on(mw, m, k);
        vb[c] = 0;
        if (on[c]) {
          vx[c] = load_pack<T, W>(x + (msg0 + k) * d, i);
          if (drop) vb[c] = keep_word(keep, (msg0 + k) * d + i * W);
        }
      }
      if (k0 == 0 && out_self != nullptr) {
        float v[W];
        unpack<T, W>(sx, v);
        if (drop) {
#pragma unroll
          for (int j = 0; j < W; ++j)
            v[j] = kept(sb, self_e32 + i * W, j) ? round_to<T>(v[j] * inv_keep) : 0.f;
        }
        store_unit<T, W>(out_self + r * d, i, v);
      }
#pragma unroll
      for (int c = 0; c < kDropChunk; ++c) {
        if (!on[c]) continue;
        float v[W];
        unpack<T, W>(vx[c], v);
        const uint32_t e32 = msg_e32 + static_cast<uint32_t>((k0 + c) * d + i * W);
#pragma unroll
        for (int j = 0; j < W; ++j)
          acc[j] += !drop ? v[j] : kept(vb[c], e32, j) ? round_to<T>(v[j] * inv_keep) : 0.f;
      }
    }
    if (mean && count > 0) {
#pragma unroll
      for (int j = 0; j < W; ++j)
        acc[j] = round_to<T>(round_to<T>(acc[j]) / static_cast<float>(count));
    }
    store_unit<T, W>(out_neigh + r * d, i, acc);
  }
}

// Backward w.r.t. x [num_src, d], one destination row r < n to a group of
// lanes, writing its self row and its fan-out message rows; groups r >= n
// zero the rows past the block's n * (1 + fanout), 1 + fanout each:
//   grad[r]                 = kept ? round_T(g_self[r] * inv_keep) : 0
//   grad[n + r * fanout + k] = mask[r,k] && kept ? round_T(q * inv_keep) : 0,
//     q = g_neigh[r], for mean round_T(g_neigh[r] / count)
// (keep null: every element is kept and nothing is multiplied; a null
// gradient is zero), which is autograd's arithmetic over the plain version
// exactly.  A lane issues its gradients' and kDropChunk rows' mask-word
// loads before its first store; masked slots and a null g_self load none.
template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
dropout_block_bwd_kernel(const T* __restrict__ g_self, const T* __restrict__ g_neigh,
                         const uint32_t* __restrict__ keep, float inv_keep,
                         const uint8_t* __restrict__ mask, int64_t n, int fanout,
                         int64_t num_src, int d, T* __restrict__ grad, int mean, int lg) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * (kThreads >> lg) + (threadIdx.x >> lg);
  const int64_t span = 1 + fanout, body = n * span;
  const int64_t groups = n + (num_src > body ? (num_src - body + span - 1) / span : 0);
  if (r >= groups) return;
  const int group = 1 << lg, sub = threadIdx.x & (group - 1);
  const int units = d / W;
  float zero[W];
#pragma unroll
  for (int j = 0; j < W; ++j) zero[j] = 0.f;
  if (r >= n) {    // rows no destination reads
    const int64_t first = body + (r - n) * span;
    const int64_t last = first + span < num_src ? first + span : num_src;
    for (int64_t row = first; row < last; ++row)
      for (int i = sub; i < units; i += group) store_unit<T, W>(grad + row * d, i, zero);
    return;
  }
  const uint8_t* m = mask + r * fanout;
  int count = 0;
  const uint64_t mw = mask_word(m, fanout, &count);
  const int64_t msg0 = n + r * fanout;
  const bool drop = keep != nullptr;
  const uint32_t msg_e32 = static_cast<uint32_t>(msg0 * d), self_e32 = static_cast<uint32_t>(r * d);
  for (int i = sub; i < units; i += group) {
    Pack<T, W> gs, gn;
    uint32_t sb = 0;
    if (g_self != nullptr) {
      gs = load_pack<T, W>(g_self + r * d, i);
      if (drop) sb = keep_word(keep, r * d + i * W);
    }
    if (g_neigh != nullptr) gn = load_pack<T, W>(g_neigh + r * d, i);
    for (int k0 = 0; k0 == 0 || k0 < fanout; k0 += kDropChunk) {    // once at fanout 0
      uint32_t vb[kDropChunk];
      bool on[kDropChunk];
#pragma unroll
      for (int c = 0; c < kDropChunk; ++c) {
        const int k = k0 + c;
        on[c] = k < fanout && slot_on(mw, m, k);
        vb[c] = on[c] && drop ? keep_word(keep, (msg0 + k) * d + i * W) : 0u;
      }
      if (k0 == 0) {
        float v[W];
        if (g_self != nullptr) {
          unpack<T, W>(gs, v);
          if (drop) {
#pragma unroll
            for (int j = 0; j < W; ++j)
              v[j] = kept(sb, self_e32 + i * W, j) ? round_to<T>(v[j] * inv_keep) : 0.f;
          }
        } else {
#pragma unroll
          for (int j = 0; j < W; ++j) v[j] = 0.f;
        }
        store_unit<T, W>(grad + r * d, i, v);
      }
      float q[W];
      if (g_neigh != nullptr) {
        unpack<T, W>(gn, q);
        if (mean && count > 0) {
#pragma unroll
          for (int j = 0; j < W; ++j) q[j] = round_to<T>(q[j] / static_cast<float>(count));
        }
      } else {
#pragma unroll
        for (int j = 0; j < W; ++j) q[j] = 0.f;
      }
#pragma unroll
      for (int c = 0; c < kDropChunk; ++c) {
        if (k0 + c >= fanout) break;
        float o[W];
        const uint32_t e32 = msg_e32 + static_cast<uint32_t>((k0 + c) * d + i * W);
#pragma unroll
        for (int j = 0; j < W; ++j)
          o[j] = !on[c] ? 0.f
                 : !drop ? q[j]
                 : kept(vb[c], e32, j) ? round_to<T>(q[j] * inv_keep) : 0.f;
        store_unit<T, W>(grad + (msg0 + k0 + c) * d, i, o);
      }
    }
  }
}

template <typename T, int W>
int launch_dropout_block(bool backward, const void* x_or_gself, const void* g_neigh,
                         const uint32_t* keep, float inv_keep, const uint8_t* mask,
                         int64_t n, int fanout, int64_t num_src, int d, void* out_self,
                         void* out, int mean, cudaStream_t st) {
  const int lg = lanes_lg(d / W);
  const int64_t span = 1 + fanout, body = n * span;
  const int64_t groups =
      backward ? n + (num_src > body ? ceil_div(num_src - body, span) : 0) : n;
  if (groups == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid(static_cast<unsigned>(ceil_div(groups, kThreads >> lg)));
  if (backward) {
    dropout_block_bwd_kernel<T, W><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(x_or_gself), static_cast<const T*>(g_neigh), keep, inv_keep,
        mask, n, fanout, num_src, d, static_cast<T*>(out), mean, lg);
  } else {
    dropout_block_fwd_kernel<T, W><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(x_or_gself), keep, inv_keep, mask, n, fanout, d,
        static_cast<T*>(out_self), static_cast<T*>(out), mean, lg);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dropout_block(bool backward, const void* a, const void* g_neigh, const void* keep,
                  float inv_keep, const void* mask, int64_t n, int fanout, int64_t num_src,
                  int d, void* out_self, void* out, int mean, int unit, cudaStream_t st) {
  const uint32_t* b = static_cast<const uint32_t*>(keep);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  switch (unit) {
    case 4: return launch_dropout_block<T, 4>(backward, a, g_neigh, b, inv_keep, m, n, fanout,
                                              num_src, d, out_self, out, mean, st);
    case 2: return launch_dropout_block<T, 2>(backward, a, g_neigh, b, inv_keep, m, n, fanout,
                                              num_src, d, out_self, out, mean, st);
    default: return launch_dropout_block<T, 1>(backward, a, g_neigh, b, inv_keep, m, n, fanout,
                                               num_src, d, out_self, out, mean, st);
  }
}

// ---------------------------------------------------------------------------
// the dropout keep-mask: torch.randint's Philox units, one bit each
// ---------------------------------------------------------------------------
// The block pair above reads a keep-mask of a bit an element: element li is
// kept iff unit li of torch.randint(-2^15, 2^15, shape, int16) from the
// model's generator is below thresh - 2^15, the units the benchmark's
// reference redraws.  ATen's own draw (DistributionTemplates.h, the 32-bit
// path of random_from_to_kernel) pays a 64-bit modulo a unit and a
// __syncthreads() an iteration and writes two bytes a unit.
// pg_dropout_bits writes the same decisions, a bit a unit, from the same
// Philox units:
//
//   * which Philox output a unit takes must be torch's, or the units
//     differ.  ATen launches grid = min(ceil(n / 256), SMs *
//     maxThreadsPerSM / 256) blocks of 256 (the wrapper reads both from the
//     device as ATen does); with stride = 256 * grid, thread t = li mod
//     stride calls curand_init(seed, t, offset) and its k-th curand4
//     (k = li / (4 * stride)) gives unit li = t + stride * (4k + ii) in
//     component ii < 4.  That curand4 is Philox4x32-10 of the 128-bit
//     counter t * 2^64 + offset / 4 + k under the key (seed low, seed high)
//     (skipahead_sequence adds t to the counter's upper half, skipahead
//     offset / 4 to its lower; torch's offsets are multiples of 4), so the
//     kernel computes it directly, once a counter, with curand's rounds and
//     constants;
//   * the unit is the output's low 16 bits moved down by 2^15 (65,536
//     divides 2^32: the modulo is a mask), kept iff below thresh - 2^15, so
//     kept iff low16 < thresh (the JAX package's uint16 threshold);
//   * which thread computes a counter is free.  Units t = 32g .. 32g + 31
//     of one (k, ii) are mask word g + stride / 32 * (4k + ii), bit t - 32g,
//     so one thread takes the item (g, k): the 32 counters of subsequences
//     32g .. 32g + 31 at k, whose four outputs fill four words in its
//     registers, one bit a counter each, with no vote and no barrier; the
//     threads of a warp take consecutive g and store their words
//     coalesced.  Where there are few items (small draws) P = 2..32 lanes
//     share one, 32 / P counters each, their words OR-ed by shuffles.
//     ATen's own thread mapping with a __ballot_sync a word measured 0.180
//     ms at the SAGE cell's block 0 (108 M units), against 0.093 this way
//     (PERF.md);
//   * the counters of one item share their lower half (offset / 4 + k), so
//     round 1's product of it is taken once an item;
//   * seed and offset: kernel arguments for an eager draw; under CUDA-graph
//     capture `state` (two uint64 words on the device, the generator's seed
//     and offset, written before each replay by pg_dropout_bits_state) plus
//     the draw's offset within the graph, so a replay draws what the eager
//     form would from the generator's state at that replay.
//
// What bounds it: Philox's integer multiplies, ten rounds of two 32 x 32 ->
// 64-bit products (a low and a high half each) for four units; the write is
// n / 8 bytes.  At most 32 registers a thread (8 blocks of 256 a SM).

constexpr int kDrawThreads = 256;    // ATen's block: the stride's unit
constexpr int kBitsThreads = 256;    // this kernel's block
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u, kPhiloxW1 = 0xBB67AE85u;
constexpr uint32_t kPhiloxM0 = 0xD2511F53u, kPhiloxM1 = 0xCD9E8D57u;

// keep[w] for w < ceil(n / 32): item = (g, k) over `groups` = stride / 32
// word groups and k < iters, `items` of them, 1 << LG lanes an item
template <int LG>
__global__ void __launch_bounds__(kBitsThreads, 8)
dropout_bits_kernel(uint32_t* __restrict__ keep, int64_t n, uint32_t thresh,
                    const uint64_t* __restrict__ state, uint64_t seed, uint64_t offset,
                    uint32_t groups, uint32_t items) {
  constexpr int P = 1 << LG, J = kWarp >> LG;
  if (state != nullptr) {
    seed = state[0];
    offset += state[1];
  }
  const uint2 key = make_uint2(static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32));
  const uint64_t base = offset >> 2;
  const int64_t words = (n + 31) >> 5;
  const int lane = threadIdx.x & (kWarp - 1), part = lane & (P - 1);
  const unsigned mates = P == kWarp ? 0xffffffffu : ((1u << P) - 1u) << (lane & ~(P - 1));
  const uint32_t step = gridDim.x * (kBitsThreads / P);
  for (uint32_t item = (blockIdx.x * kBitsThreads + threadIdx.x) / P; item < items;
       item += step) {
    const uint32_t k = item / groups, g = item - k * groups;
    const uint64_t lo = base + k;
    const uint32_t x = static_cast<uint32_t>(lo), y = static_cast<uint32_t>(lo >> 32);
    const uint32_t lo0 = kPhiloxM0 * x, hi0 = __umulhi(kPhiloxM0, x);
    // the subsequence, plus the counter's carry (t < 2^32: its upper word 0)
    const uint32_t t0 = kWarp * g + J * part + (lo < base ? 1u : 0u);
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll 4
    for (int j = 0; j < J; ++j) {
      const uint32_t t = t0 + j;
      uint4 c = make_uint4(__umulhi(kPhiloxM1, t) ^ y ^ key.x, kPhiloxM1 * t, hi0 ^ key.y, lo0);
      uint2 kk = key;
#pragma unroll
      for (int round = 1; round < 10; ++round) {
        kk.x += kPhiloxW0;
        kk.y += kPhiloxW1;
        const uint32_t a0 = kPhiloxM0 * c.x, b0 = __umulhi(kPhiloxM0, c.x);
        const uint32_t a1 = kPhiloxM1 * c.z, b1 = __umulhi(kPhiloxM1, c.z);
        c = make_uint4(b1 ^ c.y ^ kk.x, a1, b0 ^ c.w ^ kk.y, a0);
      }
      const uint32_t bit = 1u << (J * part + j);
      if ((c.x & 0xffffu) < thresh) w[0] |= bit;
      if ((c.y & 0xffffu) < thresh) w[1] |= bit;
      if ((c.z & 0xffffu) < thresh) w[2] |= bit;
      if ((c.w & 0xffffu) < thresh) w[3] |= bit;
    }
#pragma unroll
    for (int s = 1; s < P; s <<= 1) {
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) w[ii] |= __shfl_xor_sync(mates, w[ii], s);
    }
    if (part == 0) {
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int64_t word = g + static_cast<int64_t>(groups) * (4 * k + ii);
        if (word >= words) break;
        const int64_t left = n - 32 * word;    // this word's units below n
        keep[word] = left < 32 ? w[ii] & ((1u << left) - 1u) : w[ii];
      }
    }
  }
}

__global__ void dropout_bits_state_kernel(uint64_t* __restrict__ state, uint64_t seed,
                                          uint64_t offset) {
  state[0] = seed;
  state[1] = offset;
}

}  // namespace

extern "C" {

// Both outputs of a block's forward in one launch on the caller's stream:
// out_self [n_self, d] = src[self_pos] and out_neigh [n_neigh, d] = the
// masked reduction of src over pos/mask [n_neigh, fanout] of kind kind (0
// sum, 1 mean, 2 max: 0 for a row with no valid slot), all at the element
// type dtype (0 f32, 1 bf16).  An absent half has null pointers and 0 rows
// (the self half: self_pos, out_self, n_self; the neighbor half: pos, mask,
// out_neigh, n_neigh, and then fanout and kind are ignored).
int pg_block_gather_fwd(const void* src, const void* self_pos, int64_t n_self,
                        const void* pos, const void* mask, int64_t n_neigh,
                        int fanout, void* out_self, void* out_neigh, int d,
                        int kind, int vec, int dtype, void* stream) {
  if ((n_self == 0 && n_neigh == 0) || d == 0) return static_cast<int>(cudaGetLastError());
  if (kind < kSum || kind > kMax) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return block_gather_fwd<float>(src, self_pos, n_self, pos, mask, n_neigh, fanout,
                                           out_self, out_neigh, d, kind, vec != 0, st);
    case 1: return block_gather_fwd<uint16_t>(src, self_pos, n_self, pos, mask, n_neigh,
                                              fanout, out_self, out_neigh, d, kind,
                                              vec != 0, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Layer-0 features out [n, d] in one launch on the caller's stream (out has
// room for n rounded up to a multiple of 4 rows, and the padding rows are
// written too): row r from cache_values[s] when s = src_row[r] >= 0, else
// from miss_feats[-1 - s], widened to f32 (tier 0 f32, 1 bf16, 2 int8) and,
// for int8, multiplied by scale [d]; written as f32, or (out_bf16 != 0) as
// bf16 rounded to nearest even.  scale is ignored (may be null) for the
// other tiers; miss_feats may be null when no src_row is negative.
int pg_assemble(const void* cache_values, const void* miss_feats,
                const void* src_row, const void* scale, void* out, int64_t n,
                int d, int tier, int vec, int out_bf16, void* stream) {
  if (n == 0 || d == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* sr = static_cast<const int32_t*>(src_row);
  const float* sc = static_cast<const float*>(scale);
  const bool v = vec != 0, ob = out_bf16 != 0;
  switch (tier) {
    case 0: launch_assemble_to<float>(cache_values, miss_feats, sr, sc, out, n, d, v, ob, st); break;
    case 1: launch_assemble_to<uint16_t>(cache_values, miss_feats, sr, sc, out, n, d, v, ob, st); break;
    case 2: launch_assemble_to<int8_t>(cache_values, miss_feats, sr, sc, out, n, d, v, ob, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Zero the f32 table [num_src, d] and add both halves of a block's backward
// into it, in one memset and one launch on the caller's stream, from
// gradients of the element type dtype (0 f32, 1 bf16) for the reduction
// kind (0 sum, 1 mean, 2 max).  The max kind also reads the block's source
// table src [num_src, d] (same element type), to find each row's maxima;
// the others ignore src (may be null).  At f32 that table is grad_src and
// grad_f32 is ignored (may be null); at bf16 it is the scratch grad_f32,
// which a second launch then rounds into the bf16 table grad_src.  An
// absent half has null pointers and 0 rows (the self half: g_self,
// self_pos, n_self; the neighbor half: g_neigh, pos, mask, n_neigh, and
// then fanout and kind are ignored).
int pg_block_gather_bwd(const void* src, const void* g_self, const void* self_pos,
                        int64_t n_self, const void* g_neigh, const void* pos,
                        const void* mask, int64_t n_neigh, int fanout, void* grad_src,
                        void* grad_f32, int64_t num_src, int d, int kind, int vec,
                        int dtype, void* stream) {
  if (kind < kSum || kind > kMax || (kind == kMax && n_neigh > 0 && src == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return block_gather_bwd<float>(src, g_self, self_pos, n_self, g_neigh, pos, mask,
                                           n_neigh, fanout, static_cast<float*>(grad_src),
                                           num_src, d, kind, vec != 0, st);
    case 1: {
      float* acc = static_cast<float*>(grad_f32);
      const int rc = block_gather_bwd<uint16_t>(src, g_self, self_pos, n_self, g_neigh, pos,
                                                mask, n_neigh, fanout, acc, num_src, d,
                                                kind, vec != 0, st);
      if (rc != cudaSuccess || num_src * d == 0) return rc;
      launch_to_bf16(acc, static_cast<uint16_t*>(grad_src), num_src * d, st);
      return static_cast<int>(cudaGetLastError());
    }
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out [rows, d] = the masked reduction of kind kind (0 sum, 1 mean, 2 max: 0
// for a row with no valid slot) of src over pos/mask [rows, fanout], at the
// element type dtype (0 f32, 1 bf16), in one launch on the caller's stream:
// the window reduction, 1 << wlg warps a row (wlg 0..3), 1 << lg lanes a
// worker (lg 0..5), staging `tile` slots a row at a time (1 <= tile <=
// kWinTile >> (3 - wlg)) in `smem` bytes of dynamic shared memory (at
// least window_smem_bytes, at most 48 KB).
int pg_window_reduce(const void* src, const void* pos, const void* mask, int64_t rows,
                     int fanout, void* out, int d, int kind, int vec, int dtype, int wlg,
                     int lg, int tile, int smem, void* stream) {
  if (rows == 0 || d == 0) return static_cast<int>(cudaGetLastError());
  const int rows_per_cta = kWarpsPerBlock >> (wlg < 0 || wlg > 3 ? 0 : wlg);
  if (kind < kSum || kind > kMax || wlg < 0 || wlg > 3 || lg < 0 || lg > 5 || fanout < 0 ||
      tile < 1 ||
      tile > kWinTile / rows_per_cta || smem < window_smem_bytes(rows_per_cta, tile) ||
      smem > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return window_reduce<float>(src, pos, mask, rows, fanout, out, d, kind, vec != 0,
                                        wlg, lg, tile, smem, st);
    case 1: return window_reduce<uint16_t>(src, pos, mask, rows, fanout, out, d, kind,
                                           vec != 0, wlg, lg, tile, smem, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out [num_src, d] = the zeroed table with g[r] [n, d] added at row ids[r],
// at the element type dtype (0 f32, 1 bf16: summed in the f32 scratch acc
// [num_src, d], then rounded once; acc is ignored at f32), in one
// cooperative launch of `grid` CTAs (at most what the card holds at once)
// on the caller's stream, with no memset.
int pg_scatter_add_rows(const void* g, const void* ids, int64_t n, void* out, void* acc,
                        int64_t num_src, int d, int vec, int dtype, int grid, void* stream) {
  if (num_src == 0 || d == 0) return static_cast<int>(cudaGetLastError());
  if (grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* it = static_cast<const int32_t*>(ids);
  switch (dtype) {
    case 0: {
      const float* gt = static_cast<const float*>(g);
      float* o = static_cast<float*>(out);
      return vec ? launch_scatter<float, true>(gt, it, n, o, o, num_src, d, grid, st)
                 : launch_scatter<float, false>(gt, it, n, o, o, num_src, d, grid, st);
    }
    case 1: {
      if (acc == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      const uint16_t* gt = static_cast<const uint16_t*>(g);
      uint16_t* o = static_cast<uint16_t*>(out);
      float* a = static_cast<float*>(acc);
      return vec ? launch_scatter<uint16_t, true>(gt, it, n, o, a, num_src, d, grid, st)
                 : launch_scatter<uint16_t, false>(gt, it, n, o, a, num_src, d, grid, st);
    }
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}


// The fused dropout and prefix-layout block forward in one launch on the
// caller's stream: x [n * (1 + fanout) or more, d] (its first n rows the
// destinations' self rows, then fanout message rows each), keep the packed
// keep-mask of x's elements, ceil(numel / 32) uint32 words (null: no
// dropout; inv_keep ignored), mask bool [n, fanout]; out_neigh [n, d] the
// masked sum (kind 0) or mean (kind 1) of the dropped-out messages,
// out_self [n, d] the dropped-out self rows (null: not written); rows and
// outputs at the element type dtype (0 f32, 1 bf16), in units of `unit`
// elements (4, 2 or 1: d a multiple, every table aligned).
int pg_dropout_block_fwd(const void* x, const void* keep, float inv_keep, const void* mask,
                         int64_t n, int fanout, int d, void* out_self, void* out_neigh,
                         int kind, int unit, int dtype, void* stream) {
  if (kind != kSum && kind != kMean) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || d == 0) return static_cast<int>(cudaGetLastError());
  if (d % unit != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int mean = kind == kMean;
  switch (dtype) {
    case 0: return dropout_block<float>(false, x, nullptr, keep, inv_keep, mask, n, fanout, 0,
                                        d, out_self, out_neigh, mean, unit, st);
    case 1: return dropout_block<uint16_t>(false, x, nullptr, keep, inv_keep, mask, n, fanout,
                                           0, d, out_self, out_neigh, mean, unit, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Its backward: grad [num_src, d] (num_src >= n * (1 + fanout)), every row
// written once, from g_self and g_neigh [n, d] (either null: zero), the
// forward's keep-mask, mask, inv_keep, kind, unit and dtype, in one launch
// on the caller's stream.
int pg_dropout_block_bwd(const void* g_self, const void* g_neigh, const void* keep,
                         float inv_keep, const void* mask, int64_t n, int fanout,
                         int64_t num_src, int d, void* grad, int kind, int unit, int dtype,
                         void* stream) {
  if (kind != kSum && kind != kMean) return static_cast<int>(cudaErrorInvalidValue);
  if (num_src < n * (1 + static_cast<int64_t>(fanout))) return static_cast<int>(cudaErrorInvalidValue);
  if (num_src == 0 || d == 0) return static_cast<int>(cudaGetLastError());
  if (d % unit != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int mean = kind == kMean;
  switch (dtype) {
    case 0: return dropout_block<float>(true, g_self, g_neigh, keep, inv_keep, mask, n, fanout,
                                        num_src, d, nullptr, grad, mean, unit, st);
    case 1: return dropout_block<uint16_t>(true, g_self, g_neigh, keep, inv_keep, mask, n,
                                           fanout, num_src, d, nullptr, grad, mean, unit, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The packed keep-mask of an n-unit dropout draw on the caller's stream:
// keep [ceil(n / 32)] uint32, bit li % 32 of word li / 32 set iff unit li of
// torch.randint's draw from (seed, offset) with ATen's grid of `grid` blocks
// of 256 is kept (its low 16 bits below thresh, 1..65535).  With `state`
// (uint64 [2] on the device: seed, base offset) the kernel reads the seed
// from it and adds its base to `offset`.  offset must be a multiple of 4,
// grid at least 1, n at most 2^30; `sms` (the card's SMs) sizes the launch.
int pg_dropout_bits(void* keep, int64_t n, int thresh, const void* state, uint64_t seed,
                    uint64_t offset, int grid, int sms, void* stream) {
  if (n < 0 || n > (int64_t{1} << 30) || grid < 1 || sms < 1 || thresh < 1 || thresh > 65535 ||
      offset % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const int64_t stride = static_cast<int64_t>(grid) * kDrawThreads;
  const int64_t iters = (n - 1) / (stride * 4) + 1;
  const int64_t groups = stride / kWarp, items = groups * iters;
  // lanes an item: the fewest that give a draw at least 2 blocks a SM
  int lg = 0;
  while (lg < 5 && (items << lg) < static_cast<int64_t>(sms) * 2 * kBitsThreads) ++lg;
  const int64_t blocks = std::min<int64_t>(((items << lg) + kBitsThreads - 1) / kBitsThreads,
                                           static_cast<int64_t>(sms) * 32);
  uint32_t* k = static_cast<uint32_t*>(keep);
  const uint64_t* st = static_cast<const uint64_t*>(state);
  const uint32_t th = static_cast<uint32_t>(thresh);
  const uint32_t gr = static_cast<uint32_t>(groups), it = static_cast<uint32_t>(items);
  const dim3 b(static_cast<unsigned>(blocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lg) {
    case 0: dropout_bits_kernel<0><<<b, kBitsThreads, 0, s>>>(k, n, th, st, seed, offset, gr, it); break;
    case 1: dropout_bits_kernel<1><<<b, kBitsThreads, 0, s>>>(k, n, th, st, seed, offset, gr, it); break;
    case 2: dropout_bits_kernel<2><<<b, kBitsThreads, 0, s>>>(k, n, th, st, seed, offset, gr, it); break;
    case 3: dropout_bits_kernel<3><<<b, kBitsThreads, 0, s>>>(k, n, th, st, seed, offset, gr, it); break;
    case 4: dropout_bits_kernel<4><<<b, kBitsThreads, 0, s>>>(k, n, th, st, seed, offset, gr, it); break;
    default: dropout_bits_kernel<5><<<b, kBitsThreads, 0, s>>>(k, n, th, st, seed, offset, gr, it); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// state[0] = seed, state[1] = offset (uint64 [2] on the device), one
// one-thread launch on the caller's stream: what a replay of a graph whose
// dropout_bits_kernel nodes read `state` draws from.
int pg_dropout_bits_state(void* state, uint64_t seed, uint64_t offset, void* stream) {
  dropout_bits_state_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint64_t*>(state), seed, offset);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

namespace {

// ---------------------------------------------------------------------------
// GAT attention on prefix-layout blocks
// ---------------------------------------------------------------------------
// One destination row r < n and one head k (blockIdx.y) to a warp: the warp
// reads the head's slice of the self row z[r] and of each valid neighbor row
// z[n + r * fanout + j], each once.  Lane l holds units l, l + 32, ... of the
// slice (NU of them, W = 4 or 1 floats each; hd % W == 0, so no unit crosses
// a head),
// and a score is a dot product summed over the warp by xor shuffles, after
// which every lane holds it.
//
// Forward, per (r, k), with s = a_s . z_r and t_j = a_n . z_j:
//   e_self = lrelu(s + t_r), e_j = lrelu(s + t_j) for the valid slots j,
//   m = max(e_self, e_j), den = exp(e_self - m) + sum_j exp(e_j - m),
//   out[r, k] = (exp(e_self - m) z_r + sum_j exp(e_j - m) z_j) / den,
// the masked two-part softmax of models/gat.py, in one pass over the slots:
// kGatChunk slots' loads are issued before their first shuffle, and the
// running max, denominator and sum are rescaled when a chunk raises the max
// (an online softmax).  stats[0, r, k] = m and stats[1, r, k] = den are kept
// for the backward.
//
// Backward, per (r, k), from g = dL/dout[r, k], the forward's output and
// stats: alpha_j = exp(e_j - m) / den, S = g . out[r, k] (= sum_j alpha_j
// g . z_j), and for each edge (the self edge alike)
//   dpre_j = alpha_j (g . z_j - S) lrelu'(pre_j)
//   dz_j   = alpha_j g + dpre_j a_n                 (0 for a masked slot)
//   dz_r   = alpha_self g + (sum of all dpre) a_s + dpre_self a_n
//   da_s  += (sum of all dpre) z_r,  da_n += sum over the edges of dpre_j z_j
// in one pass: every z row of the block is read once and its gradient row
// written once (the self rows and the slots tile z: no memset, no atomics;
// rows past n * (1 + fanout), which no destination reads, are zeroed by a
// memset).  The warps of a head walk its rows with a stride, keeping their
// da partials in registers; a CTA sums its warps' in shared memory in warp
// order into partial[k, blockIdx.x], and a second kernel in the same call
// sums those in CTA order: a replay gives the same bits.
//
// What bounds them: bytes.  At the cell's block 0 (681,472 rows of 512 f32)
// the forward reads z once (1.40 GB) and the backward reads z and writes its
// gradient (2.79 GB); a score is 2 FLOPs an element.

constexpr int kGatChunk = 8;

template <int W, int NU>
__device__ __forceinline__ void load_head(const float* __restrict__ p, int uh, int lane,
                                          float (&v)[NU][W]) {
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    const int i = lane + u * kWarp;
    if (i < uh) {
      const Pack<float, W> q = load_pack<float, W>(p, i);
#pragma unroll
      for (int j = 0; j < W; ++j) v[u][j] = q.e[j];
    } else {
#pragma unroll
      for (int j = 0; j < W; ++j) v[u][j] = 0.f;
    }
  }
}

template <int W, int NU>
__device__ __forceinline__ void store_head(float* __restrict__ p, int uh, int lane,
                                           const float (&v)[NU][W]) {
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    const int i = lane + u * kWarp;
    if (i < uh) {
      Pack<float, W> q;
#pragma unroll
      for (int j = 0; j < W; ++j) q.e[j] = v[u][j];
      reinterpret_cast<typename PackOf<float, W>::type*>(p)[i] = q.u;
    }
  }
}

template <int W, int NU>
__device__ __forceinline__ float dot_head(const float (&a)[NU][W], const float (&b)[NU][W]) {
  float s = 0.f;
#pragma unroll
  for (int u = 0; u < NU; ++u)
#pragma unroll
    for (int j = 0; j < W; ++j) s = fmaf(a[u][j], b[u][j], s);
  return s;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float lrelu(float x) { return x > 0.f ? x : 0.2f * x; }
__device__ __forceinline__ float lrelu_grad(float x) { return x > 0.f ? 1.f : 0.2f; }

template <int W, int NU>
__global__ void __launch_bounds__(kThreads)
gat_attention_fwd_kernel(const float* __restrict__ z, const float* __restrict__ a_s,
                         const float* __restrict__ a_n, const uint8_t* __restrict__ mask,
                         int64_t n, int fanout, int heads, int hd, float* __restrict__ out,
                         float* __restrict__ stats) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= n) return;
  const int lane = threadIdx.x & (kWarp - 1), k = blockIdx.y, uh = hd / W;
  const int64_t kh = static_cast<int64_t>(heads) * hd, col = static_cast<int64_t>(k) * hd;
  const uint8_t* m = mask + r * fanout;
  int count = 0;
  const uint64_t mw = mask_word(m, fanout, &count);
  float as[NU][W], an[NU][W], acc[NU][W];
  load_head<W, NU>(a_s + col, uh, lane, as);
  load_head<W, NU>(a_n + col, uh, lane, an);
  load_head<W, NU>(z + r * kh + col, uh, lane, acc);
  const float s = warp_sum(dot_head<W, NU>(acc, as));
  float mx = lrelu(s + warp_sum(dot_head<W, NU>(acc, an)));
  float den = 1.f;    // the self edge's exp(e_self - m) at m = e_self; acc = its z
  const int64_t msg0 = n + r * fanout;
  for (int k0 = 0; k0 < fanout; k0 += kGatChunk) {
    float v[kGatChunk][NU][W];
    bool on[kGatChunk];
#pragma unroll
    for (int c = 0; c < kGatChunk; ++c) {
      on[c] = k0 + c < fanout && slot_on(mw, m, k0 + c);
      if (on[c]) load_head<W, NU>(z + (msg0 + k0 + c) * kh + col, uh, lane, v[c]);
    }
    float e[kGatChunk];
    float cmax = mx;
#pragma unroll
    for (int c = 0; c < kGatChunk; ++c) {    // on[c] is the same for the whole warp
      e[c] = on[c] ? lrelu(s + warp_sum(dot_head<W, NU>(v[c], an))) : 0.f;
      if (on[c]) cmax = fmaxf(cmax, e[c]);
    }
    if (cmax > mx) {
      const float sc = expf(mx - cmax);
      den *= sc;
#pragma unroll
      for (int u = 0; u < NU; ++u)
#pragma unroll
        for (int j = 0; j < W; ++j) acc[u][j] *= sc;
      mx = cmax;
    }
#pragma unroll
    for (int c = 0; c < kGatChunk; ++c) {
      if (!on[c]) continue;
      const float w = expf(e[c] - mx);
      den += w;
#pragma unroll
      for (int u = 0; u < NU; ++u)
#pragma unroll
        for (int j = 0; j < W; ++j) acc[u][j] = fmaf(w, v[c][u][j], acc[u][j]);
    }
  }
#pragma unroll
  for (int u = 0; u < NU; ++u)
#pragma unroll
    for (int j = 0; j < W; ++j) acc[u][j] /= den;
  store_head<W, NU>(out + r * kh + col, uh, lane, acc);
  if (lane == 0) {
    stats[r * heads + k] = mx;
    stats[(n + r) * heads + k] = den;
  }
}

template <int W, int NU>
__global__ void __launch_bounds__(kThreads)
gat_attention_bwd_kernel(const float* __restrict__ z, const float* __restrict__ a_s,
                         const float* __restrict__ a_n, const uint8_t* __restrict__ mask,
                         const float* __restrict__ out, const float* __restrict__ stats,
                         const float* __restrict__ g, int64_t n, int fanout, int heads, int hd,
                         float* __restrict__ dz, float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);    // [kWarpsPerBlock][2][hd]
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x >> 5;
  const int k = blockIdx.y, uh = hd / W;
  const int64_t kh = static_cast<int64_t>(heads) * hd, col = static_cast<int64_t>(k) * hd;
  float as[NU][W], an[NU][W], das[NU][W], dan[NU][W];
  load_head<W, NU>(a_s + col, uh, lane, as);
  load_head<W, NU>(a_n + col, uh, lane, an);
#pragma unroll
  for (int u = 0; u < NU; ++u)
#pragma unroll
    for (int j = 0; j < W; ++j) das[u][j] = dan[u][j] = 0.f;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp; r < n;
       r += stride) {
    const uint8_t* m = mask + r * fanout;
    int count = 0;
    const uint64_t mw = mask_word(m, fanout, &count);
    float zs[NU][W], gg[NU][W], oo[NU][W];
    load_head<W, NU>(z + r * kh + col, uh, lane, zs);
    load_head<W, NU>(g + r * kh + col, uh, lane, gg);
    load_head<W, NU>(out + r * kh + col, uh, lane, oo);
    const float mx = stats[r * heads + k], den = stats[(n + r) * heads + k];
    const float s = warp_sum(dot_head<W, NU>(zs, as));
    const float pre_s = s + warp_sum(dot_head<W, NU>(zs, an));
    const float big_s = warp_sum(dot_head<W, NU>(gg, oo));
    const float al_s = expf(lrelu(pre_s) - mx) / den;
    const float dp_s = al_s * (warp_sum(dot_head<W, NU>(gg, zs)) - big_s) * lrelu_grad(pre_s);
    float dsum = dp_s;
#pragma unroll
    for (int u = 0; u < NU; ++u)
#pragma unroll
      for (int j = 0; j < W; ++j) dan[u][j] = fmaf(dp_s, zs[u][j], dan[u][j]);
    const int64_t msg0 = n + r * fanout;
    for (int k0 = 0; k0 < fanout; k0 += kGatChunk) {
      float v[kGatChunk][NU][W];
      bool on[kGatChunk];
#pragma unroll
      for (int c = 0; c < kGatChunk; ++c) {
        on[c] = k0 + c < fanout && slot_on(mw, m, k0 + c);
        if (on[c]) load_head<W, NU>(z + (msg0 + k0 + c) * kh + col, uh, lane, v[c]);
      }
#pragma unroll
      for (int c = 0; c < kGatChunk; ++c) {
        if (k0 + c >= fanout) break;
        float o[NU][W];
        if (on[c]) {    // the same for the whole warp
          const float pre = s + warp_sum(dot_head<W, NU>(v[c], an));
          const float gz = warp_sum(dot_head<W, NU>(gg, v[c]));
          const float al = expf(lrelu(pre) - mx) / den;
          const float dp = al * (gz - big_s) * lrelu_grad(pre);
          dsum += dp;
#pragma unroll
          for (int u = 0; u < NU; ++u)
#pragma unroll
            for (int j = 0; j < W; ++j) {
              o[u][j] = fmaf(dp, an[u][j], al * gg[u][j]);
              dan[u][j] = fmaf(dp, v[c][u][j], dan[u][j]);
            }
        } else {
#pragma unroll
          for (int u = 0; u < NU; ++u)
#pragma unroll
            for (int j = 0; j < W; ++j) o[u][j] = 0.f;
        }
        store_head<W, NU>(dz + (msg0 + k0 + c) * kh + col, uh, lane, o);
      }
    }
    float o[NU][W];
#pragma unroll
    for (int u = 0; u < NU; ++u)
#pragma unroll
      for (int j = 0; j < W; ++j) {
        o[u][j] = fmaf(dp_s, an[u][j], fmaf(dsum, as[u][j], al_s * gg[u][j]));
        das[u][j] = fmaf(dsum, zs[u][j], das[u][j]);
      }
    store_head<W, NU>(dz + r * kh + col, uh, lane, o);
  }
  // the CTA's partial of da_s and da_n: its warps' summed in warp order
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    const int i = lane + u * kWarp;
    if (i >= uh) continue;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      red[(warp * 2) * hd + i * W + j] = das[u][j];
      red[(warp * 2 + 1) * hd + i * W + j] = dan[u][j];
    }
  }
  __syncthreads();
  float* part = partial + (static_cast<int64_t>(k) * gridDim.x + blockIdx.x) * 2 * hd;
  for (int t = threadIdx.x; t < 2 * hd; t += kThreads) {
    float sum = 0.f;
    for (int w = 0; w < kWarpsPerBlock; ++w) sum += red[w * 2 * hd + t];
    part[t] = sum;
  }
}

// da [2, heads, hd] (da_s, then da_n): partial [heads, ctas, 2, hd] summed
// over the CTAs, a warp an entry: lane l adds CTAs l, l + 32, ... in order,
// then the warp's fixed shuffle tree.
__global__ void __launch_bounds__(kThreads)
gat_attention_bwd_reduce_kernel(const float* __restrict__ partial, int ctas, int heads, int hd,
                                float* __restrict__ da) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (e >= 2LL * heads * hd) return;
  const int lane = threadIdx.x & (kWarp - 1);
  const int k = static_cast<int>(e / (2 * hd)), t = static_cast<int>(e % (2 * hd));
  float sum = 0.f;
  for (int c = lane; c < ctas; c += kWarp)
    sum += partial[(static_cast<int64_t>(k) * ctas + c) * 2 * hd + t];
  sum = warp_sum(sum);
  if (lane == 0) da[(static_cast<int64_t>(t / hd) * heads + k) * hd + t % hd] = sum;
}

struct GatArgs {
  const float *z, *a_s, *a_n, *out, *stats, *g;
  const uint8_t* mask;
  int64_t n, num_src;
  int fanout, heads, hd, ctas;
  float *res, *res_stats, *dz, *da, *partial;
};

template <int W, int NU>
int launch_gat_attention(bool backward, const GatArgs& a, cudaStream_t st) {
  if (!backward) {
    const dim3 grid(static_cast<unsigned>(ceil_div(a.n, kWarpsPerBlock)),
                    static_cast<unsigned>(a.heads));
    gat_attention_fwd_kernel<W, NU><<<grid, kThreads, 0, st>>>(
        a.z, a.a_s, a.a_n, a.mask, a.n, a.fanout, a.heads, a.hd, a.res, a.res_stats);
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t kh = static_cast<int64_t>(a.heads) * a.hd;
  const int64_t body = a.n * (1 + static_cast<int64_t>(a.fanout));
  if (a.num_src > body) {
    const cudaError_t rc = cudaMemsetAsync(a.dz + body * kh, 0,
                                           (a.num_src - body) * kh * sizeof(float), st);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const size_t smem = sizeof(float) * kWarpsPerBlock * 2 * a.hd;
  gat_attention_bwd_kernel<W, NU>
      <<<dim3(static_cast<unsigned>(a.ctas), static_cast<unsigned>(a.heads)), kThreads, smem,
         st>>>(a.z, a.a_s, a.a_n, a.mask, a.out, a.stats, a.g, a.n, a.fanout, a.heads, a.hd,
               a.dz, a.partial);
  const cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int64_t entries = 2LL * a.heads * a.hd;
  gat_attention_bwd_reduce_kernel<<<static_cast<unsigned>(ceil_div(entries, kWarpsPerBlock)),
                                    kThreads, 0, st>>>(a.partial, a.ctas, a.heads, a.hd, a.da);
  return static_cast<int>(cudaGetLastError());
}

template <int W>
int gat_attention_nu(bool backward, const GatArgs& a, cudaStream_t st) {
  switch (ceil_div(a.hd / W, kWarp)) {
    case 1: return launch_gat_attention<W, 1>(backward, a, st);
    case 2: return launch_gat_attention<W, 2>(backward, a, st);
    case 3:
    case 4: return launch_gat_attention<W, 4>(backward, a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int gat_attention(bool backward, const GatArgs& a, int unit, void* stream) {
  if (a.hd <= 0 || a.heads <= 0 || a.hd % unit != 0 || a.fanout < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!backward && a.n == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (unit) {
    case 4: return gat_attention_nu<4>(backward, a, st);
    case 1: return gat_attention_nu<1>(backward, a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// GAT's attention over a prefix-layout block in one launch on the caller's
// stream: z f32 [n * (1 + fanout) or more, heads * hd] (its first n rows the
// destinations' own, then fanout slot rows each), a_s and a_n f32 [heads,
// hd], mask bool [n, fanout]; out f32 [n, heads, hd] and stats f32 [2, n,
// heads] (each row and head's max logit, then its softmax denominator), in
// units of `unit` floats (4 or 1: hd a multiple, every table aligned; at
// most 4 units a lane, hd <= 128 * unit).
int pg_gat_attention_fwd(const void* z, const void* a_s, const void* a_n, const void* mask,
                         int64_t n, int fanout, int heads, int hd, void* out, void* stats,
                         int unit, void* stream) {
  GatArgs a{};
  a.z = static_cast<const float*>(z);
  a.a_s = static_cast<const float*>(a_s);
  a.a_n = static_cast<const float*>(a_n);
  a.mask = static_cast<const uint8_t*>(mask);
  a.n = n;
  a.fanout = fanout;
  a.heads = heads;
  a.hd = hd;
  a.res = static_cast<float*>(out);
  a.res_stats = static_cast<float*>(stats);
  return gat_attention(false, a, unit, stream);
}

// Its backward from g f32 [n, heads, hd] and the forward's out and stats:
// dz f32 [num_src, heads * hd] (every row written once), da f32 [2, heads,
// hd] (the gradients of a_s, then a_n), in two launches and, where num_src >
// n * (1 + fanout), a memset of the rows past them, on the caller's stream;
// partial f32 [heads, ctas, 2, hd] is scratch, ctas the CTAs a head.
int pg_gat_attention_bwd(const void* z, const void* a_s, const void* a_n, const void* mask,
                         const void* out, const void* stats, const void* g, int64_t n,
                         int fanout, int64_t num_src, int heads, int hd, void* dz, void* da,
                         void* partial, int ctas, int unit, void* stream) {
  if (ctas < 1 || num_src < n * (1 + static_cast<int64_t>(fanout)))
    return static_cast<int>(cudaErrorInvalidValue);
  GatArgs a{};
  a.z = static_cast<const float*>(z);
  a.a_s = static_cast<const float*>(a_s);
  a.a_n = static_cast<const float*>(a_n);
  a.mask = static_cast<const uint8_t*>(mask);
  a.out = static_cast<const float*>(out);
  a.stats = static_cast<const float*>(stats);
  a.g = static_cast<const float*>(g);
  a.n = n;
  a.num_src = num_src;
  a.fanout = fanout;
  a.heads = heads;
  a.hd = hd;
  a.ctas = ctas;
  a.dz = static_cast<float*>(dz);
  a.da = static_cast<float*>(da);
  a.partial = static_cast<float*>(partial);
  return gat_attention(true, a, unit, stream);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// phase marks
// ---------------------------------------------------------------------------
// One empty kernel a phase of a train step (one thread, no memory touched),
// launched where the phase starts: a profiler's trace names it verbatim
// (extern "C", no template), so the kernels between two marks belong to the
// first one's phase, inside a replayed CUDA graph too.  A graph captured
// with its marks holds one kernel node each; pg_graph_find_marks finds them
// once (by the node's function) and pg_graph_enable_nodes enables or
// disables them in the graph's executable between replays, so an untraced
// replay runs none.

extern "C" {
__global__ void pg_mark_epoch() {}
__global__ void pg_mark_sample() {}
__global__ void pg_mark_fetch() {}
__global__ void pg_mark_forward() {}
__global__ void pg_mark_backward() {}
__global__ void pg_mark_sync() {}
__global__ void pg_mark_optimizer() {}
__global__ void pg_mark_accumulate() {}
__global__ void pg_mark_epoch_end() {}
}  // extern "C"

namespace {

// the marker of each phase code: the order of MARK_PHASES in ops/gather_kernels.py
void (*const kMarks[])() = {pg_mark_epoch,    pg_mark_sample,    pg_mark_fetch,
                            pg_mark_forward,  pg_mark_backward,  pg_mark_sync,
                            pg_mark_optimizer, pg_mark_accumulate, pg_mark_epoch_end};
constexpr int kNumMarks = sizeof(kMarks) / sizeof(kMarks[0]);

bool is_mark(const void* func) {
  for (auto m : kMarks)
    if (func == reinterpret_cast<const void*>(m)) return true;
  return false;
}

}  // namespace

extern "C" {

// The marker of phase code `phase` on the caller's stream (one launch).
int pg_mark(int phase, void* stream) {
  if (phase < 0 || phase >= kNumMarks) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaLaunchKernel(reinterpret_cast<const void*>(kMarks[phase]),
                                           dim3(1), dim3(1), nullptr, 0,
                                           static_cast<cudaStream_t>(stream)));
}

// *n = the number of nodes of the cudaGraph_t `graph`.
int pg_graph_num_nodes(void* graph, int64_t* n) {
  size_t count = 0;
  const cudaError_t rc = cudaGraphGetNodes(static_cast<cudaGraph_t>(graph), nullptr, &count);
  *n = static_cast<int64_t>(count);
  return static_cast<int>(rc);
}

// The kernel nodes of `graph` whose function is a marker: the first `cap`
// into nodes, their number into *found.  A kernel node of another library's
// module may refuse its parameters to this runtime: it is no marker, and the
// error it leaves is cleared.
int pg_graph_find_marks(void* graph, void** nodes, int64_t cap, int64_t* found) {
  const cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  size_t count = 0;
  cudaError_t rc = cudaGraphGetNodes(g, nullptr, &count);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  cudaGraphNode_t* all = new cudaGraphNode_t[count > 0 ? count : 1];
  rc = cudaGraphGetNodes(g, all, &count);
  int64_t k = 0;
  for (size_t i = 0; rc == cudaSuccess && i < count; ++i) {
    cudaGraphNodeType type;
    if (cudaGraphNodeGetType(all[i], &type) != cudaSuccess || type != cudaGraphNodeTypeKernel)
      continue;
    cudaKernelNodeParams p;
    if (cudaGraphKernelNodeGetParams(all[i], &p) != cudaSuccess || !is_mark(p.func)) continue;
    if (k < cap) nodes[k] = all[i];
    ++k;
  }
  delete[] all;
  cudaGetLastError();
  *found = k;
  return static_cast<int>(rc);
}

// Enable (enable != 0) or disable the n nodes of the executable graph
// `exec`, for its launches from now on.
int pg_graph_enable_nodes(void* exec, void* const* nodes, int64_t n, int enable) {
  for (int64_t i = 0; i < n; ++i) {
    const cudaError_t rc = cudaGraphNodeSetEnabled(static_cast<cudaGraphExec_t>(exec),
                                                   static_cast<cudaGraphNode_t>(nodes[i]),
                                                   enable ? 1u : 0u);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  return static_cast<int>(cudaSuccess);
}

}  // extern "C"
