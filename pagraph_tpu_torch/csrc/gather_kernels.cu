// Row-gather and fused gather + masked fan-out reduction kernels for Hopper
// (sm_90a), with the one scatter-add kernel that is the backward of both.
//
// What they replace (the two Pallas TPU kernels of the JAX package):
//   * pg_gather_rows, pg_assemble_from_map  <- gather_rows_pallas
//     (pagraph_tpu/ops/pallas_gather.py:58, body _gather_rows_kernel :29).
//     pg_assemble_from_map also folds in the two-source cache hit/miss
//     selection that pagraph_tpu/storage/cache.py assemble_features_from_map
//     leaves to XLA.
//   * pg_gather_reduce                      <- gather_mean_pallas
//     (pagraph_tpu/ops/pallas_gather.py:132, body _gather_sum_kernel :86),
//     with a 'sum' kind beside 'mean'.
//   * pg_block_gather_bwd: the backward of both.  The Pallas kernels are
//     forward-only (JAX differentiates jnp.take); the port trains through
//     these kernels, so their gradient is a kernel too.  A GraphSAGE block
//     gathers the same source table twice (its self rows and its neighbor
//     mean), so one launch takes both incoming gradients and writes the one
//     gradient table; either half may be absent, which makes it the
//     backward of one gather alone.
//
// What bounds them: device-memory bytes, not FLOPs.  A row gather does no
// arithmetic; the reduction does fanout adds per output element.  The least
// traffic is the index bytes + the gathered-row bytes + the output bytes,
// each once.  For the block backward: the indices, both incoming gradients
// and the gradient table written once -- for block 1 of the main path
// (6000 rows, fan-out 2, D = 32, a [14592, 32] table) about 3.5 MB, about
// 1.0 us at 3.35 TB/s.  That is what chip_smoke.py's bound_ms counts.
//
// What the design does about it:
//   * forwards: one warp per output row, so the 32 lanes read one source
//     row together: with D % 4 == 0 and 16-byte-aligned tables every lane
//     moves a float4, i.e. each row is read in coalesced 16-byte
//     transactions (D = 100 is 25 float4s, D = 32 is 8); otherwise a scalar
//     loop over the row;
//   * masked fan-out slots are never loaded (as in the Pallas kernel, where
//     invalid slots start no DMA), and the fan-out loop is unrolled with
//     the fan-out as a template parameter;
//   * the two-source assembly reads each output row from exactly one table,
//     in one launch, instead of gathering both and selecting;
//   * the block backward is small (a ~2 MB table that stays in the 50 MB
//     L2) and so bound by issue and launches, not by device memory: it
//     zeroes the table with cudaMemsetAsync and runs one kernel, in one C
//     call on the caller's stream (no fill kernel, no second scatter
//     kernel, no add of two gradient tables); a group of G lanes serves one
//     row (G the smallest power of two >= D/4, at most 32: at D = 32, 4 rows
//     a warp), loads the row's indices once, reads the incoming gradients
//     as float4 and adds them with 16-byte vector reductions
//     (atomicAdd(float4*), red.global.add.v4.f32 on sm_90) when D % 4 == 0
//     and the tables are 16-byte aligned, else with scalar f32 reductions;
//     the mean's division is one reciprocal per row.
//
// Interface: plain C, loaded with ctypes.  Pointers and the stream are void*;
// sizes are int64_t / int.  Kernels run on the caller's stream, allocate
// nothing and do not synchronize.  Each entry point returns
// cudaGetLastError() so a refused launch is reported to the caller.
// Indices must be in range; the Python wrappers check shapes, dtypes,
// devices and contiguity.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarp * kWarpsPerBlock;

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
}

__device__ __forceinline__ int64_t warp_row() {
  return static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
}

template <bool VEC>
__device__ __forceinline__ void copy_row(const float* __restrict__ s,
                                         float* __restrict__ o, int d, int lane) {
  if (VEC) {
    const float4* s4 = reinterpret_cast<const float4*>(s);
    float4* o4 = reinterpret_cast<float4*>(o);
    for (int i = lane; i < d / 4; i += kWarp) o4[i] = __ldg(s4 + i);
  } else {
    for (int i = lane; i < d; i += kWarp) o[i] = __ldg(s + i);
  }
}

template <bool VEC>
__device__ __forceinline__ void zero_row(float* __restrict__ o, int d, int lane) {
  if (VEC) {
    float4* o4 = reinterpret_cast<float4*>(o);
    for (int i = lane; i < d / 4; i += kWarp) o4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (int i = lane; i < d; i += kWarp) o[i] = 0.f;
  }
}

// K1: out[r] = src[ids[r]]
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float* __restrict__ src, const int32_t* __restrict__ ids,
                   float* __restrict__ out, int64_t n, int d) {
  const int64_t row = warp_row();
  if (row >= n) return;
  const int lane = threadIdx.x % kWarp;
  copy_row<VEC>(src + static_cast<int64_t>(ids[row]) * d, out + row * d, d, lane);
}

// K1, two sources: pos = cache_map[nids[r]];
// out[r] = pos >= 0 ? cache_values[pos] : miss_feats[miss_slot[r]]
// (zeros when there are no miss rows at all: only padded rows get there).
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
assemble_kernel(const float* __restrict__ cache_values,
                const int32_t* __restrict__ cache_map,
                const int32_t* __restrict__ nids,
                const int32_t* __restrict__ miss_slot,
                const float* __restrict__ miss_feats,
                float* __restrict__ out, int64_t n, int d, int64_t n_miss_rows) {
  const int64_t row = warp_row();
  if (row >= n) return;
  const int lane = threadIdx.x % kWarp;
  const int32_t pos = cache_map[nids[row]];
  float* o = out + row * d;
  if (pos >= 0) {
    copy_row<VEC>(cache_values + static_cast<int64_t>(pos) * d, o, d, lane);
  } else if (n_miss_rows > 0) {
    copy_row<VEC>(miss_feats + static_cast<int64_t>(miss_slot[row]) * d, o, d, lane);
  } else {
    zero_row<VEC>(o, d, lane);
  }
}

// K2: out[r] = sum_k mask[r,k] * src[pos[r,k]]  (divided by max(count, 1)
// for MEAN).  FANOUT == 0 means the fan-out is the runtime value.
template <int FANOUT, bool MEAN, bool VEC>
__global__ void __launch_bounds__(kThreads)
gather_reduce_kernel(const float* __restrict__ src, const int32_t* __restrict__ pos,
                     const uint8_t* __restrict__ mask, float* __restrict__ out,
                     int64_t n, int fanout_rt, int d) {
  const int64_t row = warp_row();
  if (row >= n) return;
  const int lane = threadIdx.x % kWarp;
  const int F = FANOUT > 0 ? FANOUT : fanout_rt;
  const int32_t* p = pos + row * F;
  const uint8_t* m = mask + row * F;
  int count = 0;
#pragma unroll
  for (int k = 0; k < F; ++k) count += m[k] ? 1 : 0;
  const float denom = static_cast<float>(count > 1 ? count : 1);
  float* o = out + row * d;
  if (VEC) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* o4 = reinterpret_cast<float4*>(o);
    const int d4 = d / 4;
    for (int i = lane; i < d4; i += kWarp) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < F; ++k) {
        if (m[k]) add4(acc, __ldg(s4 + static_cast<int64_t>(p[k]) * d4 + i));
      }
      if (MEAN) {
        acc.x /= denom; acc.y /= denom; acc.z /= denom; acc.w /= denom;
      }
      o4[i] = acc;
    }
  } else {
    for (int i = lane; i < d; i += kWarp) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < F; ++k) {
        if (m[k]) acc += __ldg(src + static_cast<int64_t>(p[k]) * d + i);
      }
      o[i] = MEAN ? acc / denom : acc;
    }
  }
}

// 16-byte vector reduction to global memory.  sm_90 declares atomicAdd for
// float4 (global memory only); with the result unused it compiles to a
// reduction (RED), not a fetch-and-add.
__device__ __forceinline__ void red4(float* dst, const float4& v) {
  atomicAdd(reinterpret_cast<float4*>(dst), v);
}

__device__ __forceinline__ float4 scale4(float4 v, float s) {
  v.x *= s; v.y *= s; v.z *= s; v.w *= s;
  return v;
}

// Backward of a block's two gathers of one source table, into grad_src that
// the caller zeroed:
//   grad_src[self_pos[r]]  += g_self[r]                      r < n_self
//   grad_src[pos[r, k]]    += g_neigh[r] / max(count_r, 1)   r < n_neigh, mask[r, k]
// (undivided for !MEAN).  A group of 1 << lg lanes serves one row; a unit is
// a float4 when VEC, else a float.  Every load of a row (its indices, mask
// and both gradient units) is issued before its first reduction, so a row
// costs one round of memory latency, not one per dependent load.  Padded
// rows need no test: they carry a zero gradient (self_pos 0) and no valid
// slot.  With FANOUT == 0 (a fan-out with no instantiation of its own) the
// row's slots are re-read from memory instead of held in registers.
template <int FANOUT, bool MEAN, bool VEC>
__global__ void __launch_bounds__(kThreads)
block_gather_bwd_kernel(const float* __restrict__ g_self,
                        const int32_t* __restrict__ self_pos, int64_t n_self,
                        const float* __restrict__ g_neigh,
                        const int32_t* __restrict__ pos,
                        const uint8_t* __restrict__ mask, int64_t n_neigh,
                        int fanout_rt, float* __restrict__ grad_src, int d, int lg) {
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
  float* dst_self = grad_src;
  int count = 0;
  if (has_self) dst_self += static_cast<int64_t>(self_pos[row]) * d;
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
  const float* gs = g_self + row * d;
  const float* gn = g_neigh + row * d;
  for (int i = sub; i < units; i += group) {
    if (VEC) {
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 vs = has_self ? __ldg(reinterpret_cast<const float4*>(gs) + i) : zero;
      float4 vn = has_neigh ? __ldg(reinterpret_cast<const float4*>(gn) + i) : zero;
      if (has_self) red4(dst_self + 4 * i, vs);
      if (MEAN) vn = scale4(vn, s);
#pragma unroll
      for (int k = 0; k < F; ++k) {
        const bool on = FANOUT > 0 ? m_reg[k] : has_neigh && m[k] != 0;
        const int32_t pk = FANOUT > 0 ? p_reg[k] : p[k];
        if (on) red4(grad_src + static_cast<int64_t>(pk) * d + 4 * i, vn);
      }
    } else {
      const float vs = has_self ? __ldg(gs + i) : 0.f;
      const float vn = has_neigh ? __ldg(gn + i) * s : 0.f;
      if (has_self) atomicAdd(dst_self + i, vs);
#pragma unroll
      for (int k = 0; k < F; ++k) {
        const bool on = FANOUT > 0 ? m_reg[k] : has_neigh && m[k] != 0;
        const int32_t pk = FANOUT > 0 ? p_reg[k] : p[k];
        if (on) atomicAdd(grad_src + static_cast<int64_t>(pk) * d + i, vn);
      }
    }
  }
}

inline dim3 grid_for(int64_t n) {
  return dim3(static_cast<unsigned>((n + kWarpsPerBlock - 1) / kWarpsPerBlock));
}

template <int FANOUT>
void launch_reduce(const float* src, const int32_t* pos, const uint8_t* mask,
                   float* out, int64_t n, int fanout, int d, bool mean, bool vec,
                   cudaStream_t st) {
  const dim3 grid = grid_for(n);
  if (mean && vec) {
    gather_reduce_kernel<FANOUT, true, true><<<grid, kThreads, 0, st>>>(src, pos, mask, out, n, fanout, d);
  } else if (mean) {
    gather_reduce_kernel<FANOUT, true, false><<<grid, kThreads, 0, st>>>(src, pos, mask, out, n, fanout, d);
  } else if (vec) {
    gather_reduce_kernel<FANOUT, false, true><<<grid, kThreads, 0, st>>>(src, pos, mask, out, n, fanout, d);
  } else {
    gather_reduce_kernel<FANOUT, false, false><<<grid, kThreads, 0, st>>>(src, pos, mask, out, n, fanout, d);
  }
}

struct BlockBwdArgs {
  const float* g_self;
  const int32_t* self_pos;
  int64_t n_self;
  const float* g_neigh;
  const int32_t* pos;
  const uint8_t* mask;
  int64_t n_neigh;
  int fanout;
  float* grad_src;
  int d;
};

template <int FANOUT, bool MEAN, bool VEC>
void launch_block_bwd_as(const BlockBwdArgs& a, cudaStream_t st) {
  // lanes per row: the smallest power of two covering the row's units
  const int units = VEC ? a.d / 4 : a.d;
  int lg = 0;
  while ((1 << lg) < units && (1 << lg) < kWarp) ++lg;
  const int64_t rows = a.n_self > a.n_neigh ? a.n_self : a.n_neigh;
  const int64_t per_block = kThreads >> lg;
  const dim3 grid(static_cast<unsigned>((rows + per_block - 1) / per_block));
  block_gather_bwd_kernel<FANOUT, MEAN, VEC><<<grid, kThreads, 0, st>>>(
      a.g_self, a.self_pos, a.n_self, a.g_neigh, a.pos, a.mask, a.n_neigh,
      a.fanout, a.grad_src, a.d, lg);
}

template <int FANOUT>
void launch_block_bwd(const BlockBwdArgs& a, bool mean, bool vec, cudaStream_t st) {
  if (mean && vec) {
    launch_block_bwd_as<FANOUT, true, true>(a, st);
  } else if (mean) {
    launch_block_bwd_as<FANOUT, true, false>(a, st);
  } else if (vec) {
    launch_block_bwd_as<FANOUT, false, true>(a, st);
  } else {
    launch_block_bwd_as<FANOUT, false, false>(a, st);
  }
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

}  // namespace

extern "C" {

int pg_gather_rows(const void* src, const void* ids, void* out, int64_t n, int d,
                   int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(src);
  const int32_t* i = static_cast<const int32_t*>(ids);
  float* o = static_cast<float*>(out);
  if (vec) {
    gather_rows_kernel<true><<<grid_for(n), kThreads, 0, st>>>(s, i, o, n, d);
  } else {
    gather_rows_kernel<false><<<grid_for(n), kThreads, 0, st>>>(s, i, o, n, d);
  }
  return static_cast<int>(cudaGetLastError());
}

int pg_assemble_from_map(const void* cache_values, const void* cache_map,
                         const void* nids, const void* miss_slot,
                         const void* miss_feats, void* out, int64_t n, int d,
                         int64_t n_miss_rows, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* cv = static_cast<const float*>(cache_values);
  const int32_t* cm = static_cast<const int32_t*>(cache_map);
  const int32_t* ni = static_cast<const int32_t*>(nids);
  const int32_t* ms = static_cast<const int32_t*>(miss_slot);
  const float* mf = static_cast<const float*>(miss_feats);
  float* o = static_cast<float*>(out);
  if (vec) {
    assemble_kernel<true><<<grid_for(n), kThreads, 0, st>>>(cv, cm, ni, ms, mf, o, n, d, n_miss_rows);
  } else {
    assemble_kernel<false><<<grid_for(n), kThreads, 0, st>>>(cv, cm, ni, ms, mf, o, n, d, n_miss_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

int pg_gather_reduce(const void* src, const void* pos, const void* mask, void* out,
                     int64_t n, int fanout, int d, int mean, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(src);
  const int32_t* p = static_cast<const int32_t*>(pos);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* o = static_cast<float*>(out);
#define PG_LAUNCH_REDUCE(F) launch_reduce<F>(s, p, m, o, n, fanout, d, mean != 0, vec != 0, st)
  PG_FANOUT_SWITCH(fanout, PG_LAUNCH_REDUCE)
#undef PG_LAUNCH_REDUCE
  return static_cast<int>(cudaGetLastError());
}

// Zero grad_src [num_src, d] and add both halves of a block's backward into
// it, in one memset and one launch on the caller's stream.  An absent half
// has null pointers and 0 rows (the self half: g_self, self_pos, n_self; the
// neighbor half: g_neigh, pos, mask, n_neigh, and then fanout is ignored).
int pg_block_gather_bwd(const void* g_self, const void* self_pos, int64_t n_self,
                        const void* g_neigh, const void* pos, const void* mask,
                        int64_t n_neigh, int fanout, void* grad_src,
                        int64_t num_src, int d, int mean, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t rc = cudaMemsetAsync(
      grad_src, 0, static_cast<size_t>(num_src) * d * sizeof(float), st);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if ((n_self == 0 && n_neigh == 0) || d == 0) return static_cast<int>(cudaGetLastError());
  const BlockBwdArgs a{static_cast<const float*>(g_self),
                       static_cast<const int32_t*>(self_pos), n_self,
                       static_cast<const float*>(g_neigh),
                       static_cast<const int32_t*>(pos),
                       static_cast<const uint8_t*>(mask), n_neigh,
                       n_neigh > 0 ? fanout : 0,
                       static_cast<float*>(grad_src), d};
#define PG_LAUNCH_BLOCK_BWD(F) launch_block_bwd<F>(a, mean != 0, vec != 0, st)
  PG_FANOUT_SWITCH(a.fanout, PG_LAUNCH_BLOCK_BWD)
#undef PG_LAUNCH_BLOCK_BWD
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
