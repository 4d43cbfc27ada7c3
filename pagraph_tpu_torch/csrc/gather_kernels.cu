// Row-gather and fused gather + masked fan-out reduction kernels for Hopper
// (sm_90a), with the scatter-add kernels that are their backwards.
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
//   * pg_scatter_add_rows, pg_gather_reduce_bwd: the backwards.  The Pallas
//     kernels are forward-only (JAX differentiates jnp.take); the port trains
//     through these kernels, so their gradients are kernels too.
//
// What bounds them: device-memory bytes, not FLOPs.  A row gather does no
// arithmetic; the reduction does fanout adds per output element.  The least
// traffic is the index bytes + the gathered-row bytes + the output bytes,
// each once (for the backwards: indices + incoming gradient + the gradient
// table written once).  That is what chip_smoke.py's bound_ms counts.
//
// What the design does about it:
//   * one warp per output row, so the 32 lanes read one source row together:
//     with D % 4 == 0 and 16-byte-aligned tables every lane moves a float4,
//     i.e. each row is read in coalesced 16-byte transactions (D = 100 is 25
//     float4s, D = 32 is 8); otherwise a scalar loop over the row;
//   * masked fan-out slots are never loaded (as in the Pallas kernel, where
//     invalid slots start no DMA), and the fan-out loop is unrolled with
//     the fan-out as a template parameter;
//   * the two-source assembly reads each output row from exactly one table,
//     in one launch, instead of gathering both and selecting;
//   * backwards use f32 atomicAdd into a zeroed gradient table; a warp's
//     atomics hit consecutive addresses of one row.
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

// K1 backward: grad_src[ids[r]] += grad_out[r]
__global__ void __launch_bounds__(kThreads)
scatter_add_rows_kernel(const float* __restrict__ grad_out,
                        const int32_t* __restrict__ ids,
                        float* __restrict__ grad_src, int64_t n, int d) {
  const int64_t row = warp_row();
  if (row >= n) return;
  const int lane = threadIdx.x % kWarp;
  const float* g = grad_out + row * d;
  float* dst = grad_src + static_cast<int64_t>(ids[row]) * d;
  for (int i = lane; i < d; i += kWarp) atomicAdd(dst + i, __ldg(g + i));
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

// K2 backward: for each valid slot, grad_src[pos[r,k]] += grad_out[r]
// (divided by max(count, 1) for MEAN).
template <int FANOUT, bool MEAN>
__global__ void __launch_bounds__(kThreads)
gather_reduce_bwd_kernel(const float* __restrict__ grad_out,
                         const int32_t* __restrict__ pos,
                         const uint8_t* __restrict__ mask,
                         float* __restrict__ grad_src,
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
  if (count == 0) return;
  const float denom = static_cast<float>(count);
  const float* g = grad_out + row * d;
  for (int i = lane; i < d; i += kWarp) {
    const float v = MEAN ? __ldg(g + i) / denom : __ldg(g + i);
#pragma unroll
    for (int k = 0; k < F; ++k) {
      if (m[k]) atomicAdd(grad_src + static_cast<int64_t>(p[k]) * d + i, v);
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

template <int FANOUT>
void launch_reduce_bwd(const float* grad_out, const int32_t* pos, const uint8_t* mask,
                       float* grad_src, int64_t n, int fanout, int d, bool mean,
                       cudaStream_t st) {
  const dim3 grid = grid_for(n);
  if (mean) {
    gather_reduce_bwd_kernel<FANOUT, true><<<grid, kThreads, 0, st>>>(grad_out, pos, mask, grad_src, n, fanout, d);
  } else {
    gather_reduce_bwd_kernel<FANOUT, false><<<grid, kThreads, 0, st>>>(grad_out, pos, mask, grad_src, n, fanout, d);
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

int pg_scatter_add_rows(const void* grad_out, const void* ids, void* grad_src,
                        int64_t n, int d, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  scatter_add_rows_kernel<<<grid_for(n), kThreads, 0, st>>>(
      static_cast<const float*>(grad_out), static_cast<const int32_t*>(ids),
      static_cast<float*>(grad_src), n, d);
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

int pg_gather_reduce_bwd(const void* grad_out, const void* pos, const void* mask,
                         void* grad_src, int64_t n, int fanout, int d, int mean,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(grad_out);
  const int32_t* p = static_cast<const int32_t*>(pos);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* gs = static_cast<float*>(grad_src);
#define PG_LAUNCH_REDUCE_BWD(F) launch_reduce_bwd<F>(g, p, m, gs, n, fanout, d, mean != 0, st)
  PG_FANOUT_SWITCH(fanout, PG_LAUNCH_REDUCE_BWD)
#undef PG_LAUNCH_REDUCE_BWD
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
