// Host kernels of the port: the neighbor sampler and the miss-row gathers
// of the host path, the mean-aggregate SpMMs of GraphSAGE's preprocess
// field, and the R-MAT generator and COO -> CSR builder of rmat_csr,
// compiled with g++ at first use (sampling/native.py) and loaded with
// ctypes.
//
// The port's own copy of seven functions of the JAX package's native host
// library (pg_sample_minibatch, pg_gather_rows_f32, pg_gather_rows_i8,
// pg_spmm_mean_f32, pg_spmm_mean_i8, pg_rmat_gen, pg_coo_to_csr), with the
// arithmetic unchanged, so that a batch drawn from the same seed is
// bit-equal to the JAX package's native sampler, and a preprocess field or
// an R-MAT graph to the JAX package's.
// Build: g++ -O3 -march=native -shared -fPIC -fopenmp -std=c++17.
//
// Sampling semantics (numpy sampler's policy, native draws):
//   deg == 0          -> all slots masked
//   0 < deg <= fanout -> take all in-neighbors (slots k < deg)
//   deg > fanout      -> `fanout` uniform draws with replacement, from
//                        splitmix64 seeded by (batch seed, vertex, hop)
// Layer dedup keeps first-occurrence order, so the dst set occupies the
// prefix of the src layer (the subset invariant the models rely on).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// SplitMix64: fast, well-distributed, seedable per (batch, vertex, slot).
static inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

}  // namespace

extern "C" {

// Sample one minibatch. All output buffers are caller-allocated.
//
//   indptr   [num_nodes+1] int64   in-CSR of the (partition) graph
//   indices  [num_edges]   int32
//   seeds    [num_seeds]   int64   num_seeds <= caps[hops]
//   fanouts  [hops]        int32   per-hop fanout; fanouts[0] expands from
//                                  the seeds (block hops-1), fanouts[hops-1]
//                                  produces the outermost layer (block 0)
//   caps     [hops+1]      int64   per-layer capacity, caps[0] = outermost
//   pos_of   [num_nodes]   int32   scratch, must be -1 on entry; restored
//                                  to -1 on exit (reusable across calls)
//   layer_nids  [sum(caps)]          int32  zero-padded, layer 0 first
//   layer_sizes [hops+1]             int64  valid count per layer
//   neigh_pos   [sum(caps[b+1]*fanout_of_block_b) for b in 0..hops-1] int32
//               block b (connecting layer b -> b+1) uses
//               caps[b+1]*fanouts[hops-1-b], blocks stored outermost-first
//   neigh_mask  same extent as neigh_pos, uint8
//   self_pos    [sum(caps[i]) for i in 1..hops] int32
//
// Returns 0 on success, -1 if num_seeds exceeds the seed capacity.
int pg_sample_minibatch(
    const int64_t* indptr, const int32_t* indices, int64_t num_nodes,
    const int64_t* seeds, int64_t num_seeds,
    const int32_t* fanouts, int32_t hops, const int64_t* caps, uint64_t seed,
    int32_t* pos_of,
    int32_t* layer_nids, int64_t* layer_sizes,
    int32_t* neigh_pos, uint8_t* neigh_mask, int32_t* self_pos) {
  (void)num_nodes;
  if (num_seeds > caps[hops]) return -1;

  // Layer offsets into the flat output buffers.
  std::vector<int64_t> nid_off(hops + 2, 0);
  for (int i = 0; i <= hops; ++i) nid_off[i + 1] = nid_off[i] + caps[i];
  // Block b connects layer b (src) -> layer b+1 (dst); block buffers are
  // sized by the dst layer capacity.
  std::vector<int64_t> blk_off(hops + 1, 0), self_off(hops + 1, 0);
  for (int b = 0; b < hops; ++b) {
    blk_off[b + 1] = blk_off[b] + caps[b + 1] * fanouts[hops - 1 - b];
    self_off[b + 1] = self_off[b] + caps[b + 1];
  }

  // Current (inner) layer ids, built from the seeds outward.
  std::vector<int64_t> cur(seeds, seeds + num_seeds);
  std::vector<int64_t> nxt;
  std::vector<int32_t> sampled;  // [m * fanout] neighbor vertex ids
  std::vector<uint8_t> smask;

  // Write the seed layer now.
  layer_sizes[hops] = num_seeds;
  {
    int32_t* dst = layer_nids + nid_off[hops];
    std::memset(dst, 0, sizeof(int32_t) * caps[hops]);
    for (int64_t i = 0; i < num_seeds; ++i) dst[i] = (int32_t)cur[i];
  }

  for (int hop = 0; hop < hops; ++hop) {
    const int blk = hops - hop - 1;       // block index, outermost-first
    const int32_t fanout = fanouts[hop];
    const int64_t cap_src = caps[blk];
    const int64_t cap_dst = caps[blk + 1];
    const int64_t m = (int64_t)cur.size();

    sampled.assign((size_t)m * fanout, 0);
    smask.assign((size_t)m * fanout, 0);

    // Draw neighbors (parallel: independent per dst vertex).
#pragma omp parallel for schedule(static)
    for (int64_t d = 0; d < m; ++d) {
      const int64_t v = cur[d];
      const int64_t lo = indptr[v], hi = indptr[v + 1];
      const int64_t deg = hi - lo;
      int32_t* out = sampled.data() + d * fanout;
      uint8_t* msk = smask.data() + d * fanout;
      if (deg == 0) continue;
      if (deg <= fanout) {
        for (int64_t k = 0; k < deg; ++k) { out[k] = indices[lo + k]; msk[k] = 1; }
      } else {
        uint64_t s = seed ^ splitmix64((uint64_t)v * 0x2545F4914F6CDD1DULL
                                       + (uint64_t)hop);
        for (int32_t k = 0; k < fanout; ++k) {
          s = splitmix64(s);
          out[k] = indices[lo + (int64_t)(s % (uint64_t)deg)];
          msk[k] = 1;
        }
      }
    }

    // Dedup in first-occurrence order: dst set first (subset invariant),
    // then sampled neighbors row-major.  Sequential (cheap vs the draws).
    nxt.clear();
    nxt.reserve((size_t)cap_src);
    for (int64_t i = 0; i < m; ++i) {
      const int64_t v = cur[i];
      if (pos_of[v] < 0) { pos_of[v] = (int32_t)nxt.size(); nxt.push_back(v); }
      self_pos[self_off[blk] + i] = pos_of[v];
    }
    int32_t* npos = neigh_pos + blk_off[blk];
    uint8_t* nmsk = neigh_mask + blk_off[blk];
    std::memset(npos, 0, sizeof(int32_t) * (size_t)(cap_dst * fanout));
    std::memset(nmsk, 0, sizeof(uint8_t) * (size_t)(cap_dst * fanout));
    for (int64_t i = 0; i < m * fanout; ++i) {
      if (!smask[i]) continue;
      const int64_t v = sampled[i];
      int32_t p = pos_of[v];
      if (p < 0) {
        if ((int64_t)nxt.size() >= cap_src) continue;  // overflow: mask edge
        p = (int32_t)nxt.size();
        pos_of[v] = p;
        nxt.push_back(v);
      }
      npos[i] = p;
      nmsk[i] = 1;
    }
    // Zero the padded tail of self_pos for this block.
    for (int64_t i = m; i < cap_dst; ++i) self_pos[self_off[blk] + i] = 0;

    // Emit the src layer.
    layer_sizes[blk] = (int64_t)nxt.size();
    int32_t* lnid = layer_nids + nid_off[blk];
    std::memset(lnid, 0, sizeof(int32_t) * cap_src);
    for (size_t i = 0; i < nxt.size(); ++i) lnid[i] = (int32_t)nxt[i];

    // Reset scratch for the next hop / next call.
    for (int64_t v : nxt) pos_of[v] = -1;
    cur.swap(nxt);
  }
  return 0;
}

// Fused row gather: out[i, :] = src[ids[i], :].  OpenMP over rows: the
// miss-path feature read of the f32 store.
void pg_gather_rows_f32(const float* src, int64_t num_rows, int64_t dim,
                        const int64_t* ids, int64_t n, float* out) {
  (void)num_rows;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    std::memcpy(out + i * dim, src + ids[i] * dim, sizeof(float) * dim);
  }
}

// int8 row gather (the pre-quantized store's miss path).
void pg_gather_rows_i8(const int8_t* src, int64_t num_rows, int64_t dim,
                       const int64_t* ids, int64_t n, int8_t* out) {
  (void)num_rows;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    std::memcpy(out + i * dim, src + ids[i] * dim, (size_t)dim);
  }
}

// CSR mean-aggregate SpMM: out[v] = norm[v] * sum_{u in N_in(v)} x[u]
// (the preprocess trick's offline pass, reference server/pa_server.py:45-52;
// scipy's single-threaded SpMM was the store_build bottleneck at 0.5B edges).
void pg_spmm_mean_f32(const int64_t* indptr, const int32_t* indices,
                      int64_t n, const float* x, int64_t d,
                      const float* norm, float* out) {
#pragma omp parallel for schedule(dynamic, 4096)
  for (int64_t v = 0; v < n; ++v) {
    float* o = out + v * d;
    std::memset(o, 0, sizeof(float) * d);
    for (int64_t e = indptr[v]; e < indptr[v + 1]; ++e) {
      const float* row = x + (int64_t)indices[e] * d;
      for (int64_t k = 0; k < d; ++k) o[k] += row[k];
    }
    const float nv = norm[v];
    for (int64_t k = 0; k < d; ++k) o[k] *= nv;
  }
}

// CSR mean-aggregate over an int8 (pre-quantized) feature matrix for rows
// [row_lo, row_hi): out[v - row_lo, k] = norm[v] * scale[k] * sum int8 rows.
// Exact: sum_u scale[k]*x[u,k] = scale[k] * sum_u x[u,k]; int64 accumulators
// (hub in-degree * 127 overflows int32 around deg 16.9M).  The row range
// makes the caller's chunked quantize-on-the-fly pass possible without ever
// materializing the full f32 aggregate (papers100M preprocess field).
void pg_spmm_mean_i8(const int64_t* indptr, const int32_t* indices,
                     const int8_t* x, int64_t d,
                     const float* norm, const float* scale,
                     int64_t row_lo, int64_t row_hi, float* out) {
#pragma omp parallel
  {
    std::vector<int64_t> acc(d);
#pragma omp for schedule(dynamic, 2048)
    for (int64_t v = row_lo; v < row_hi; ++v) {
      std::memset(acc.data(), 0, sizeof(int64_t) * d);
      for (int64_t e = indptr[v]; e < indptr[v + 1]; ++e) {
        const int8_t* row = x + (int64_t)indices[e] * d;
        for (int64_t k = 0; k < d; ++k) acc[k] += row[k];
      }
      float* o = out + (v - row_lo) * d;
      const float nv = norm[v];
      for (int64_t k = 0; k < d; ++k) o[k] = nv * scale[k] * (float)acc[k];
    }
  }
}

// R-MAT edge generation: m directed edges over 2^scale vertices, Graph500
// quadrant descent.  Each edge owns an independent splitmix64 stream, so the
// draw order is deterministic and parallel.  Self-loops are re-drawn (up to
// 32 attempts, then the dst low bit is flipped) so exactly m edges emerge;
// the numpy generator (data/synthetic.py:rmat_coo) instead filters them out.
// Duplicate edges remain (removed at CSR build, like the COO->CSR round trip).
void pg_rmat_gen(int32_t scale, int64_t m, double a, double b, double c,
                 uint64_t seed, int32_t* src, int32_t* dst) {
  const uint64_t ta = (uint64_t)(a * 18446744073709551616.0);
  const uint64_t tab = (uint64_t)((a + b) * 18446744073709551616.0);
  const uint64_t tabc = (uint64_t)((a + b + c) * 18446744073709551616.0);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < m; ++i) {
    uint64_t s = seed ^ splitmix64((uint64_t)i * 0x9E3779B97F4A7C15ULL + 1);
    int32_t u = 0, v = 0;
    for (int attempt = 0; attempt < 32; ++attempt) {
      u = 0; v = 0;
      for (int32_t bit = 0; bit < scale; ++bit) {
        s = splitmix64(s);
        const uint64_t r = s;
        const int32_t sb = r >= tab ? 1 : 0;
        const int32_t db = ((r >= ta && r < tab) || r >= tabc) ? 1 : 0;
        u = (u << 1) | sb;
        v = (v << 1) | db;
      }
      if (u != v) break;
    }
    if (u == v) v ^= 1;
    src[i] = u;
    dst[i] = v;
  }
}

// COO (src -> dst) to in-CSR with per-row sort + dedup (scipy parity:
// tocsr().sum_duplicates().sort_indices(), graph.py:from_coo).  Self-loops
// kept iff drop_self == 0.  `indices` must have capacity m; rows are
// compacted in place and the deduplicated edge count returned.  `cursor`
// is int64 scratch [n].  Fills `out_deg` (source-occurrence histogram of the
// deduplicated edges) when non-NULL.
int64_t pg_coo_to_csr(const int32_t* src, const int32_t* dst, int64_t m,
                      int64_t n, int32_t drop_self,
                      int64_t* indptr, int32_t* indices, int64_t* cursor,
                      int32_t* out_deg) {
  std::atomic<int64_t>* counts =
      reinterpret_cast<std::atomic<int64_t>*>(cursor);
#pragma omp parallel for schedule(static)
  for (int64_t v = 0; v < n; ++v) counts[v].store(0, std::memory_order_relaxed);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < m; ++i) {
    if (drop_self && src[i] == dst[i]) continue;
    counts[dst[i]].fetch_add(1, std::memory_order_relaxed);
  }
  indptr[0] = 0;
  for (int64_t v = 0; v < n; ++v)
    indptr[v + 1] = indptr[v] + cursor[v];
#pragma omp parallel for schedule(static)
  for (int64_t v = 0; v < n; ++v) counts[v].store(indptr[v], std::memory_order_relaxed);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < m; ++i) {
    if (drop_self && src[i] == dst[i]) continue;
    const int64_t pos = counts[dst[i]].fetch_add(1, std::memory_order_relaxed);
    indices[pos] = src[i];
  }
  // Per-row sort + unique; new length recorded in cursor.
#pragma omp parallel for schedule(dynamic, 4096)
  for (int64_t v = 0; v < n; ++v) {
    int32_t* lo = indices + indptr[v];
    int32_t* hi = indices + indptr[v + 1];
    std::sort(lo, hi);
    cursor[v] = std::unique(lo, hi) - lo;
  }
  // Compact rows left.  SERIAL: a later row's new region can overlap an
  // EARLIER row's not-yet-copied old region, so a parallel version races
  // across thread boundaries; the sequential memmove is bandwidth-bound
  // (~E*4 bytes) and cheap next to the sort pass.
  std::vector<int64_t> new_start(n + 1);
  new_start[0] = 0;
  for (int64_t v = 0; v < n; ++v) new_start[v + 1] = new_start[v] + cursor[v];
  for (int64_t v = 0; v < n; ++v) {
    const int64_t cnt = cursor[v], from = indptr[v], to = new_start[v];
    if (to != from && cnt > 0)
      std::memmove(indices + to, indices + from, sizeof(int32_t) * cnt);
  }
  std::memcpy(indptr, new_start.data(), sizeof(int64_t) * (n + 1));
  const int64_t e = new_start[n];
  if (out_deg) {
    std::atomic<int32_t>* od = reinterpret_cast<std::atomic<int32_t>*>(out_deg);
#pragma omp parallel for schedule(static)
    for (int64_t v = 0; v < n; ++v) od[v].store(0, std::memory_order_relaxed);
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < e; ++i)
      od[indices[i]].fetch_add(1, std::memory_order_relaxed);
  }
  return e;
}

}  // extern "C"
