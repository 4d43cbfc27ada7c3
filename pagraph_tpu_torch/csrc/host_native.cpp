// Host kernels of the port: the neighbor sampler and the miss-row gathers
// of the host path, the mean-aggregate SpMMs of GraphSAGE's preprocess
// field, the R-MAT generator and COO -> CSR conversion of rmat_csr, and the
// partition pipeline's dg assignment, hop closure and sub-CSR fill
// (partition/), compiled with g++ at first use (sampling/native.py) and
// loaded with ctypes.
//
// The port's own copy of twelve functions of the JAX package's native host
// library (pg_sample_minibatch, pg_gather_rows_f32, pg_gather_rows_i8,
// pg_spmm_mean_f32, pg_spmm_mean_i8, pg_rmat_gen, pg_coo_to_csr, and the
// partition pipeline's pg_dg_assign, pg_hop_closure, pg_bitmap_extract,
// pg_map_rows and pg_histogram_i32), with the arithmetic unchanged, so that
// a batch drawn from the same seed is bit-equal to the JAX package's native
// sampler, a preprocess field or an R-MAT graph to the JAX package's, and a
// partition (assignment, closure, sub-CSR) to the JAX package's.
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

#if defined(_OPENMP)
#include <omp.h>
#endif

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

// Streaming greedy dg assignment (the PaGraph partitioner): for each train
// vertex in order, score every partition
//   score[p] = (1 + |N_hops(v) & assigned_p|) * (avg - p_vnum[p]) / (r_vnum[p] + 1)
// and pick the best, ties to the smallest partition (first on equal size).
//   indptr/indices  in-CSR of the full graph
//   train_nids      [num_train] int64, streamed in this order
//   avg             balance target (train_frac * V / P, or sum(weights) / P)
//   weights         per-train-vertex weight (NULL -> 1.0; in_deg + 1 is the
//                   edge-balance mode)
//   out             [num_train] int32 partition per train vertex
// Returns 0, -1 on bad sizes, -2 on an out-of-range train id.
//
// A vertex's hop neighborhood does not depend on the assignments, so the
// neighborhoods of a chunk of upcoming train vertices are expanded in
// parallel (one BFS a vertex, a stamp array a thread), then the chunk is
// scored one vertex after another, in stream order.  The scores are sums of
// integer counts in doubles, independent of the order the neighborhood
// lists its vertices in, so the assignment is the sequential stream's, bit
// for bit.
int pg_dg_assign(const int64_t* indptr, const int32_t* indices,
                 int64_t num_nodes,
                 const int64_t* train_nids, int64_t num_train,
                 int32_t num_parts, int32_t hops, double avg,
                 const double* weights,
                 int32_t* out) {
  if (num_parts <= 0 || hops < 0) return -1;
  for (int64_t i = 0; i < num_train; ++i)
    if (train_nids[i] < 0 || train_nids[i] >= num_nodes) return -2;
  int threads = 1;
#if defined(_OPENMP)
  threads = omp_get_max_threads();
#endif
  const int64_t chunk = 16 * (int64_t)threads;
  // stamp[t][u] == j + 1: u already reached from chunk slot j by thread t
  std::vector<std::vector<int32_t>> stamps(threads, std::vector<int32_t>(num_nodes, 0));
  std::vector<std::vector<int32_t>> neighs(chunk);
  std::vector<int32_t> belongs(num_nodes, -1);
  const int64_t words = (num_nodes + 63) / 64;
  std::vector<uint64_t> closure((size_t)num_parts * words, 0);
  std::vector<double> p_vnum(num_parts, 0.0);
  std::vector<int64_t> r_vnum(num_parts, 0);
  std::vector<double> com(num_parts), score(num_parts);
  for (int64_t base = 0; base < num_train; base += chunk) {
    const int64_t m = std::min(chunk, num_train - base);
    // hops-level in-BFS of each vertex of the chunk, deduplicated, the
    // vertex itself excluded
#pragma omp parallel
    {
      int t = 0;
#if defined(_OPENMP)
      t = omp_get_thread_num();
#endif
      std::vector<int32_t>& stamp = stamps[t];
      std::vector<int32_t> frontier, next;
#pragma omp for schedule(dynamic, 1)
      for (int64_t j = 0; j < m; ++j) {
        const int32_t mark = (int32_t)(base + j) % 0x7FFFFFFF + 1;
        const int32_t nid = (int32_t)train_nids[base + j];
        std::vector<int32_t>& neigh = neighs[j];
        neigh.clear();
        frontier.assign(1, nid);
        stamp[nid] = mark;
        for (int32_t h = 0; h < hops; ++h) {
          next.clear();
          for (int32_t v : frontier) {
            for (int64_t e = indptr[v]; e < indptr[v + 1]; ++e) {
              const int32_t u = indices[e];
              if (stamp[u] != mark) {
                stamp[u] = mark;
                next.push_back(u);
                neigh.push_back(u);
              }
            }
          }
          if (next.empty()) break;
          frontier.swap(next);
        }
      }
    }
    for (int64_t j = 0; j < m; ++j) {
      const int64_t i = base + j;
      const int64_t nid = train_nids[i];
      const std::vector<int32_t>& neigh = neighs[j];
      for (int32_t p = 0; p < num_parts; ++p) com[p] = 1.0;
      for (int32_t u : neigh) {
        const int32_t b = belongs[u];
        if (b >= 0) com[b] += 1.0;
      }
      double best = -1.0 / 0.0;
      for (int32_t p = 0; p < num_parts; ++p) {
        score[p] = com[p] * (avg - p_vnum[p]) / ((double)r_vnum[p] + 1.0);
        if (score[p] > best) best = score[p];
      }
      int32_t pick = 0;
      double pick_vnum = 1.0 / 0.0;
      for (int32_t p = 0; p < num_parts; ++p) {
        if (score[p] == best && p_vnum[p] < pick_vnum) {
          pick_vnum = p_vnum[p];
          pick = p;
        }
      }
      out[i] = pick;
      belongs[nid] = pick;
      p_vnum[pick] += weights ? weights[i] : 1.0;
      uint64_t* bm = closure.data() + (size_t)pick * words;
      int64_t fresh = 0;
      auto touch = [&](int64_t v) {
        const uint64_t mk = 1ULL << (v & 63);
        uint64_t& w = bm[v >> 6];
        if (!(w & mk)) {
          w |= mk;
          ++fresh;
        }
      };
      for (int32_t u : neigh) touch(u);
      touch(nid);
      r_vnum[pick] += fresh;
    }
  }
  return 0;
}

// Hop closure over the in-CSR: level-synchronous BFS from `seeds`, `hops`
// levels, bitmap-visited: `visited` after all levels, `interior` after
// hops-1 levels (the vertices that keep all their in-edges).  Bitmaps are
// [(n+63)/64] uint64, caller-zeroed.
void pg_hop_closure(const int64_t* indptr, const int32_t* indices, int64_t n,
                    const int64_t* seeds, int64_t num_seeds, int32_t hops,
                    uint64_t* visited, uint64_t* interior) {
  std::atomic<uint64_t>* vis =
      reinterpret_cast<std::atomic<uint64_t>*>(visited);
  std::vector<int32_t> frontier;
  frontier.reserve(num_seeds);
  for (int64_t i = 0; i < num_seeds; ++i) {
    const int64_t v = seeds[i];
    const uint64_t bit = 1ULL << (v & 63);
    if (!(vis[v >> 6].fetch_or(bit, std::memory_order_relaxed) & bit))
      frontier.push_back((int32_t)v);
  }
  const int64_t words = (n + 63) / 64;
  std::vector<int32_t> next;
  bool interior_done = false;
  for (int32_t depth = 0; depth < hops; ++depth) {
    next.clear();
#pragma omp parallel
    {
      std::vector<int32_t> local;
#pragma omp for schedule(dynamic, 1024) nowait
      for (int64_t i = 0; i < (int64_t)frontier.size(); ++i) {
        const int32_t v = frontier[i];
        for (int64_t e = indptr[v]; e < indptr[v + 1]; ++e) {
          const int32_t u = indices[e];
          const uint64_t bit = 1ULL << (u & 63);
          if (!(vis[u >> 6].load(std::memory_order_relaxed) & bit)) {
            if (!(vis[u >> 6].fetch_or(bit, std::memory_order_relaxed) & bit))
              local.push_back(u);
          }
        }
      }
#pragma omp critical
      next.insert(next.end(), local.begin(), local.end());
    }
    frontier.swap(next);
    if (depth == hops - 2) {
      std::memcpy(interior, visited, sizeof(uint64_t) * words);
      interior_done = true;
    }
    if (frontier.empty()) break;
  }
  if (hops == 1) {
    // interior is exactly the seed set (the caller zeroed the buffer)
    for (int64_t i = 0; i < num_seeds; ++i) {
      const int64_t v = seeds[i];
      interior[v >> 6] |= 1ULL << (v & 63);
    }
  } else if (!interior_done) {
    // BFS exhausted before hops-1 levels: visited is final
    std::memcpy(interior, visited, sizeof(uint64_t) * words);
  }
}

// Set bits of a bitmap as sorted int64 ids; returns the count.
int64_t pg_bitmap_extract(const uint64_t* bm, int64_t words, int64_t* out) {
  std::vector<int64_t> off(words + 1, 0);
#pragma omp parallel for schedule(static)
  for (int64_t w = 0; w < words; ++w)
    off[w + 1] = __builtin_popcountll(bm[w]);
  for (int64_t w = 0; w < words; ++w) off[w + 1] += off[w];
#pragma omp parallel for schedule(static)
  for (int64_t w = 0; w < words; ++w) {
    uint64_t x = bm[w];
    int64_t at = off[w];
    while (x) {
      out[at++] = (w << 6) + __builtin_ctzll(x);
      x &= x - 1;
    }
  }
  return off[words];
}

// Sub-CSR row fill of a partition: for each full-graph row r = rows[i], its
// in-neighbors mapped through full2sub into out_indices from out_starts[i].
// Returns -1 if a neighbor is outside the closure (full2sub < 0), else 0.
int pg_map_rows(const int64_t* indptr, const int32_t* indices,
                const int32_t* full2sub, const int64_t* rows,
                const int64_t* out_starts, int64_t num_rows,
                int32_t* out_indices) {
  std::atomic<int> bad(0);
#pragma omp parallel for schedule(dynamic, 4096)
  for (int64_t i = 0; i < num_rows; ++i) {
    const int64_t r = rows[i];
    int64_t at = out_starts[i];
    for (int64_t e = indptr[r]; e < indptr[r + 1]; ++e) {
      const int32_t s = full2sub[indices[e]];
      if (s < 0) bad.store(1, std::memory_order_relaxed);
      out_indices[at++] = s;
    }
  }
  return bad.load() ? -1 : 0;
}

// Atomic histogram of int32 values in [0, nbins) (a sub-CSR's out-degrees).
void pg_histogram_i32(const int32_t* values, int64_t count, int64_t nbins,
                      int32_t* out) {
  std::atomic<int32_t>* o = reinterpret_cast<std::atomic<int32_t>*>(out);
#pragma omp parallel for schedule(static)
  for (int64_t b = 0; b < nbins; ++b) o[b].store(0, std::memory_order_relaxed);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < count; ++i)
    o[values[i]].fetch_add(1, std::memory_order_relaxed);
}

}  // extern "C"
