// Host kernels of the port's host path: the neighbor sampler and the
// miss-row gathers, compiled with g++ at first use (sampling/native.py) and
// loaded with ctypes.
//
// The port's own copy of three functions of the JAX package's native host
// library (pg_sample_minibatch, pg_gather_rows_f32, pg_gather_rows_i8), with
// the arithmetic unchanged, so that a batch drawn from the same seed is
// bit-equal to the JAX package's native sampler.
// Build: g++ -O3 -march=native -shared -fPIC -fopenmp -std=c++17.
//
// Sampling semantics (numpy sampler's policy, native draws):
//   deg == 0          -> all slots masked
//   0 < deg <= fanout -> take all in-neighbors (slots k < deg)
//   deg > fanout      -> `fanout` uniform draws with replacement, from
//                        splitmix64 seeded by (batch seed, vertex, hop)
// Layer dedup keeps first-occurrence order, so the dst set occupies the
// prefix of the src layer (the subset invariant the models rely on).

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

}  // extern "C"
