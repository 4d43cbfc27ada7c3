"""Kernighan-Lin partitioner (the port of ``pagraph_tpu/partition/kl_part.py``).

A KL-style min-cut bisection of the **train vertices**, applied recursively
for P > 2 (proportional targets, so P need not be a power of two).  It runs
on a train-vertex affinity graph: ``W[i, j]`` counts the (symmetrized)
edges between train vertices i and j plus, for ``hops >= 2``, their shared
neighbors, the vertices both closures would replicate; minimizing the
W-cut minimizes the redundancy between partitions.  The bisection is the
Fiduccia-Mattheyses form of KL: passes of single-vertex moves by largest
gain from a lazily invalidated heap, balance held within a tolerance, each
pass rolled back to its best prefix.
"""
from __future__ import annotations

import heapq
from typing import List

import numpy as np
import scipy.sparse as spsp

from ..data.formats import PartitionArtifact
from ..graph import CSRGraph
from .utils import extract_partition


def train_affinity(graph: CSRGraph, train_nids: np.ndarray,
                   hops: int) -> spsp.csr_matrix:
    """Symmetric weighted affinity among train vertices.

    ``W[i, j]`` counts direct (symmetrized) edges between train vertices i, j
    plus, for hops >= 2, their shared neighbors — vertices both closures must
    replicate.  Diagonal removed.
    """
    train_nids = np.asarray(train_nids, dtype=np.int64)
    n = graph.num_nodes
    a = spsp.csr_matrix(
        (np.ones(graph.num_edges, dtype=np.float32),
         graph.indices.astype(np.int64), graph.indptr),
        shape=(n, n),
    )
    au = a + a.T
    au.data[:] = 1.0                       # binarize multi-edges
    at = au[train_nids].tocsr()            # [T, n]
    w = at[:, train_nids].tocsr()          # direct train-train edges
    if hops >= 2:
        # shared-neighbor counts; nnz of at@at.T is ~sum_k d(k)^2 where d(k)
        # = train vertices adjacent to k — can explode on dense graphs
        # (Reddit), in which case the direct-edge cut is the affordable
        # objective and still correlates with closure overlap.
        d = np.asarray(at.sum(axis=0)).ravel()
        if float(d @ d) <= 2e8:
            w = w + at @ at.T
    w = w.tocsr()
    w.setdiag(0)
    w.eliminate_zeros()
    return w


def kl_bisect(
    w: spsp.csr_matrix,
    *,
    target0: int,
    seed: int = 0,
    max_passes: int = 8,
    tol: float = 0.02,
) -> np.ndarray:
    """FM-realized KL bisection of the affinity graph ``w`` (symmetric CSR).

    Returns a bool array: False = side 0 (``target0`` vertices ± tolerance),
    True = side 1.
    """
    n = w.shape[0]
    rng = np.random.default_rng(seed)
    side = np.zeros(n, dtype=bool)
    side[rng.permutation(n)[target0:]] = True
    if n <= 1 or w.nnz == 0:
        return side
    tol_abs = max(1, int(round(tol * n)))
    indptr, indices, data = w.indptr, w.indices, w.data

    for _ in range(max_passes):
        # gain[v] = ext(v) - int(v); with s = +1/-1 per side, W@s gives
        # int-ext in v's own sign, so gain = -s_v * (W@s)_v.
        s = np.where(side, -1.0, 1.0)
        gain = -s * (w @ s)
        locked = np.zeros(n, dtype=bool)
        count0 = int(n - side.sum())
        heap = [(-gain[v], v) for v in np.nonzero(gain > 0)[0]]
        # seed the heap with boundary/positive-gain vertices plus a balance
        # escape hatch: if nothing has positive gain, still consider all
        # (a pass can profit from a negative-gain move enabling later gains)
        if not heap:
            heap = [(-gain[v], v) for v in range(n)]
        heapq.heapify(heap)

        moves: List[int] = []
        cum = 0.0
        best_cum = 0.0
        best_len = 0
        while heap:
            g, v = heapq.heappop(heap)
            if locked[v]:
                continue
            if -g != gain[v]:              # stale entry — reinsert fresh
                heapq.heappush(heap, (-gain[v], v))
                continue
            new_count0 = count0 + (1 if side[v] else -1)
            if abs(new_count0 - target0) > tol_abs:
                continue                   # infeasible; drop (stays locked-out this pass)
            # apply the move
            locked[v] = True
            old_side = side[v]
            side[v] = ~old_side
            count0 = new_count0
            cum += gain[v]
            moves.append(v)
            # neighbors: w_uv flips between u's ext and int sums
            for i in range(indptr[v], indptr[v + 1]):
                u = indices[i]
                if locked[u]:
                    continue
                delta = 2.0 * data[i]
                gain[u] += delta if side[u] == old_side else -delta
                if gain[u] > 0:
                    heapq.heappush(heap, (-gain[u], u))
            if cum > best_cum:
                best_cum = cum
                best_len = len(moves)
        # roll back to the best prefix
        for v in moves[best_len:]:
            side[v] = ~side[v]
        if best_cum <= 0:
            break
    return side


def cut_weight(w: spsp.csr_matrix, side: np.ndarray) -> float:
    """Total affinity weight crossing the bisection (each edge once)."""
    s = np.where(side, -1.0, 1.0)
    # sum over edges of w_uv * [s_u != s_v] = (sum(w) - s@W@s) / 2; W symmetric
    return float((w.sum() - s @ (w @ s)) / 4.0)


def kl_assign(
    graph: CSRGraph,
    train_nids: np.ndarray,
    num_parts: int,
    hops: int,
    *,
    seed: int = 0,
    max_passes: int = 8,
    tol: float = 0.02,
) -> np.ndarray:
    """Partition id per train vertex (aligned with ``train_nids`` order)."""
    train_nids = np.asarray(train_nids, dtype=np.int64)
    w = train_affinity(graph, train_nids, hops)
    out = np.zeros(len(train_nids), dtype=np.int32)

    def rec(idx: np.ndarray, parts: int, base: int, depth: int) -> None:
        if parts <= 1 or len(idx) == 0:
            out[idx] = base
            return
        p0 = (parts + 1) // 2              # side-0 gets ceil(parts/2) parts
        target0 = int(round(len(idx) * p0 / parts))
        sub = w[idx][:, idx].tocsr()
        side = kl_bisect(sub, target0=target0, seed=seed + depth,
                         max_passes=max_passes, tol=tol)
        rec(idx[~side], p0, base, depth + 1)
        rec(idx[side], parts - p0, base + p0, depth + 1)

    rec(np.arange(len(train_nids)), num_parts, 0, 1)
    return out


def kl_partition(
    graph: CSRGraph,
    train_nids: np.ndarray,
    labels: np.ndarray,
    num_parts: int,
    hops: int,
    *,
    seed: int = 0,
    max_passes: int = 8,
    tol: float = 0.02,
) -> List[PartitionArtifact]:
    """KL-partitioned self-reliant closures (same artifact contract as
    hash/dg partitioners)."""
    belongs = kl_assign(graph, train_nids, num_parts, hops, seed=seed,
                        max_passes=max_passes, tol=tol)
    train_nids = np.asarray(train_nids, dtype=np.int64)
    return [
        extract_partition(graph, np.sort(train_nids[belongs == p]),
                          labels, hops)
        for p in range(num_parts)
    ]
