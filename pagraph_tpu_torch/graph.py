"""Host-side graph structure: an in-neighbor CSR pair of numpy arrays.

A copy of ``pagraph_tpu/graph.py``, with its ``in_neighbors``, ``to_coo`` and
``subgraph``.  Orientation: ``indptr``/``indices``
index **in-neighbors** — row ``v`` lists the sources of edges ``u -> v`` —
and the feature cache ranks vertices by **out**-degree, precomputed from the
same edge set.  Sampling walks this structure on the CPU; the device only
sees fixed-shape padded index blocks (``sampling/block.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import scipy.sparse as spsp


@dataclasses.dataclass
class CSRGraph:
    """In-neighbor CSR over a compact vertex id space [0, num_nodes)."""

    indptr: np.ndarray    # int64 [N+1]
    indices: np.ndarray   # int32 [E]  in-neighbor (source) ids
    out_degrees: np.ndarray  # int32 [N]

    def __post_init__(self):
        self.indptr = np.ascontiguousarray(self.indptr, dtype=np.int64)
        self.indices = np.ascontiguousarray(self.indices, dtype=np.int32)
        self.out_degrees = np.ascontiguousarray(self.out_degrees, dtype=np.int32)

    @property
    def num_nodes(self) -> int:
        return len(self.indptr) - 1

    @property
    def num_edges(self) -> int:
        return len(self.indices)

    @property
    def in_degrees(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int32)

    def in_neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]

    @classmethod
    def from_coo(cls, coo: spsp.spmatrix, *, dedup: bool = True) -> "CSRGraph":
        """Build from a scipy sparse adjacency where ``A[dst, src] != 0``;
        duplicate edges are removed."""
        n = coo.shape[0]
        csr = coo.tocsr()
        if dedup:
            csr.sum_duplicates()
        csr.sort_indices()
        out_deg = np.bincount(csr.indices, minlength=n).astype(np.int32)
        return cls(
            indptr=csr.indptr.astype(np.int64),
            indices=csr.indices.astype(np.int32),
            out_degrees=out_deg,
        )


    def to_coo(self) -> spsp.coo_matrix:
        """The adjacency as a scipy COO matrix, ``A[dst, src] = 1``."""
        n = self.num_nodes
        csr = spsp.csr_matrix(
            (np.ones(self.num_edges, dtype=np.float32), self.indices, self.indptr),
            shape=(n, n))
        return csr.tocoo()

    def subgraph(self, nodes: np.ndarray) -> Tuple["CSRGraph", np.ndarray]:
        """Node-induced subgraph with compact relabeling: ``(sub,
        sub2full)``, ``sub2full[i]`` the full-graph id of local vertex ``i``
        (the sorted unique ``nodes``).  Edges with an endpoint outside
        ``nodes`` are dropped."""
        sub2full = np.unique(np.asarray(nodes, dtype=np.int64))
        full2sub = np.full(self.num_nodes, -1, dtype=np.int64)
        full2sub[sub2full] = np.arange(len(sub2full))
        starts = self.indptr[sub2full]
        row_lens = (self.indptr[sub2full + 1] - starts).astype(np.int64)
        total = int(row_lens.sum())
        edge_idx = np.repeat(starts, row_lens) + (
            np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(row_lens) - row_lens, row_lens))
        cand = full2sub[self.indices[edge_idx]]
        keep = cand >= 0
        kept_rows = np.repeat(np.arange(len(sub2full), dtype=np.int64), row_lens)[keep]
        indices = cand[keep].astype(np.int32)
        indptr = np.zeros(len(sub2full) + 1, dtype=np.int64)
        np.cumsum(np.bincount(kept_rows, minlength=len(sub2full)), out=indptr[1:])
        out_deg = np.bincount(indices, minlength=len(sub2full)).astype(np.int32)
        return CSRGraph(indptr=indptr, indices=indices, out_degrees=out_deg), sub2full


def gcn_norm(graph: CSRGraph, eps: float = 0.0) -> np.ndarray:
    """GCN normalization 1/in_degree (``eps`` where the in-degree is 0)."""
    deg = graph.in_degrees.astype(np.float32)
    norm = 1.0 / np.maximum(deg, 1.0)
    norm[deg == 0] = eps
    return norm
