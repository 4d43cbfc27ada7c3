"""Host-side graph structure: an in-neighbor CSR pair of numpy arrays.

A copy of ``pagraph_tpu/graph.py``.  Orientation: ``indptr``/``indices``
index **in-neighbors** — row ``v`` lists the sources of edges ``u -> v`` —
and the feature cache ranks vertices by **out**-degree, precomputed from the
same edge set.  Sampling walks this structure on the CPU; the device only
sees fixed-shape padded index blocks (``sampling/block.py``).
"""
from __future__ import annotations

import dataclasses

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


def gcn_norm(graph: CSRGraph, eps: float = 0.0) -> np.ndarray:
    """GCN normalization 1/in_degree (``eps`` where the in-degree is 0)."""
    deg = graph.in_degrees.astype(np.float32)
    norm = 1.0 / np.maximum(deg, 1.0)
    norm[deg == 0] = eps
    return norm
