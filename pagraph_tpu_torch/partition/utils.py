"""Hop-closure extraction for self-reliant partitions (the port of
``pagraph_tpu/partition/utils.py``).

Self-reliance (PaGraph, SoCC'20 section 4): a partition holds every vertex
within ``hops`` in-neighbor steps of its train vertices, and every vertex at
depth < ``hops`` keeps all its in-edges, so ``hops``-level neighbor
sampling on the local subgraph draws what it would draw on the full graph.
The closure is a vectorized frontier expansion over the host CSR
(``backend="numpy"``) or the host library's bitmap BFS and OpenMP row fill
(``"native"``), with identical results; ``"auto"`` takes the native one
when the host library builds.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..data.formats import PartitionArtifact
from ..graph import CSRGraph


def _all_in_neighbors(graph: CSRGraph, nodes: np.ndarray) -> np.ndarray:
    """Concatenated in-neighbors of ``nodes`` (with duplicates)."""
    starts = graph.indptr[nodes]
    lens = (graph.indptr[nodes + 1] - starts).astype(np.int64)
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    idx = np.repeat(starts, lens) + (
        np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(lens) - lens, lens))
    return graph.indices[idx].astype(np.int64)


def native_ok() -> bool:
    """Whether the host library builds and loads here."""
    try:
        from ..sampling.native import get_lib
        get_lib()
        return True
    except (RuntimeError, OSError):
        return False


def _backend(backend: str) -> str:
    if backend == "auto":
        return "native" if native_ok() else "numpy"
    if backend not in ("numpy", "native"):
        raise ValueError(f"unknown backend {backend!r}")
    return backend


def hop_closure(graph: CSRGraph, seeds: np.ndarray, hops: int,
                *, backend: str = "auto") -> Tuple[np.ndarray, np.ndarray]:
    """``(closure_nodes, interior_nodes)``, sorted int64: every vertex
    within ``hops`` in-steps of ``seeds``, and those within ``hops - 1``
    (which keep their full in-edge lists)."""
    if _backend(backend) == "native" and hops > 0:
        from ..sampling.native import hop_closure_native
        return hop_closure_native(graph, seeds, hops)
    seeds = np.unique(np.asarray(seeds, dtype=np.int64))
    visited = frontier = interior = seeds
    for depth in range(hops):
        nbrs = np.unique(_all_in_neighbors(graph, frontier))
        frontier = np.setdiff1d(nbrs, visited, assume_unique=True)
        visited = np.union1d(visited, frontier)
        if depth < hops - 1:
            interior = visited
    return visited, interior


def extract_partition(graph: CSRGraph, train_nids: np.ndarray, labels: np.ndarray,
                      hops: int, *, backend: str = "auto") -> PartitionArtifact:
    """One self-reliant partition: the closure relabelled compactly (local
    id = rank in the sorted closure), keeping every in-edge of the interior
    (depth < ``hops``) vertices and none of the others'."""
    backend = _backend(backend)
    closure, interior = hop_closure(graph, train_nids, hops, backend=backend)
    sub2full = closure
    full2sub = np.full(graph.num_nodes, -1, dtype=np.int64)
    full2sub[sub2full] = np.arange(len(sub2full))
    interior_local = full2sub[interior]
    counts = np.zeros(len(sub2full), dtype=np.int64)
    lens = (graph.indptr[interior + 1] - graph.indptr[interior]).astype(np.int64)
    counts[interior_local] = lens
    indptr = np.zeros(len(sub2full) + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    if backend == "native":
        from ..sampling.native import histogram_i32_native, map_rows_native
        indices = map_rows_native(graph, full2sub, interior, indptr[interior_local],
                                  int(lens.sum()))
        out_deg = histogram_i32_native(indices, len(sub2full))
    else:
        indices = full2sub[_all_in_neighbors(graph, interior)].astype(np.int32)
        if not (indices >= 0).all():
            raise ValueError("closure must contain all interior in-neighbors")
        out_deg = np.bincount(indices, minlength=len(sub2full)).astype(np.int32)
    sub = CSRGraph(indptr=indptr, indices=indices, out_degrees=out_deg)
    return PartitionArtifact(
        graph=sub,
        train_nids=np.sort(full2sub[np.asarray(train_nids, dtype=np.int64)]),
        local2full=sub2full,
        labels=np.asarray(labels, dtype=np.int64)[sub2full],
    )


def partition_stats(parts: List[PartitionArtifact], num_nodes: int) -> dict:
    """Vertices and train vertices a part, and the replication factor (the
    parts' vertices over the graph's)."""
    return {
        "num_parts": len(parts),
        "vertices_per_part": [p.num_nodes for p in parts],
        "train_per_part": [len(p.train_nids) for p in parts],
        "replication_factor": sum(p.num_nodes for p in parts) / max(num_nodes, 1),
    }
