"""Computation-aware greedy partitioner, "dg", the PaGraph algorithm (the
port of ``pagraph_tpu/partition/dg_part.py``).

Train vertices are streamed in order; each is scored against every
partition

    score[p] = (1 + |N_hops(v) & assigned_p|) * (avg - p_vnum[p]) / (r_vnum[p] + 1)

where ``assigned_p`` counts already-assigned train vertices, ``p_vnum`` the
partition's train count (or weight), ``r_vnum`` its closure's size, and
``avg = train_frac * V / P`` the balance target.  Ties go to the smaller
partition, the first on equal size.  ``edge_balance`` weights each train
vertex by ``in_deg(v) + 1`` and sets ``avg`` to the mean weight a partition,
balancing the parts' future CSR edges instead of their train vertices.

``backend="native"`` runs the stream in the host library
(``pg_dg_assign``), bit-identical to the numpy stream; ``"auto"`` takes it
when the library builds and falls back to numpy only if it cannot (a data
error raises).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..data.formats import PartitionArtifact
from ..graph import CSRGraph
from .utils import _all_in_neighbors, _backend, extract_partition


def _hop_neighbors(graph: CSRGraph, nid: int, hops: int) -> np.ndarray:
    """Every vertex within ``hops`` in-steps of ``nid``, ``nid`` excluded."""
    frontier = np.array([nid], dtype=np.int64)
    seen = frontier
    for _ in range(hops):
        nbrs = np.unique(_all_in_neighbors(graph, frontier))
        frontier = np.setdiff1d(nbrs, seen, assume_unique=True)
        if len(frontier) == 0:
            break
        seen = np.union1d(seen, frontier)
    return np.setdiff1d(seen, np.array([nid]), assume_unique=True)


def dg_assign(graph: CSRGraph, train_nids: np.ndarray, num_parts: int, hops: int, *,
              train_frac: Optional[float] = None, backend: str = "auto",
              edge_balance: bool = False) -> np.ndarray:
    """``belongs``: the partition of each train vertex (int32, aligned with
    ``train_nids``'s order)."""
    n = graph.num_nodes
    train_nids = np.asarray(train_nids, dtype=np.int64)
    weights = None
    if edge_balance:
        weights = graph.in_degrees[train_nids].astype(np.float64) + 1.0
        avg = float(weights.sum()) / num_parts
    else:
        if train_frac is None:
            train_frac = len(train_nids) / max(n, 1)
        avg = train_frac * n / num_parts
    if _backend(backend) == "native":
        from ..sampling.native import dg_assign_native
        return dg_assign_native(graph, train_nids, num_parts, hops, avg, weights)

    train_belongs = np.full(n, -1, dtype=np.int32)       # train vertex -> part
    in_closure = np.zeros((num_parts, n), dtype=bool)    # each part's closure
    p_vnum = np.zeros(num_parts, dtype=np.float64)
    r_vnum = np.zeros(num_parts, dtype=np.int64)
    out = np.empty(len(train_nids), dtype=np.int32)
    for i, nid in enumerate(train_nids):
        neigh = _hop_neighbors(graph, int(nid), hops)
        com = np.ones(num_parts, dtype=np.float64)
        if len(neigh):
            nb = train_belongs[neigh]
            com += np.bincount(nb[nb >= 0], minlength=num_parts)
        score = com * (avg - p_vnum) / (r_vnum + 1)
        tied = np.nonzero(score == score.max())[0]
        p = tied[np.argmin(p_vnum[tied])]
        out[i] = p
        train_belongs[nid] = p
        p_vnum[p] += weights[i] if weights is not None else 1.0
        members = np.append(neigh, nid)
        r_vnum[p] += int((~in_closure[p, members]).sum())
        in_closure[p, members] = True
    return out


def dg_partition(graph: CSRGraph, train_nids: np.ndarray, labels: np.ndarray,
                 num_parts: int, hops: int, *, train_frac: Optional[float] = None,
                 backend: str = "auto", edge_balance: bool = False) -> List[PartitionArtifact]:
    """:func:`dg_assign`, then each part's self-reliant closure."""
    belongs = dg_assign(graph, train_nids, num_parts, hops, train_frac=train_frac,
                        backend=backend, edge_balance=edge_balance)
    train_nids = np.asarray(train_nids)
    return [extract_partition(graph, np.sort(train_nids[belongs == p]), labels, hops,
                              backend=backend)
            for p in range(num_parts)]
