"""PaGraph's self-reliant partition of a set of train vertices, in plain
torch (SoCC'20, section 4): every vertex within ``hops`` in-neighbor steps
of the train vertices, relabelled by rank in sorted order; the vertices
nearer than ``hops`` keep all their in-edges, in the graph's order, and the
outermost ring keeps none.  Sampling ``hops`` levels from the train
vertices on it draws what it would draw on the whole graph."""
from __future__ import annotations

from typing import Tuple

import torch


def in_neighbors(indptr: torch.Tensor, indices: torch.Tensor, nodes: torch.Tensor) -> torch.Tensor:
    """The in-neighbors of ``nodes``, row after row (int64)."""
    starts = indptr[nodes]
    lens = indptr[nodes + 1] - starts
    total = int(lens.sum())
    if not total:
        return torch.zeros(0, dtype=torch.int64, device=indptr.device)
    base = torch.repeat_interleave(starts - torch.cumsum(lens, 0) + lens, lens)
    return indices[base + torch.arange(total, device=indptr.device)].long()


def closure(indptr: torch.Tensor, indices: torch.Tensor, train: torch.Tensor, hops: int
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(local2full, indptr, indices, train_local)`` of the partition of
    ``train`` (full ids), on the graph's device."""
    seen = frontier = inner = torch.unique(train.long())
    for depth in range(hops):
        nbrs = torch.unique(in_neighbors(indptr, indices, frontier))
        frontier = nbrs[~torch.isin(nbrs, seen)]
        seen = torch.sort(torch.cat([seen, frontier])).values
        if depth < hops - 1:
            inner = seen
    full2local = torch.full((indptr.shape[0] - 1,), -1, dtype=torch.int64, device=seen.device)
    full2local[seen] = torch.arange(seen.shape[0], device=seen.device)
    keep = torch.zeros(seen.shape[0], dtype=torch.bool, device=seen.device)
    keep[full2local[inner]] = True
    lens = torch.where(keep, indptr[seen + 1] - indptr[seen], 0)
    local_indptr = torch.zeros(seen.shape[0] + 1, dtype=torch.int64, device=seen.device)
    torch.cumsum(lens, 0, out=local_indptr[1:])
    local_indices = full2local[in_neighbors(indptr, indices, seen[keep])]
    if bool((local_indices < 0).any()):
        raise ValueError("an interior in-neighbor lies outside the closure")
    train_local = torch.sort(full2local[train.long()]).values
    return seen, local_indptr, local_indices, train_local
