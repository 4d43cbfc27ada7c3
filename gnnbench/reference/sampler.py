"""Uniform neighbor sampling with replacement, without deduplication, in
plain torch.

Per destination vertex of in-degree ``d`` and fan-out ``f``: ``d == 0``,
every slot empty; ``d <= f``, slot ``k < d`` takes the ``k``-th in-neighbor
and the rest are empty; ``d > f``, slot ``k`` takes in-neighbor ``draw[k] %
d``.  A destination that is itself empty (a padded seed, an empty slot of
the hop before) has every slot empty; an empty slot holds vertex 0.  Layer
``i`` is layer ``i + 1`` followed by its sampled neighbors, so each inner
layer is a prefix of the outer one.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def sample_layers(indptr: torch.Tensor, indices: torch.Tensor, seeds: torch.Tensor,
                  seed_mask: torch.Tensor, hop_fanouts: Sequence[int],
                  draws: Sequence[torch.Tensor]) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``[(ids int64, mask bool), ...]``, outermost layer first, seeds last.
    ``indptr`` int64 ``[N + 1]``, ``indices`` ``[E]``; ``draws[h]`` ``[rows
    of hop h, f_h]``."""
    e = indices.shape[0]
    cur, curm = seeds.long(), seed_mask.bool()
    layers = [(cur, curm)]
    for f, dr in zip(hop_fanouts, draws):
        start = indptr[cur]
        deg = indptr[cur + 1] - start
        k = torch.arange(f, device=cur.device)[None, :]
        small = deg[:, None] <= f
        valid = torch.where(small, k < deg[:, None], deg[:, None] > 0) & curm[:, None]
        off = torch.where(small, k.expand(cur.shape[0], f),
                          dr.long() % deg.clamp(min=1)[:, None])
        pos = (start[:, None] + off).clamp(max=max(e - 1, 0))
        nbr = torch.where(valid, indices[pos].long(), 0) if e else torch.zeros_like(pos)
        cur = torch.cat([cur, nbr.reshape(-1)])
        curm = torch.cat([curm, valid.reshape(-1)])
        layers.append((cur, curm))
    return layers[::-1]


def valid_edge_count(layers: Sequence[Tuple[torch.Tensor, torch.Tensor]]) -> int:
    """Valid sampled edges of a batch: the valid slots of every hop."""
    return int(sum(m[inner.shape[0]:].sum().item()
                   for (_, m), (inner, _) in zip(layers[:-1], layers[1:])))


def valid_vertex_count(layers: Sequence[Tuple[torch.Tensor, torch.Tensor]]) -> int:
    """Valid rows of every layer of a batch."""
    return int(sum(m.sum().item() for _, m in layers))
