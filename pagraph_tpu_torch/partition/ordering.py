"""Locality reordering (the port of ``pagraph_tpu/partition/ordering.py``):
relabel vertices so that high in-degree hubs and their neighborhoods are
contiguous.  Vertices are visited in descending in-degree order and each
one's unvisited in-neighbors are placed right after it; ``cluster=False``
is the plain in-degree sort.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as spsp

from ..data.formats import Dataset
from ..graph import CSRGraph


def reorder_map(graph: CSRGraph, *, cluster: bool = True) -> np.ndarray:
    """Return ``vmap``: old id -> new id."""
    n = graph.num_nodes
    order = np.argsort(-graph.in_degrees, kind="stable")
    vmap = np.full(n, -1, dtype=np.int64)
    if not cluster:
        vmap[order] = np.arange(n)
        return vmap
    nxt = 0
    for v in order:
        if vmap[v] == -1:
            vmap[v] = nxt
            nxt += 1
        for u in graph.in_neighbors(v):
            if vmap[u] == -1:
                vmap[u] = nxt
                nxt += 1
    return vmap


def apply_reordering(ds: Dataset, vmap: np.ndarray) -> Dataset:
    """Relabel a whole dataset (the reference rewrites its files in place,
    dg.py:126-138; we return a new Dataset)."""
    n = ds.graph.num_nodes
    inv = np.empty(n, dtype=np.int64)      # new id -> old id
    inv[vmap] = np.arange(n)
    coo = ds.graph.to_coo()
    new_coo = spsp.coo_matrix(
        (coo.data, (vmap[coo.row], vmap[coo.col])), shape=(n, n)
    )
    return Dataset(
        graph=CSRGraph.from_coo(new_coo),
        features=np.asarray(ds.features)[inv],
        labels=ds.labels[inv],
        train_mask=ds.train_mask[inv],
        val_mask=ds.val_mask[inv],
        test_mask=ds.test_mask[inv],
    )
