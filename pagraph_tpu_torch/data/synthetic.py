"""Synthetic graphs and datasets (a copy of the numpy paths of
``pagraph_tpu/data/synthetic.py``).

Same generators, seeds and draw order, so a seed gives the same graph,
features, labels and masks in both packages.  The 2-hop teacher labels
(``learnable="neighborhood"``) need ``full_graph_mean_aggregate``, which is
not ported yet.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as spsp

from ..graph import CSRGraph
from .formats import Dataset


def random_coo(
    num_nodes: int,
    num_edges: int,
    *,
    seed: int = 0,
    self_loops: bool = False,
) -> spsp.coo_matrix:
    """Uniform directed G(n, m) multigraph edges, ``A[dst, src]``."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, num_nodes, size=num_edges, dtype=np.int64)
    dst = rng.integers(0, num_nodes, size=num_edges, dtype=np.int64)
    if not self_loops:
        keep = src != dst
        src, dst = src[keep], dst[keep]
    data = np.ones(len(src), dtype=np.float32)
    return spsp.coo_matrix((data, (dst, src)), shape=(num_nodes, num_nodes))


def rmat_coo(
    scale: int,
    edge_factor: int = 16,
    *,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
) -> spsp.coo_matrix:
    """R-MAT power-law graph: 2**scale vertices, edge_factor * V edge draws
    (self-loops dropped), by vectorized recursive quadrant descent with the
    Graph500 parameters."""
    n = 1 << scale
    m = n * edge_factor
    rng = np.random.default_rng(seed)
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for _ in range(scale):
        r = rng.random(m)
        src_bit = (r >= a + b).astype(np.int64)
        dst_bit = (((r >= a) & (r < a + b)) | (r >= a + b + c)).astype(np.int64)
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    keep = src != dst
    src, dst = src[keep], dst[keep]
    data = np.ones(len(src), dtype=np.float32)
    return spsp.coo_matrix((data, (dst, src)), shape=(n, n))


def random_split_masks(
    num_nodes: int,
    *,
    train_frac: float = 0.65,
    val_frac: float = 0.10,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Random 65/10/25 train/val/test split."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(num_nodes)
    n_train = int(num_nodes * train_frac)
    n_val = int(num_nodes * val_frac)
    train = np.zeros(num_nodes, dtype=bool)
    val = np.zeros(num_nodes, dtype=bool)
    test = np.zeros(num_nodes, dtype=bool)
    train[perm[:n_train]] = True
    val[perm[n_train:n_train + n_val]] = True
    test[perm[n_train + n_val:]] = True
    return train, val, test


def synthetic_dataset(
    num_nodes: int = 10_000,
    num_edges: int = 40_000,
    *,
    feat_dim: int = 600,
    num_classes: int = 60,
    kind: str = "uniform",          # uniform | rmat
    seed: int = 0,
    train_frac: float = 0.65,
    learnable=False,                # False | True/"linear"
) -> Dataset:
    """A complete in-memory dataset for tests and smoke runs.

    ``learnable``: ``False`` draws uniform-noise labels (loss cannot fall);
    ``True``/``"linear"`` labels each vertex by the argmax of a random linear
    projection of its own features.
    """
    if learnable == "neighborhood":
        raise NotImplementedError(
            "neighborhood teacher labels need full_graph_mean_aggregate, "
            "which the port does not have yet (ROADMAP queue 1)")
    if kind == "uniform":
        coo = random_coo(num_nodes, num_edges, seed=seed)
    elif kind == "rmat":
        scale = int(np.ceil(np.log2(max(num_nodes, 2))))
        coo = rmat_coo(scale, max(1, num_edges // (1 << scale)), seed=seed)
    else:
        raise ValueError(f"unknown kind {kind!r}")
    graph = CSRGraph.from_coo(coo)
    rng = np.random.default_rng(seed + 1)
    features = rng.random((graph.num_nodes, feat_dim), dtype=np.float32)
    if learnable:
        proj = rng.normal(size=(feat_dim, num_classes)).astype(np.float32)
        labels = np.argmax(features @ proj, axis=1).astype(np.int64)
    else:
        labels = rng.integers(0, num_classes, size=graph.num_nodes).astype(np.int64)
    train, val, test = random_split_masks(
        graph.num_nodes, train_frac=train_frac, seed=seed + 2
    )
    return Dataset(graph, features, labels, train, val, test)
