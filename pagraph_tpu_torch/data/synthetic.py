"""Synthetic graphs and datasets (a copy of the numpy paths of
``pagraph_tpu/data/synthetic.py``).

Same generators, seeds and draw order, so a seed gives the same graph,
features, labels and masks in both packages, the 2-hop teacher labels
(:func:`neighborhood_labels`, ``learnable="neighborhood"``) and the native
R-MAT CSR (:func:`rmat_csr`, the host library's generator) included.
"""
from __future__ import annotations

from typing import Optional

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


def rmat_csr(
    scale: int,
    edge_factor: int = 16,
    *,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
    backend: str = "auto",
) -> CSRGraph:
    """R-MAT graph straight to in-CSR, for graphs too large for
    :func:`rmat_coo`'s numpy bit loop.

    ``backend="native"`` draws edges with the host library's OpenMP kernel
    (``pg_rmat_gen``: one splitmix64 stream an edge; self-loops re-drawn,
    not filtered) and builds the deduplicated CSR with ``pg_coo_to_csr``:
    the R-MAT distribution of :func:`rmat_coo` from another RNG, so the two
    backends give different graphs.  ``"numpy"``: :func:`rmat_coo` and
    ``CSRGraph.from_coo``.  ``"auto"``: native if the host library builds.
    """
    if backend == "auto":
        try:
            from ..sampling.native import get_lib
            get_lib()
            backend = "native"
        except (RuntimeError, OSError):
            backend = "numpy"
    if backend == "native":
        from ..sampling.native import coo_to_csr_native, rmat_edges_native
        src, dst = rmat_edges_native(scale, (1 << scale) * edge_factor,
                                     a=a, b=b, c=c, seed=seed)
        return coo_to_csr_native(src, dst, 1 << scale)
    return CSRGraph.from_coo(rmat_coo(scale, edge_factor, a=a, b=b, c=c,
                                      seed=seed))


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


def neighborhood_labels(
    graph: CSRGraph,
    features: np.ndarray,
    num_classes: int,
    *,
    seed: int = 0,
    self_weight: float = 0.3,
    hop2_weight: float = 0.5,
    chunk_rows: Optional[int] = None,
) -> np.ndarray:
    """Labels from a 2-hop teacher, so that accuracy exercises the GNN and
    not only the per-vertex features (``argmax(x @ proj)`` labels are a
    linear probe of a vertex's own features, which a model that ignores
    its neighbors can fit).

    ``label(v) = argmax_c  w_s·z(x_v P) + 1.0·z(m¹_v Q) + w_2·z(m²_v R)``

    where ``m¹`` / ``m²`` are the exact 1-/2-hop in-neighbor mean
    aggregations (the same direction + normalization the models aggregate,
    storage/full_graph_mean_aggregate == reference pa_server.py:45-52),
    P/Q/R are independent random projections, features are centered so no
    class dominates globally, and each term is globally z-scored so the
    1/√deg variance shrink of neighbor means does not silence them.  The
    neighbor terms dominate (1.0 + 0.5 vs 0.3): a structure-blind model
    (MLP on x_v alone) only sees the self term, while a 2-layer GNN can
    represent the teacher exactly.

    ``chunk_rows``: row-chunked scoring for papers100M-class vertex counts —
    the dense path materializes two live ``[n, num_classes]`` f32 score
    matrices (25 GB each at 134M vertices / 47 classes); the chunked path
    streams them, recomputing each chunk's projections three times (mean /
    std / argmax passes, float64 moments).  Statistically identical labels;
    not bit-identical at argmax ties (summation-order float noise)."""
    from ..storage.feature_store import full_graph_mean_aggregate

    rng = np.random.default_rng(seed)
    x = np.asarray(features, dtype=np.float32)
    d = x.shape[1]
    if chunk_rows is None:
        xc = x - x.mean(axis=0, keepdims=True)
        agg1 = full_graph_mean_aggregate(graph, xc)
        agg2 = full_graph_mean_aggregate(graph, agg1)

        def term(m: np.ndarray, w: float) -> np.ndarray:
            s = m @ rng.normal(size=(d, num_classes)).astype(np.float32)
            return (w / (s.std() + 1e-8)) * s

        score = (term(xc, self_weight) + term(agg1, 1.0)
                 + term(agg2, hop2_weight))
        return np.argmax(score, axis=1).astype(np.int64)

    n = graph.num_nodes
    xc = x if x is not features else x.copy()
    xc -= xc.mean(axis=0, keepdims=True)
    agg1 = full_graph_mean_aggregate(graph, xc)
    agg2 = full_graph_mean_aggregate(graph, agg1)
    mats = [xc, agg1, agg2]
    weights = [self_weight, 1.0, hop2_weight]
    # identical draw order to the dense path: P (self), Q (1-hop), R (2-hop)
    projs = [rng.normal(size=(d, num_classes)).astype(np.float32)
             for _ in range(3)]
    total = n * num_classes
    means = np.zeros(3, dtype=np.float64)
    for lo in range(0, n, chunk_rows):
        hi = min(lo + chunk_rows, n)
        for t in range(3):
            means[t] += np.sum(mats[t][lo:hi] @ projs[t], dtype=np.float64)
    means /= total
    sqdev = np.zeros(3, dtype=np.float64)
    for lo in range(0, n, chunk_rows):
        hi = min(lo + chunk_rows, n)
        for t in range(3):
            s = (mats[t][lo:hi] @ projs[t]).astype(np.float64)
            s -= means[t]
            sqdev[t] += np.sum(s * s)
    stds = np.sqrt(sqdev / total)
    coef = np.asarray(weights) / (stds + 1e-8)
    labels = np.empty(n, dtype=np.int64)
    for lo in range(0, n, chunk_rows):
        hi = min(lo + chunk_rows, n)
        score = np.zeros((hi - lo, num_classes), dtype=np.float32)
        for t in range(3):
            score += np.float32(coef[t]) * (mats[t][lo:hi] @ projs[t])
        labels[lo:hi] = score.argmax(axis=1)
    return labels


def synthetic_dataset(
    num_nodes: int = 10_000,
    num_edges: int = 40_000,
    *,
    feat_dim: int = 600,
    num_classes: int = 60,
    kind: str = "uniform",          # uniform | rmat
    seed: int = 0,
    train_frac: float = 0.65,
    learnable=False,                # False | True/"linear" | "neighborhood"
) -> Dataset:
    """A complete in-memory dataset for tests and smoke runs.

    ``learnable``: ``False`` draws uniform-noise labels (loss cannot fall);
    ``True``/``"linear"`` labels each vertex by the argmax of a random linear
    projection of its own features; ``"neighborhood"`` by the 2-hop teacher
    (:func:`neighborhood_labels`), whose signal is dominated by neighbor
    aggregations.
    """
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
    if learnable == "neighborhood":
        labels = neighborhood_labels(graph, features, num_classes, seed=seed + 1)
    elif learnable:
        proj = rng.normal(size=(feat_dim, num_classes)).astype(np.float32)
        labels = np.argmax(features @ proj, axis=1).astype(np.int64)
    else:
        labels = rng.integers(0, num_classes, size=graph.num_nodes).astype(np.int64)
    train, val, test = random_split_masks(
        graph.num_nodes, train_frac=train_frac, seed=seed + 2
    )
    return Dataset(graph, features, labels, train, val, test)
