"""External dataset converters -> dataset directories (the port of
``pagraph_tpu/cli/convert.py``; host code, no device).

Covers the reference's ``dgl2pagraph.py`` (Reddit -> 6-file format,
reference: PaGraph/data/dgl2pagraph.py:11-39) generalized to sources read
from local disk:

  * ``--from-dgl-reddit DIR``: a downloaded DGL Reddit payload
    (``reddit_data.npz`` + ``reddit_graph.npz``);
  * ``--from-ogb DIR``: an extracted OGB node-property dataset directory in
    the numpy-processed layout (``edge_index.npy`` or ``edge.npy``,
    ``node_feat.npy`` or ``x.npy``, ``node_label.npy`` or ``y.npy``, and
    an optional ``split/``);
  * ``--from-npz FILE``: any scipy adjacency + optional feat/label .npy
    files alongside.

All converters validate shapes and emit the standard directory consumed by
every other CLI, the same files as the JAX package's command.  Nothing is
downloaded: inputs must already be on disk.

    python -m pagraph_tpu_torch.cli.convert --out <dir> --from-npz adj.npz
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import scipy.sparse as spsp


def _finish(out, coo, feats, labels, train, val, test):
    from ..data.formats import Dataset, save_dataset
    from ..graph import CSRGraph

    graph = CSRGraph.from_coo(coo)
    n = graph.num_nodes
    for name, arr in [("features", feats), ("labels", labels),
                      ("train", train), ("val", val), ("test", test)]:
        if arr.shape[0] != n:
            raise ValueError(f"{name} has {arr.shape[0]} rows, graph has {n}")
    ds = Dataset(graph, feats.astype(np.float32), labels.astype(np.int64),
                 train.astype(bool), val.astype(bool), test.astype(bool))
    save_dataset(out, ds)
    print(f"wrote {out}: {n} vertices, {graph.num_edges} edges, "
          f"feat {feats.shape[1]}, {int(labels.max()) + 1} classes", file=sys.stderr)


def convert_dgl_reddit(src: str, out: str) -> None:
    """reddit_data.npz: feature/label/node_types; reddit_graph.npz: scipy
    adjacency (the payload DGL's RedditDataset downloads)."""
    data = np.load(os.path.join(src, "reddit_data.npz"))
    coo = spsp.load_npz(os.path.join(src, "reddit_graph.npz")).tocoo()
    types = data["node_types"]
    _finish(out, coo, data["feature"], data["label"], types == 1, types == 2, types == 3)


def convert_ogb(src: str, out: str) -> None:
    """Extracted OGB node-property layout (processed numpy variant)."""
    def find(*names):
        for name in names:
            p = os.path.join(src, name)
            if os.path.exists(p):
                return p
        raise FileNotFoundError(f"none of {names} under {src}")

    edges = np.load(find("edge_index.npy", "edge.npy"))
    if edges.shape[0] == 2:
        src_ids, dst_ids = edges[0], edges[1]
    else:
        src_ids, dst_ids = edges[:, 0], edges[:, 1]
    feats = np.load(find("node_feat.npy", "x.npy"))
    labels = np.load(find("node_label.npy", "y.npy")).reshape(-1)
    n = feats.shape[0]
    coo = spsp.coo_matrix(
        (np.ones(len(src_ids), np.float32), (dst_ids, src_ids)), shape=(n, n))
    split_dir = os.path.join(src, "split")
    if os.path.isdir(split_dir):
        def mask(name):
            m = np.zeros(n, dtype=bool)
            m[np.load(os.path.join(split_dir, name))] = True
            return m
        train, val, test = mask("train.npy"), mask("valid.npy"), mask("test.npy")
    else:
        from ..data.synthetic import random_split_masks
        train, val, test = random_split_masks(n, seed=0)
    _finish(out, coo, feats, labels, train, val, test)


def convert_npz(adj_path: str, out: str) -> None:
    from ..data.synthetic import random_split_masks

    base = os.path.dirname(adj_path)
    coo = spsp.load_npz(adj_path).tocoo()
    n = coo.shape[0]

    def opt(name, default):
        p = os.path.join(base, name)
        return np.load(p) if os.path.exists(p) else default

    rng = np.random.default_rng(0)
    feats = opt("feat.npy", rng.random((n, 600), dtype=np.float32))
    labels = opt("labels.npy", rng.integers(0, 60, size=n))
    train, val, test = random_split_masks(n, seed=0)
    _finish(out, coo, feats, labels, opt("train.npy", train), opt("val.npy", val),
            opt("test.npy", test))


def main(argv=None):
    p = argparse.ArgumentParser(description="convert external datasets")
    p.add_argument("--out", type=str, required=True)
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--from-dgl-reddit", type=str)
    g.add_argument("--from-ogb", type=str)
    g.add_argument("--from-npz", type=str)
    args = p.parse_args(argv)

    from ..utils.platform import tune_host_allocator
    tune_host_allocator(1 << 30)
    if args.from_dgl_reddit:
        convert_dgl_reddit(args.from_dgl_reddit, args.out)
    elif args.from_ogb:
        convert_ogb(args.from_ogb, args.out)
    else:
        convert_npz(args.from_npz, args.out)


if __name__ == "__main__":
    main()
