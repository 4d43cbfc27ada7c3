"""Dataset preparation CLI: edge list / generator -> dataset directory (the
port of ``pagraph_tpu/cli/preprocess.py``; host code, no device).

Covers the reference's offline tooling (reference: PaGraph/data/
preprocess.py:117-184, gen_dataset.py:7-35; PaRMAT usage README.md:36-49):

    # convert an edge-list file (one "src dst" pair per line)
    python -m pagraph_tpu_torch.cli.preprocess --out <dir> --ppfile edges.txt

    # generate a uniform G(n,m) or RMAT graph
    python -m pagraph_tpu_torch.cli.preprocess --out <dir> --gen uniform \\
        --vnum 10000 --enum 40000
    python -m pagraph_tpu_torch.cli.preprocess --out <dir> --gen rmat --scale 20

The same arguments write the same files as the JAX package's command.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description="pagraph_tpu_torch dataset prep")
    p.add_argument("--out", type=str, required=True, help="output dataset dir")
    p.add_argument("--ppfile", type=str, default=None,
                   help="edge-list text file (src dst per line)")
    p.add_argument("--gen", choices=["uniform", "rmat"], default=None)
    p.add_argument("--vnum", type=int, default=10000)
    p.add_argument("--enum", type=int, default=0, help="0 = 4x vnum")
    p.add_argument("--scale", type=int, default=20, help="rmat: 2^scale vertices")
    p.add_argument("--edge-factor", type=int, default=16)
    p.add_argument("--feat-size", type=int, default=600)
    p.add_argument("--num-classes", type=int, default=60)
    p.add_argument("--train-frac", type=float, default=0.65)
    p.add_argument("--val-frac", type=float, default=0.10)
    p.add_argument("--directed", action="store_true",
                   help="keep the edge list directed (default symmetrize)")
    p.add_argument("--learnable-labels", action="store_true",
                   help="labels from a random projection of features "
                        "(structure-FREE: an MLP solves them; use "
                        "--neighborhood-labels to test the GNN)")
    p.add_argument("--neighborhood-labels", action="store_true",
                   help="labels from a 2-hop teacher dominated by neighbor "
                        "means (data/synthetic.neighborhood_labels) — "
                        "accuracy on them certifies the aggregation path")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from ..utils.platform import tune_host_allocator
    tune_host_allocator(1 << 30)

    import scipy.sparse as spsp

    from ..data.formats import Dataset, save_dataset
    from ..data.synthetic import (neighborhood_labels, random_coo, random_split_masks,
                                  rmat_coo)
    from ..graph import CSRGraph

    if args.ppfile:
        # pp2adj (reference preprocess.py:11-47): edge list -> adjacency
        edges = np.loadtxt(args.ppfile, dtype=np.int64, comments=["#", "%"])
        src, dst = edges[:, 0], edges[:, 1]
        n = int(max(src.max(), dst.max())) + 1
        if not args.directed:
            src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        coo = spsp.coo_matrix(
            (np.ones(len(src), dtype=np.float32), (dst, src)), shape=(n, n))
    elif args.gen == "uniform":
        coo = random_coo(args.vnum, args.enum or 4 * args.vnum, seed=args.seed)
    elif args.gen == "rmat":
        coo = rmat_coo(args.scale, args.edge_factor, seed=args.seed)
    else:
        p.error("need --ppfile or --gen")

    graph = CSRGraph.from_coo(coo)
    n = graph.num_nodes
    rng = np.random.default_rng(args.seed + 1)
    feats = rng.random((n, args.feat_size), dtype=np.float32)
    if args.neighborhood_labels:
        labels = neighborhood_labels(graph, feats, args.num_classes, seed=args.seed + 1)
    elif args.learnable_labels:
        proj = rng.normal(size=(args.feat_size, args.num_classes)).astype(np.float32)
        labels = np.argmax(feats @ proj, axis=1).astype(np.int64)
    else:
        labels = rng.integers(0, args.num_classes, size=n).astype(np.int64)
    train, val, test = random_split_masks(
        n, train_frac=args.train_frac, val_frac=args.val_frac, seed=args.seed + 2)
    save_dataset(args.out, Dataset(graph, feats, labels, train, val, test))
    print(f"wrote {args.out}: {n} vertices, {graph.num_edges} edges, "
          f"feat {args.feat_size}, {args.num_classes} classes", file=sys.stderr)


if __name__ == "__main__":
    main()
