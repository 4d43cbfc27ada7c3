"""Partition verification: invariant checks + optional drawing (the port of
``pagraph_tpu/cli/verify_partition.py``; host code, no device).

Replaces the reference's manual networkx eyeballing
(reference: PaGraph/partition/verify.py:9-26) with machine-checkable
invariants, plus the same drawing when matplotlib and networkx are
installed (without them ``--plot`` prints "plotting unavailable" and the
checks alone decide the exit code).

    python -m pagraph_tpu_torch.cli.verify_partition --dataset <dir> \\
        --partition P --method dg --num-hops H [--plot out.png]

Prints one JSON line, ``{"partitions": [...], "coverage_ok": ...}``, and
exits 1 when a check fails.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def check_partition(ds, part, hops: int, sample: int = 200) -> dict:
    """Self-reliance + id-map invariants for one partition artifact."""
    g, l2f = part.graph, part.local2full
    errors = []
    if len(np.unique(l2f)) != len(l2f):
        errors.append("local2full has duplicate entries")
    if (l2f >= ds.num_nodes).any():
        errors.append("local2full out of range")
    if not np.array_equal(part.labels, ds.labels[l2f]):
        errors.append("labels do not match full-graph labels through the map")
    full_train = set(np.nonzero(ds.train_mask)[0].tolist())
    if not all(int(l2f[t]) in full_train for t in part.train_nids):
        errors.append("train ids map to non-train vertices")
    # frontier walk: all in-edges of depth<hops vertices must be local
    rng = np.random.default_rng(0)
    frontier = part.train_nids
    for depth in range(hops):
        probe = frontier if len(frontier) <= sample else rng.choice(
            frontier, size=sample, replace=False)
        nxt = []
        for lv in probe:
            full_nbrs = np.sort(ds.graph.in_neighbors(l2f[lv]))
            local_nbrs = np.sort(l2f[g.in_neighbors(lv)])
            if not np.array_equal(full_nbrs, local_nbrs):
                errors.append(f"vertex {int(l2f[lv])} at depth {depth} missing in-edges")
                break
            nxt.extend(g.in_neighbors(lv))
        frontier = (np.unique(np.array(nxt, dtype=np.int64)) if nxt
                    else np.array([], np.int64))
        if len(frontier) == 0:
            break
    return {"ok": not errors, "errors": errors,
            "vertices": part.num_nodes, "train": len(part.train_nids)}


def draw_partitions(ds, parts, out_path: str) -> None:
    """Color vertices by partition, highlight train vertices
    (reference verify.py draw_graph)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import networkx as nx

    coo = ds.graph.to_coo()
    G = nx.DiGraph()
    G.add_nodes_from(range(ds.num_nodes))
    G.add_edges_from(zip(coo.col.tolist(), coo.row.tolist()))
    owner = np.full(ds.num_nodes, -1)
    for pid, part in enumerate(parts):
        owner[part.local2full[part.train_nids]] = pid
    pos = nx.spring_layout(G, seed=0)
    cmap = plt.cm.tab10
    colors = [cmap(owner[v] % 10) if owner[v] >= 0 else (0.8, 0.8, 0.8, 0.5)
              for v in range(ds.num_nodes)]
    sizes = [30 if ds.train_mask[v] else 8 for v in range(ds.num_nodes)]
    plt.figure(figsize=(10, 10))
    nx.draw_networkx(G, pos, node_color=colors, node_size=sizes,
                     with_labels=False, arrows=False, width=0.2)
    plt.savefig(out_path, dpi=120, bbox_inches="tight")
    print(f"wrote {out_path}", file=sys.stderr)


def main(argv=None):
    p = argparse.ArgumentParser(description="verify partition artifacts")
    p.add_argument("--dataset", type=str, required=True)
    p.add_argument("--partition", type=int, default=2)
    p.add_argument("--method", choices=["dg", "hash", "kl"], default="dg")
    p.add_argument("--num-hops", type=int, default=1)
    p.add_argument("--plot", type=str, default=None,
                   help="write a colored graph drawing (small graphs only)")
    args = p.parse_args(argv)

    from ..data.formats import load_dataset, load_partition, partition_dir

    ds = load_dataset(args.dataset)
    pdir = partition_dir(args.dataset, args.partition, args.method)
    parts = [load_partition(pdir, r) for r in range(args.partition)]
    results = [check_partition(ds, part, args.num_hops) for part in parts]
    covered = np.sort(np.concatenate([p_.local2full[p_.train_nids] for p_ in parts]))
    coverage_ok = np.array_equal(covered, np.nonzero(ds.train_mask)[0])
    out = {"partitions": results, "coverage_ok": bool(coverage_ok)}
    if args.plot:
        try:
            draw_partitions(ds, parts, args.plot)
        except ImportError as e:
            print(f"plotting unavailable: {e}", file=sys.stderr)
    print(json.dumps(out))
    if not (coverage_ok and all(r["ok"] for r in results)):
        sys.exit(1)


if __name__ == "__main__":
    main()
