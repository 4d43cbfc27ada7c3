"""Scaling-efficiency benchmark: edges/s across rank counts (the port of
``pagraph_tpu/cli/scalebench.py``).

The reference has no scaling harness — its multi-GPU numbers come from
manually launching ``examples/profile/pa_gcn.py`` with different ``--gpu``
lists and comparing epoch prints (reference: examples/profile/pa_gcn.py:
104-113).  This CLI automates that: train the same workload on 1, 2, ..., N
ranks (one process and one card a rank, ``nccl``) and report per-count
edges/s plus strong-scaling efficiency against the smallest count (ideal:
N-rank edges/s = N x 1-rank edges/s, the BASELINE.md >=80% target).

``--cpu-devices N`` runs the same program as N gloo ranks on the CPU: that
validates the data-parallel *path* (partition assignment, the collectives,
lockstep epochs), not scaling: the ranks share one host's cores.

Usage:
    python -m pagraph_tpu_torch.cli.scalebench --synthetic 20000 \\
        --device-counts 1,2,4 --epochs 4
"""
from __future__ import annotations

import argparse
import copy
import json
import sys

from . import common


_edges_per_s = common.edges_per_s


def run_one(cfg, ds, num_devices: int, seed: int, feature_source: str = "cache", *,
            args=None):
    """Train the workload on ``num_devices`` ranks; return ``(edges/s,
    summary)``, rank 0's for more than one (``args`` tells the spawned ranks
    how to load the dataset and where to run)."""
    cfg = copy.deepcopy(cfg)
    cfg.partition.num_parts = num_devices
    cfg.validate()
    device = common.run_device(args) if args is not None else None
    if num_devices > 1:
        out = common.spawn_ranks(args, cfg, num_devices, seed=seed, device=device,
                                 feature_source=feature_source)
        return out["edges_per_s"], out["summary"]
    from ..train.loop import Trainer

    tr = Trainer.from_dataset(cfg, ds, seed=seed, device=device)
    try:
        summary = tr.train(cfg.train.epochs)
    finally:
        tr.close()
    return _edges_per_s(tr.epoch_metrics, cfg.train.warmup_epochs), summary


def main(argv=None):
    p = argparse.ArgumentParser(description="pagraph_tpu_torch scaling benchmark")
    p.add_argument("--dataset", type=str, default=None)
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--synthetic-edges", type=int, default=0)
    p.add_argument("--device-counts", type=str, default=None,
                   help="comma list of rank counts, e.g. 1,2,4 (default: "
                        "1..all doubling)")
    common.add_device_flags(p)
    p.add_argument("--json", action="store_true")
    p.add_argument("--feature-source", choices=["cache", "ici", "edge"],
                   default="cache",
                   help="multi-rank feature placement (see cli.train); "
                        "'edge' = partition CSR + sharded features")
    common.add_model_flags(p)
    common.add_sampler_flags(p)
    common.add_cache_flags(p)
    common.add_train_flags(p)
    common.add_partition_flags(p)
    args = p.parse_args(argv)

    common.setup_platform(fast_prng=args.fast_prng, cpu_devices=args.cpu_devices)
    from ..utils.device import resolve_device

    resolve_device(common.run_device(args))   # no card and no --cpu-devices: raises
    ds = common.load_cli_dataset(args)
    if ds is None:
        p.error("need --dataset or --synthetic")

    avail = common.available_ranks(args)
    if args.device_counts:
        counts = [int(c) for c in args.device_counts.split(",")]
    else:
        counts, c = [], 1
        while c <= avail:
            counts.append(c)
            c *= 2
    bad = [c for c in counts if c > avail]
    if bad:
        p.error(f"device counts {bad} exceed available devices ({avail})")

    cfg = common.build_config(
        args, feat_dim=ds.feat_dim, n_classes=ds.num_classes
    )
    cfg.train.epochs = args.epochs

    raw = {c: run_one(cfg, ds, c, args.seed,
                      feature_source=(args.feature_source if c > 1 else "cache"),
                      args=args)
           for c in counts}
    # per-rank baseline = the smallest count measured (1 rank when the list
    # includes 1), independent of the order counts were given in
    cmin = min(counts)
    base_eps = raw[cmin][0] / cmin
    rows = []
    for c in counts:
        eps, summary = raw[c]
        eff = eps / (base_eps * c)
        rows.append({"devices": c, "edges_per_s": eps, "efficiency": eff,
                     "final_loss": summary["final_loss"]})
        print(f"devices={c:3d}  {eps:12.0f} edges/s  "
              f"efficiency {eff:6.1%}  loss {summary['final_loss']:.4f}",
              file=sys.stderr)

    result = {"platform": "cpu" if args.cpu_devices else "gpu",
              "available_devices": avail, "runs": rows}
    if result["platform"] == "cpu":
        result["note"] = (
            "gloo ranks on the CPU share one host's cores: this validates the "
            "data-parallel program, not scaling efficiency (flat TOTAL "
            "edges/s across counts is the expected ceiling here)"
        )
    if args.json:
        print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
