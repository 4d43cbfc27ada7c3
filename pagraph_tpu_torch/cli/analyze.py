"""Analysis / microbenchmark CLI (the port of ``pagraph_tpu/cli/analyze.py``).

Subcommands mirroring the reference's analysis scripts:

    count-vnum     vertices + edges loaded per epoch
                   (reference: examples/count_vnum.py:16-44)
    cache-oracle   hit-rate upper bound if the top-X% hottest vertices were
                   cached, from an access-frequency replay
                   (reference: examples/opt_cache_hit.py:22-58)
    load-break     per-batch breakdown: sample vs host-gather vs H2D
                   (reference: examples/load_break.py:64-78, dgl_pure.py)

    python -m pagraph_tpu_torch.cli.analyze count-vnum --dataset <dir> ...
    python -m pagraph_tpu_torch.cli.analyze load-break --dataset <dir> \\
        --cache-capacity 400000 [--cpu-devices 1]

``count-vnum`` and ``cache-oracle`` are host code.  ``load-break`` ships
each batch and its cache plan to the card (``MiniBatch.to`` and the plan's
``src_row`` and ``miss_feats``) and waits for the copies; under
``--cpu-devices`` it runs on the CPU.  ``--cache-capacity 0`` is an empty
cache (every lookup a miss).  The plan is the port's (``src_row``, not the
JAX package's ``hit_mask``/``cache_pos``/``miss_slot``), so the bytes
shipped differ; the keys, the batches and the miss rate are the JAX
package's.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from . import common


def _load(args):
    from ..data.formats import load_dataset
    from ..data.synthetic import synthetic_dataset

    if args.synthetic:
        return synthetic_dataset(
            num_nodes=args.synthetic, num_edges=16 * args.synthetic,
            feat_dim=args.feat_size or 600, num_classes=60, seed=args.seed,
        )
    return load_dataset(args.dataset)


def _sampler(ds, args):
    from .. import SamplerConfig
    from ..sampling.sampler import NeighborSampler

    nn = [int(x) for x in str(args.num_neighbors).split(",")]
    cfg = SamplerConfig(
        batch_size=args.batch_size, fanout=nn[0],
        fanouts=tuple(nn) if len(nn) > 1 else None,
        num_hops=args.n_layers + 1, seed=args.seed,
        backend=args.sampler_backend,
    )
    return NeighborSampler(ds.graph, ds.train_nids, cfg, labels=ds.labels)


def cmd_count_vnum(args):
    ds = _load(args)
    s = _sampler(ds, args)
    total_v = total_e = 0
    for mb in s.epoch():
        total_v += int(sum(np.asarray(m).sum() for m in mb.layer_mask))
        total_e += mb.num_sampled_edges()
    out = {"vertices_per_epoch": total_v, "edges_per_epoch": total_e,
           "batches": s.num_batches}
    print(json.dumps(out))
    return out


def cmd_cache_oracle(args):
    ds = _load(args)
    s = _sampler(ds, args)
    freq = np.zeros(ds.num_nodes, dtype=np.int64)
    total = 0
    for mb in s.epoch():
        nids = np.asarray(mb.input_nids)[np.asarray(mb.input_mask)]
        np.add.at(freq, nids, 1)
        total += len(nids)
    order = np.argsort(-freq)
    k = int(ds.num_nodes * args.top_frac)
    hits = int(freq[order[:k]].sum())
    out = {
        "top_frac": args.top_frac,
        "oracle_hit_rate": hits / max(total, 1),
        "degree_ranked_hit_rate": float(
            freq[np.argsort(-ds.graph.out_degrees)[:k]].sum() / max(total, 1)),
        "accesses_per_epoch": total,
    }
    print(json.dumps(out))
    return out


def cmd_load_break(args):
    common.setup_platform()
    import torch

    from ..storage.cache import FeatureCache
    from ..storage.feature_store import FeatureStore
    from ..utils.device import resolve_device

    dev = resolve_device(common.run_device(args))   # no card, no --cpu-devices: raises
    ds = _load(args)
    s = _sampler(ds, args)
    store = FeatureStore.build(ds.graph, ds.features)
    cache = FeatureCache(store, ["features"], ds.graph, device=dev)
    cache.fill(capacity=args.cache_capacity)
    t_sample = t_gather = t_h2d = 0.0
    nb = 0
    it = s.epoch()
    while True:
        t0 = time.perf_counter()
        try:
            mb = next(it)
        except StopIteration:
            break
        t1 = time.perf_counter()
        plan = cache.fetch_plan(np.asarray(mb.input_nids), np.asarray(mb.input_mask))
        t2 = time.perf_counter()
        mb.to(dev)
        torch.from_numpy(plan.src_row).to(dev)
        plan.miss_feats.to(dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t3 = time.perf_counter()
        t_sample += t1 - t0
        t_gather += t2 - t1
        t_h2d += t3 - t2
        nb += 1
    out = {
        "batches": nb,
        "sample_ms": 1e3 * t_sample / nb,
        "host_gather_ms": 1e3 * t_gather / nb,
        "h2d_ms": 1e3 * t_h2d / nb,
        "miss_rate": cache.miss_rate(),
    }
    print(json.dumps(out))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="pagraph_tpu_torch analysis tools")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn in [("count-vnum", cmd_count_vnum),
                     ("cache-oracle", cmd_cache_oracle),
                     ("load-break", cmd_load_break)]:
        sp = sub.add_parser(name)
        sp.add_argument("--dataset", type=str, default=None)
        sp.add_argument("--synthetic", type=int, default=0)
        sp.add_argument("--batch-size", type=int, default=6000)
        sp.add_argument("--num-neighbors", type=str, default="2")
        sp.add_argument("--n-layers", type=int, default=1)
        sp.add_argument("--feat-size", type=int, default=0)
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--sampler-backend", default="auto")
        if name == "cache-oracle":
            sp.add_argument("--top-frac", type=float, default=0.2)
        if name == "load-break":
            sp.add_argument("--cache-capacity", type=int, default=0)
            common.add_device_flags(sp)
        sp.set_defaults(fn=fn)
    args = p.parse_args(argv)
    from ..utils.platform import tune_host_allocator
    tune_host_allocator(512 << 20)
    return args.fn(args)


if __name__ == "__main__":
    main()
