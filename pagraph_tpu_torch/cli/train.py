"""Flagship training CLI (the port of ``pagraph_tpu/cli/train.py``).

Covers the reference's whole trainer zoo with flag combinations
(reference: examples/profile/):

    pa_gcn.py / pa_gs.py    -> --arch gcn|graphsage (cache + partition on)
    dgl_gcn.py / dgl_gs.py  -> --no-cache --partition 1
    dgl_cache.py            -> --partition 1 (cache on, no partitioning)
    multi-GPU               -> --partition N  (N ranks, one process a rank)

The run is on the card unless ``--cpu-devices N`` asks for the CPU.
``--partition N`` spawns N ranks on this host (``nccl``, one a card; gloo
under ``--cpu-devices``, at most N of them) and prints rank 0's summary.
Under ``--coordinator`` (``cli.launch``, or one command a host) this
process is one rank and ``--partition`` equals ``--num-processes``.

Usage:
    python -m pagraph_tpu_torch.cli.train --dataset <dir> [flags]
    python -m pagraph_tpu_torch.cli.train --synthetic 10000 [flags]
"""
from __future__ import annotations

import argparse
import json
import sys

from . import common


def _print_summary(summary: dict, report: str, warmup: int, as_json: bool) -> None:
    print(report, file=sys.stderr)
    print(
        f"mean epoch time (excl. {warmup} warm-up): "
        f"{summary['mean_epoch_time_s']:.3f}s | "
        f"final loss {summary['final_loss']:.4f} | "
        f"miss rate {summary['miss_rate']:.1%}"
    )
    if as_json:
        out = {k: v for k, v in summary.items() if k != "phase_timers"}
        print(json.dumps(out))


def main(argv=None):
    p = argparse.ArgumentParser(description="pagraph_tpu_torch trainer")
    p.add_argument("--dataset", type=str, default=None, help="dataset dir")
    p.add_argument("--synthetic", type=int, default=0,
                   help="generate a random graph with N vertices instead")
    p.add_argument("--synthetic-edges", type=int, default=0,
                   help="edges for --synthetic (default 16x vertices)")
    p.add_argument("--json", action="store_true",
                   help="print a final JSON summary line")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="write a torch.profiler Chrome trace here")
    common.add_device_flags(p)
    common.add_model_flags(p)
    common.add_sampler_flags(p)
    common.add_cache_flags(p)
    common.add_train_flags(p)
    common.add_partition_flags(p)
    common.add_multihost_flags(p)
    args = p.parse_args(argv)

    if args.coordinator and args.partition != args.num_processes:
        p.error(
            f"multi-process training needs --partition == --num-processes "
            f"(one rank a process: {args.num_processes}), got {args.partition}"
        )
    spawned = args.partition > 1 and not args.coordinator
    if spawned:
        avail = common.available_ranks(args)
        if args.partition > avail:
            where = ("--cpu-devices" if args.cpu_devices
                     else "visible CUDA cards, one rank a card")
            p.error(f"--partition {args.partition} needs {args.partition} ranks, "
                    f"have {avail} ({where})")
    if args.one2all and args.partition <= 1:
        raise SystemExit(
            "--one2all needs --isolate and --partition N > 1 "
            "(single-chip isolation is one2one by construction)"
        )

    common.setup_platform(fast_prng=args.fast_prng,
                          cpu_devices=args.cpu_devices,
                          coordinator=args.coordinator,
                          num_processes=args.num_processes,
                          process_id=args.process_id)
    import torch
    import torch.distributed as dist

    from ..utils.device import resolve_device

    device = common.run_device(args)
    dev = resolve_device(device)          # no card and no --cpu-devices: raises
    ds = common.load_cli_dataset(args)
    if ds is None:
        p.error("need --dataset or --synthetic")
    cfg = common.build_config(
        args, feat_dim=ds.feat_dim, n_classes=ds.num_classes
    )
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "host CPU"
    ranks = (f", {args.partition} {common.rank_backend(args)} ranks"
             if args.partition > 1 else "")
    print(f"devices: {dev} ({name}){ranks}", file=sys.stderr)

    opts = dict(seed=args.seed, device=device, feature_source=args.feature_source,
                dispatch="one2all" if args.one2all else "one2one",
                ordering=args.ordering, resume=args.resume, epochs=args.epochs,
                profile_dir=args.profile_dir)
    if spawned:
        del ds                            # every rank loads its own
        out = common.spawn_ranks(args, cfg, args.partition, **opts)
        summary, report, is_proc0 = out["summary"], out["report"], True
    elif args.coordinator:
        try:
            tr, summary = common.train_data_parallel(cfg, ds, log=dist.get_rank() == 0,
                                                     **opts)
            is_proc0 = dist.get_rank() == 0
        finally:
            dist.destroy_process_group()
        report = tr.timers.report()
    else:
        from ..train.loop import Trainer
        from ..utils.timers import maybe_trace

        with maybe_trace(args.profile_dir, device):
            tr = Trainer.from_dataset(cfg, ds, seed=args.seed, log=True, device=device)
            tr.timers.use_scopes = bool(args.profile_dir)
            try:
                start = tr.resume() if args.resume else 0
                summary = tr.train(args.epochs, start_epoch=start)
            finally:
                tr.close()
        report, is_proc0 = tr.timers.report(), True

    if is_proc0:
        _print_summary(summary, report, cfg.train.warmup_epochs, args.json)
    return summary


if __name__ == "__main__":
    main()
