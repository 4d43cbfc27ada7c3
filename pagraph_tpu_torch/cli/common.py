"""Shared CLI plumbing: config flags -> Config, platform setup, and the
data-parallel runs of ``--partition N`` (the port of
``pagraph_tpu/cli/common.py``).

The flag surface is the JAX package's: the same flags, defaults and choices,
and ``build_config`` gives a :class:`~pagraph_tpu_torch.Config` equal field
for field to the JAX package's for the same arguments.  Two flags map onto
the port's process model:

* ``--cpu-devices N``: the run is on the CPU (``device="cpu"``), with up to
  N gloo ranks.  The JAX package makes N virtual devices in one process;
  the port's ranks are processes (one a partition), so ``--partition P``
  spawns P ranks.  Without the flag the run is on the card, one rank a card
  over ``nccl``.
* ``--fast-prng`` is accepted and ignored: torch has one generator
  implementation, and the port's random streams are its own either way.

Importing a module of ``cli`` loads argparse and the config only; torch and
the trainers load when a command runs.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

from .. import CacheConfig, Config, ModelConfig, PartitionConfig, SamplerConfig, TrainConfig


def add_model_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--arch",
                   choices=["gcn", "graphsage", "gcn_cv", "gat", "gin"],
                   default="gcn")
    p.add_argument("--n-layers", type=int, default=1,
                   help="hidden layers (total GNN layers = n_layers + 1)")
    p.add_argument("--n-hidden", type=int, default=32)
    p.add_argument("--n-classes", type=int, default=0,
                   help="0 = infer from labels")
    p.add_argument("--feat-size", type=int, default=0,
                   help="0 = infer from features")
    p.add_argument("--dropout", type=float, default=0.2)
    p.add_argument("--agg", choices=["mean", "gcn", "pool", "lstm"],
                   default="mean")
    p.add_argument("--num-heads", type=int, default=4,
                   help="gat attention heads (must match the checkpoint "
                        "when evaluating)")
    p.add_argument("--preprocess", action="store_true",
                   help="server-side layer-0 pre-aggregation (one hop less)")


def add_sampler_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--batch-size", type=int, default=6000)
    p.add_argument("--num-neighbors", type=str, default="2",
                   help="fanout per hop: one value ('2') or a per-layer "
                        "list, input-side first like DGL ('15,10,5'; "
                        "must have one entry per sampled hop)")
    p.add_argument("--prefetch", type=int, default=2)
    p.add_argument("--sampler-backend", choices=["auto", "numpy", "native"],
                   default="auto")
    p.add_argument("--paired-draws", action="store_true",
                   help="on-device sampler: serve a vertex's fanout slots "
                        "from ONE aligned 32 B adjacency row gather "
                        "(uniform marginals, window-correlated slots; "
                        "deg<=fanout draws with replacement)")


def add_cache_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--no-cache", action="store_true",
                   help="disable the device feature cache (DGL-baseline mode)")
    p.add_argument("--cache-dtype", choices=["float32", "bfloat16", "int8"],
                   default="float32",
                   help="feature storage dtype: bfloat16 halves cache memory / "
                        "miss H2D / halo bytes, int8 quarters them "
                        "(per-column symmetric quantization; the assembly "
                        "kernel dequantizes)")
    p.add_argument("--cache-capacity", type=int, default=0,
                   help="vertices; 0 = auto-size from free GPU memory (a "
                        "CPU run needs a capacity)")


def add_train_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--lr", type=float, default=3e-2)
    p.add_argument("--lr-schedule", choices=["none", "cosine"],
                   default="none",
                   help="cosine: decay lr to 5%% over --lr-decay-steps "
                        "optimizer steps (beyond-reference)")
    p.add_argument("--lr-decay-steps", type=int, default=0)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--ckpt-dir", type=str, default=None)
    p.add_argument("--ckpt-every", type=int, default=0)
    p.add_argument("--eval-every", type=int, default=0,
                   help="validation accuracy via full-neighborhood "
                        "inference every N epochs (0 = off)")
    p.add_argument("--eval-backend", choices=["host", "device"],
                   default="host",
                   help="full-graph inference backend for --eval-every: "
                        "host scipy SpMM, or window reductions on the "
                        "card (much faster at millions of vertices)")
    p.add_argument("--resume", action="store_true",
                   help="continue from the newest checkpoint in --ckpt-dir")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--isolate", action="store_true",
                   help="isolation mode: sampling in worker processes "
                        "(reference pa_iso.py)")
    p.add_argument("--one2all", action="store_true",
                   help="with --isolate --partition N: every rank's sampler "
                        "pool over the full graph, the batches dealt round "
                        "robin (reference cache_server); default one2one = a "
                        "pool per rank over its partition")
    p.add_argument("--fast-prng", action="store_true",
                   help="accepted for the JAX package's command lines and "
                        "ignored: torch has one generator implementation")
    p.add_argument("--on-device", action="store_true",
                   help="sample on the card; the whole epoch replayed as "
                        "CUDA graphs (needs graph + features in device memory)")
    p.add_argument("--epoch-dispatch", choices=["scan", "steps"],
                   default="scan",
                   help="on-device epoch dispatch: scan = whole epoch in ONE "
                        "graph; steps = one graph replay per minibatch "
                        "(single-device only)")
    p.add_argument("--compute-dtype", choices=["float32", "bfloat16"],
                   default="float32",
                   help="model fwd/bwd dtype; bfloat16 runs the matmuls on "
                        "bf16 tensor cores (master params/optimizer stay f32)")
    p.add_argument("--halo-pipeline", action="store_true",
                   help="edge mode: sample + halo-exchange batch i+1 "
                        "inside batch i's step so the all_to_all can "
                        "overlap compute (identical trajectory)")


def add_partition_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--partition", type=int, default=1,
                   help="number of partitions / ranks (one process a rank)")
    p.add_argument("--partition-method", choices=["dg", "hash", "kl"], default="dg")
    p.add_argument("--edge-balance", action="store_true",
                   help="dg: balance partition EDGE footprints (in_deg+1 "
                        "weights) — for edge-partitioned training, whose "
                        "per-rank memory pads to the largest partition")
    p.add_argument("--ordering", action="store_true",
                   help="locality reordering before partitioning")


def build_config(args, *, feat_dim: int, n_classes: int) -> Config:
    model = ModelConfig(
        arch=args.arch,
        n_layers=args.n_layers,
        hidden=args.n_hidden,
        feat_dim=args.feat_size or feat_dim,
        n_classes=args.n_classes or n_classes,
        dropout=args.dropout,
        aggregator=args.agg,
        num_heads=getattr(args, "num_heads", 4),
        preprocess=getattr(args, "preprocess", False),
    )
    nn = [int(x) for x in str(args.num_neighbors).split(",")]
    return Config(
        model=model,
        sampler=SamplerConfig(
            batch_size=args.batch_size,
            fanout=nn[0],
            fanouts=tuple(nn) if len(nn) > 1 else None,
            num_hops=model.num_sampled_hops,
            prefetch=args.prefetch,
            backend=args.sampler_backend,
            seed=args.seed,
            paired_draws=getattr(args, "paired_draws", False),
        ),
        cache=CacheConfig(
            enabled=not args.no_cache,
            capacity=args.cache_capacity or None,
            dtype=getattr(args, "cache_dtype", "float32"),
        ),
        partition=PartitionConfig(
            num_parts=getattr(args, "partition", 1),
            method=getattr(args, "partition_method", "dg"),
            num_hops=model.num_sampled_hops,
            edge_balance=getattr(args, "edge_balance", False),
        ),
        train=TrainConfig(
            lr=args.lr,
            lr_schedule=getattr(args, "lr_schedule", "none"),
            lr_decay_steps=getattr(args, "lr_decay_steps", 0),
            epochs=args.epochs,
            log_every=args.log_every,
            ckpt_dir=args.ckpt_dir,
            ckpt_every=args.ckpt_every,
            eval_every=getattr(args, "eval_every", 0),
            eval_backend=getattr(args, "eval_backend", "host"),
            remote_sampling=getattr(args, "isolate", False),
            on_device_sampling=getattr(args, "on_device", False),
            epoch_dispatch=getattr(args, "epoch_dispatch", "scan"),
            halo_pipeline=getattr(args, "halo_pipeline", False),
            dtype=getattr(args, "compute_dtype", "float32"),
        ),
    )


def inference_config(args, *, feat_dim: int, n_classes: int) -> Config:
    """The model flags -> the ``Config`` that ``eval`` and ``infer`` restore
    a checkpoint into (the sampler's hops follow the model; nothing else is
    read)."""
    model = ModelConfig(
        arch=args.arch, n_layers=args.n_layers, hidden=args.n_hidden,
        feat_dim=args.feat_size or feat_dim,
        n_classes=args.n_classes or n_classes,
        dropout=args.dropout, aggregator=args.agg,
        num_heads=args.num_heads,
        preprocess=getattr(args, "preprocess", False),
    )
    return Config(model=model, sampler=SamplerConfig(num_hops=model.num_sampled_hops))


def add_multihost_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--coordinator", type=str, default=None,
                   help="host:port of process 0; presence makes this process "
                        "one rank of a multi-process run over "
                        "torch.distributed (rank 0's TCP store)")
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--feature-source", choices=["cache", "ici", "edge"],
                   default="cache",
                   help="multi-rank feature placement: per-rank device cache "
                        "of its partition; the full matrix disjointly "
                        "sharded over the ranks with all_to_all halo fetch "
                        "(ici, full CSR replicated); or edge = partition "
                        "CSR per rank + sharded features (E/P + N*dim/P "
                        "per-rank memory, needs --on-device)")


def add_device_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--cpu-devices", type=int, default=0,
                   help="run on the CPU with up to N gloo ranks (one process "
                        "a rank) instead of the card")


def run_device(args):
    """The device a command runs on: ``"cpu"`` under ``--cpu-devices``, else
    ``None``, the card (which an entry point requires)."""
    return "cpu" if getattr(args, "cpu_devices", 0) else None


def available_ranks(args) -> int:
    """Ranks a run may spawn: N under ``--cpu-devices N``, else the
    visible cards (one rank a card)."""
    if getattr(args, "cpu_devices", 0):
        return args.cpu_devices
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def rank_backend(args) -> str:
    return "gloo" if getattr(args, "cpu_devices", 0) else "nccl"


def setup_platform(warm_bytes: int = 1 << 30,
                   fast_prng: bool = False,
                   cpu_devices: int = 0,
                   coordinator: "str | None" = None,
                   num_processes: int = 1,
                   process_id: int = 0) -> None:
    """Tune the host allocator and, under ``coordinator``, join the process
    group as rank ``process_id`` of ``num_processes`` at rank 0's TCP store
    (``nccl`` on the card, gloo under ``cpu_devices``).  ``fast_prng`` is
    ignored (see the module's docstring)."""
    from ..utils.platform import tune_host_allocator

    tune_host_allocator(warm_bytes)
    if coordinator:
        from ..parallel.multihost import init_distributed

        init_distributed(process_id, num_processes,
                         backend="gloo" if cpu_devices else "nccl",
                         init_method=f"tcp://{coordinator}")


def load_cli_dataset(args):
    """``--synthetic N`` (learnable labels, seeded by ``--seed``) or
    ``--dataset DIR``; ``None`` when neither is given."""
    if args.synthetic:
        from ..data.synthetic import synthetic_dataset

        return synthetic_dataset(
            num_nodes=args.synthetic,
            num_edges=args.synthetic_edges or 16 * args.synthetic,
            feat_dim=args.feat_size or 600,
            num_classes=args.n_classes or 60,
            seed=args.seed,
            learnable=True,
        )
    if args.dataset:
        from ..data.formats import load_dataset

        return load_dataset(args.dataset)
    return None


def edges_per_s(metrics, warmup: int) -> float:
    """Valid sampled edges over seconds of the epochs after ``warmup``
    (all of them when there are no more)."""
    steady = metrics[warmup:] or metrics
    edges = sum(m.edges for m in steady)
    secs = sum(m.time_s for m in steady)
    return edges / max(secs, 1e-9)


def train_data_parallel(cfg, ds, *, seed: int, device, feature_source: str = "cache",
                        dispatch: str = "one2one", ordering: bool = False,
                        resume: bool = False, epochs=None, log: bool = False,
                        profile_dir=None):
    """This rank's ``DataParallelTrainer.from_dataset`` (after the locality
    reordering under ``ordering``), trained for ``epochs`` inside
    :func:`maybe_trace`; ``(trainer, summary)``.  The process group is up."""
    from ..parallel import DataParallelTrainer
    from ..utils.timers import maybe_trace

    with maybe_trace(profile_dir, device):
        if ordering:
            from ..partition import apply_reordering, reorder_map

            ds = apply_reordering(ds, reorder_map(ds.graph))
        tr = DataParallelTrainer.from_dataset(cfg, ds, seed=seed, log=log, device=device,
                                              feature_source=feature_source,
                                              dispatch=dispatch)
        tr.timers.use_scopes = bool(profile_dir)
        try:
            start = tr.resume() if resume else 0
            summary = tr.train(epochs or cfg.train.epochs, start_epoch=start)
        finally:
            tr.close()
    return tr, summary


def _spawned_rank(rank: int, world: int, args, cfg, opts: dict, out_path: str) -> None:
    """One rank of a ``--partition N`` run in one command: load the dataset
    as every rank does, train this rank, and on rank 0 write the summary,
    the timers' report and the steady edges/s to ``out_path``."""
    ds = load_cli_dataset(args)
    tr, summary = train_data_parallel(cfg, ds, log=rank == 0, **opts)
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump({"summary": summary, "report": tr.timers.report(),
                       "edges_per_s": edges_per_s(tr.epoch_metrics,
                                                  cfg.train.warmup_epochs)}, f)


def spawn_ranks(args, cfg, world: int, **opts) -> dict:
    """Run ``world`` ranks of :func:`train_data_parallel` on this host
    (``parallel.multihost.spawn_local``: gloo under ``--cpu-devices``, else
    ``nccl``, one rank a card) and return rank 0's ``{"summary", "report",
    "edges_per_s"}``."""
    from ..parallel.multihost import spawn_local

    opts.setdefault("device", run_device(args))
    with tempfile.TemporaryDirectory(prefix="pagraph_ranks_") as d:
        out = os.path.join(d, "rank0.json")
        spawn_local(_spawned_rank, world, args, cfg, opts, out, backend=rank_backend(args))
        with open(out) as f:
            return json.load(f)
