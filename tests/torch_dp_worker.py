"""Rank functions for ``tests/test_torch_dp.py``: each rank of a gloo group
started by ``pagraph_tpu_torch.parallel.multihost.spawn_local`` runs
:func:`run_jobs`.  This module imports torch, numpy and the port only: a
``spawn`` child imports the module that defines its function, and must not
import JAX.

A job is a dict: ``name``; ``data``, the keyword arguments of the port's
``synthetic_dataset``; ``cfg``, the config's sections as dicts; ``parts``,
a partition directory (``from_partition_dir``), ``"identity"`` (the whole
graph as one part, its train set cut to ``train_cut``) or ``None``
(``from_dataset``); ``source``, the ``feature_source`` (default
``"cache"``); ``dispatch``, the sampler dispatch (default ``"one2one"``);
``halo_width``, a static halo width forced on every rank (in
place of ``parallel.halo.halo_width_for``'s); ``params``, a file of a
``state_dict`` loaded into every rank (the JAX package's initial
parameters); ``randomness``, a file of ``{rank: {epoch: (perm, draws)}}``
replacing each rank's ``epoch_randomness``; ``epochs``; ``resume_from``,
the epoch whose checkpoint a second trainer resumes from.  Each rank
writes ``<out>/<name>_rank<r>.pt``: the epoch metrics, the summary, the
final parameters, the kernel launch counts, the lockstep and own batch
counts, the gradient all-reduces, the halo exchanges, the warnings raised,
CV-GCN's histories and aggregates (``cv``), and for a sampling service the
seeds of each epoch's batches, whether any worker outlived ``close()`` and
the shared-memory segments left (and a resumed run's, with
``resume_from``).
"""
from __future__ import annotations

import dataclasses
import os
import warnings

import numpy as np
import torch

import pagraph_tpu_torch as pt
from pagraph_tpu_torch.data.formats import PartitionArtifact
from pagraph_tpu_torch.data.synthetic import synthetic_dataset
from pagraph_tpu_torch.parallel import DataParallelTrainer
from pagraph_tpu_torch.storage.feature_store import FeatureStore


def make_config(sections: dict) -> pt.Config:
    return pt.Config(model=pt.ModelConfig(**sections.get("model", {})),
                     sampler=pt.SamplerConfig(**sections.get("sampler", {})),
                     cache=pt.CacheConfig(**sections.get("cache", {})),
                     partition=pt.PartitionConfig(**sections.get("partition", {})),
                     train=pt.TrainConfig(**sections.get("train", {})))


def build(job: dict, ds) -> DataParallelTrainer:
    cfg = make_config(job["cfg"])
    kw = dict(seed=job.get("seed", 0), device="cpu", feature_source=job.get("source", "cache"),
              dispatch=job.get("dispatch", "one2one"))
    if job.get("halo_width"):
        from pagraph_tpu_torch.parallel import halo

        halo.halo_width_for = lambda cap0, num_shards, slack=1.5, w=job["halo_width"]: w
    if job.get("parts") is None:
        tr = DataParallelTrainer.from_dataset(cfg, ds, **kw)
    else:
        store = FeatureStore.build(ds.graph, ds.features)
        if cfg.train.eval_every:
            kw["eval_data"] = (ds.graph, ds.features, ds.labels, ds.val_mask)
        if job["parts"] == "identity":
            part = PartitionArtifact(ds.graph, ds.train_nids[:job.get("train_cut")],
                                     np.arange(ds.num_nodes), ds.labels)
            tr = DataParallelTrainer(cfg, store, part, **kw)
        else:
            tr = DataParallelTrainer.from_partition_dir(cfg, job["parts"], store, **kw)
    if job.get("params"):
        tr.state.model.load_state_dict(torch.load(job["params"]))
    if job.get("randomness"):
        mine = torch.load(job["randomness"])[tr.rank]
        tr.epoch_randomness = lambda e, out=None: mine[e]
    return tr


def cv_arrays(tr) -> list:
    """CV-GCN's histories then aggregates, ``[n_local, w]`` CPU tensors
    (empty for another architecture)."""
    if tr.cv_state is None:
        return []
    return [t.detach().cpu().clone()
            for t in tr.cv_state.hist_views() + list(tr.cv_state.aggs)]


def record_service_seeds(tr) -> list:
    """Wrap a service-backed trainer's sampler so that each loader epoch's
    batch seeds are kept: one list of seed arrays an epoch."""
    epochs, epoch = [], tr.sampler.epoch

    def seeded():
        seen = []
        epochs.append(seen)
        for mb in epoch():
            seen.append(torch.from_numpy(mb.layer_nids[-1][:int(mb.seed_mask.sum())].copy()))
            yield mb

    tr.sampler.epoch = seeded
    return epochs


def close_service(tr) -> dict:
    """Close the trainer; whether any worker is alive afterwards and the
    shared-memory segments left under ``/dev/shm``."""
    workers, names = list(tr.sampler.workers), [m.name for m in tr.sampler._registry]
    tr.close()
    return {"alive": any(w.is_alive() for w in workers),
            "shm_left": [n for n in names if os.path.exists(os.path.join("/dev/shm", n))]}


def run_jobs(rank: int, world_size: int, jobs: list, out: str) -> None:
    from pagraph_tpu_torch.ops import gather_kernels as gk
    from pagraph_tpu_torch.sampling.service import SampleService

    for job in jobs:
        ds = synthetic_dataset(**job["data"])
        tr = build(job, ds)
        service = isinstance(tr.sampler, SampleService)
        seeds = record_service_seeds(tr) if service else None
        gk.reset_launch_counts()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            summary = tr.train(job["epochs"])
        res = {"warnings": [str(w.message) for w in caught], "cv": cv_arrays(tr),
               "part_nodes": tr.part.num_nodes, "seeds": seeds,
               "closed": close_service(tr) if service else None,
               "exchanges": tr.exchange.calls if tr.exchange is not None else 0,"metrics": [dataclasses.asdict(m) for m in tr.epoch_metrics],
               "summary": {k: v for k, v in summary.items() if k != "phase_timers"},
               "params": {k: v.detach().clone() for k, v in tr.state.model.state_dict().items()},
               "launches": {k: v for k, v in gk.launch_counts().items() if v},
               "steps": tr.steps, "own_batches": -(-len(tr.part.train_nids)
                                                    // tr.cfg.sampler.batch_size),
               "grad_syncs": tr.grad_sync.calls}
        if job.get("resume_from") is not None:
            again = build(job, ds)
            start = again.resume(job["resume_from"])
            again.train(job["epochs"], start_epoch=start)
            res["resumed"] = {"start": start, "cv": cv_arrays(again),
                              "metrics": [dataclasses.asdict(m) for m in again.epoch_metrics],
                              "params": {k: v.detach().clone()
                                         for k, v in again.state.model.state_dict().items()}}
        torch.save(res, os.path.join(out, f"{job['name']}_rank{rank}.pt"))


def fail_on_rank_one(rank: int, world_size: int) -> None:
    """Rank 1 raises; rank 0 waits in a collective that never completes."""
    import torch.distributed as dist

    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.barrier()


def exchange_ranks(rank: int, world_size: int, cases_path: str, out: str) -> None:
    """``tests/test_torch_halo.py``'s exchanges: ``cases_path`` holds
    ``{name: {"shards": [P, rows, D] tensor, "plans": [(req, slot, valid)
    a rank], "scale": f32 [D] or None}}``; this rank exchanges its plan
    over its shard (``parallel.halo.exchange_features``) and writes the
    f32 rows of every case to ``<out>/exchange_rank<r>.pt``."""
    from pagraph_tpu_torch.parallel.halo import HaloPlan, exchange_features

    got = {}
    for name, case in torch.load(cases_path).items():
        req, slot, valid = case["plans"][rank]
        got[name] = exchange_features(case["shards"][rank].contiguous(),
                                      HaloPlan(req, slot, valid), scale=case["scale"])
    torch.save(got, os.path.join(out, f"exchange_rank{rank}.pt"))
