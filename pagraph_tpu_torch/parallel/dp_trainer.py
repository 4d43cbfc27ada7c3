"""Data-parallel trainer: one graph partition, its cache and its device a
rank (the port of ``pagraph_tpu/parallel/dp_trainer.py``: the ``cache``,
``ici`` and ``edge`` feature sources).

The reference's topology (examples/profile/pa_gcn.py:117-157,
``mp.spawn(trainer, nprocs=gpus)`` + DDP/NCCL): every trainer process owns
one self-reliant partition (``partition/``) and its own degree-ranked
cache, and the gradients are all-reduced.  The JAX package drives every
chip from one process through ``shard_map``; the port keeps the
reference's one process a rank (``parallel/multihost.py``: start the ranks
with ``spawn_local``, or join a group with ``init_distributed``), and a
:class:`DataParallelTrainer` is built inside a rank whose process group is
up.  Each rank holds only its own partition's heavy state (CSR, cache,
sampler, loader).  The figures that must agree across ranks come from
collectives when it is built: the lockstep step count (the ranks' largest
batch count), the layer capacities (sized for the largest partition, then
the elementwise maximum of the ranks' probes), and the cache capacity (the
smallest free-memory capacity, bounded by the largest partition).  The
parameters are broadcast from rank 0, so the replicas start identical and
stay so: each step averages the gradients over the ranks (one
``all_reduce`` a step, ``parallel/train_step.py`` ``GradSync``) before the
same Adam update.

Host path: each rank's loader runs the lockstep step count an epoch; a
rank whose sampler runs out first takes make-up batches from its next
epoch (the reference's make-up sends).  The dispatch is the single-device
trainer's (``train.steps_per_dispatch`` steps a group, epoch 0 eager on a
side stream); under ``nccl`` later epochs replay the groups' CUDA graphs,
the K all-reduces of a group inside its graph, and under ``gloo`` (the CPU,
or several ranks on one card) every epoch is eager: gloo waits for the
device on the host and cannot be captured.  The epoch's metrics are one
``all_reduce`` at its end: loss and accuracy the means over the ranks,
edges and vertices their sums, the miss rate the mean of the ranks' rates.

On-device path (``train.on_device_sampling``): each rank keeps its
partition's CSR and a full cache in device memory and runs
``train/device_epoch.py`` ``make_dp_device_epoch_fn`` (its schedule wraps a
smaller partition's permutation, every seed valid), its randomness drawn
from a generator seeded by ``(seed, epoch, rank)``; under ``nccl`` the
epoch is one CUDA graph from the second epoch on, the collectives inside.

Dropout draws from each rank's own stream, reseeded each epoch from
``(seed, epoch, rank)`` (the JAX package folds the rank into its key), so a
resumed run draws what the uninterrupted run draws.  Checkpoints: rank 0
writes the replicated train state after the epochs ``train.ckpt_every``
asks for (no sampler state: the JAX package's data-parallel checkpoint has
none), the other ranks wait at a barrier; :meth:`resume` restores it into
every rank's tensors in place.  ``train.eval_every``: rank 0 evaluates the
full graph (``eval_data``) and broadcasts the accuracy.

The halo feature sources (``parallel/halo.py``): the full feature matrix
is sharded across the ranks, each holding only its cyclic shard
(``np.arange(rank, N, P)`` gathered from the store, in the cache tier's
dtype), and each step's layer-0 rows come from their owners over two
``all_to_all_single`` collectives; the cache is never filled and the miss
rate is 0.  ``ici`` on the host path samples the rank's partition as the
``cache`` source does and plans the exchange on the host (the loader's
producers, the plan travelling in the packed batch; the static halo width
from the calibrated layer-0 capacity); ``ici`` on the device samples the
full graph on every rank (``from_dataset`` gives each rank the whole graph)
over a shared permutation; ``edge`` (on the device only) samples the rank's
partition and maps its ids through ``local2full``.  The device paths size
the width from ``cap0 = B * prod(f + 1)``; both from ``train.halo_slack``.
Requests past the width are dropped and train on zero rows: ``halo_drops``
counts them (summed over the ranks) and an epoch that drops any warns.
``train.halo_pipeline`` (``edge`` only) pipelines the exchange one batch
deep, in a process group of its own.

CV-GCN (``model.arch="gcn_cv"``) runs on the device with the ``cache``
and ``edge`` sources: each rank keeps a ``CVDeviceState`` over its own
partition's vertices (``train/device_epoch.py`` ``make_dp_device_epoch_fn``
and ``make_halo_device_epoch_fn`` given it), which no collective touches.  A checkpoint adds one history file a rank
(``train/checkpoint.py`` ``save_aux_shards``: every rank writes its own,
rank 0 the train state too), and :meth:`resume` restores each rank's from
the one complete set of the same world size.

Isolation-mode sampling (``train.remote_sampling``, the host path): the
rank's batches come from worker processes (``sampling/service.py``
``SampleService``) in place of the in-process sampler; the loader packs
and plans them as before (``cache`` and ``ici``).  ``dispatch="one2one"``
runs a pool a rank over its partition (seeded ``seed + 31 * rank``);
``"one2all"`` samples the full graph (``from_dataset`` gives every rank the
whole graph as its part) with the JAX package's round-robin split of each
epoch's batches across the ranks, each rank running its own pool for its
own share (the JAX package runs one pool for every consumer in one
process; the port has one process a rank), so the lockstep step count is
``ceil(batches / P)``.  :meth:`close` shuts the workers down.

Refused as the JAX package refuses them: ``epoch_dispatch="steps"``;
``edge`` without ``train.on_device_sampling``; ``train.halo_pipeline``
without ``edge`` or with ``gcn_cv``; ``gcn_cv`` on the host path or with
``ici``; ``dispatch="one2all"`` without ``train.remote_sampling``.
"""
from __future__ import annotations

import time
import warnings
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import Config
from ..data.formats import Dataset, PartitionArtifact, load_partition
from ..partition import dg_partition, hash_partition, kl_partition
from ..sampling.device_sampler import DeviceCSR
from ..sampling.loader import PrefetchLoader
from ..sampling.sampler import NeighborSampler
from ..storage.cache import FeatureCache
from ..storage.feature_store import FeatureStore
from ..train.checkpoint import open_aux_shards, save_aux_shards, save_checkpoint
from ..train.device_epoch import (METRIC_NAMES, CVDeviceState, DeviceData, EpochInputs,
                                  HaloEpoch, epoch_seed, num_batches, rank_epoch_seed)
from ..train.loop import Trainer
from ..train.state import create_state, layer0_fields
from ..utils.device import resolve_device
from ..utils.timers import PhaseTimers
from . import halo
from .train_step import attach_grad_sync, make_dp_halo_train_step

# the JAX package's refusal of the per-step dispatch (dp_trainer.py:114-120),
# and the ROADMAP item that keeps it refused
STEPS_DISPATCH_ERROR = (
    "epoch_dispatch='steps' is a single-chip Trainer mode; the multi-chip epochs keep the "
    "whole-epoch dispatch (per-step dispatch would multiply the host dispatch count by "
    "num_batches on every chip; ROADMAP queue 1 item 7b)")
# the stream of rank_epoch_seed that reseeds a rank's dropout generator
_DROPOUT_STREAM = 1


def refuse_unported(cfg: Config, feature_source: str = "cache",
                    dispatch: str = "one2one") -> None:
    """Raise for a configuration the data-parallel trainer does not run:
    the JAX package's own validation, with its messages."""
    t = cfg.train
    if feature_source not in ("cache", "ici", "edge"):
        raise ValueError(f"unknown feature_source {feature_source!r}")
    if dispatch not in ("one2one", "one2all"):
        raise ValueError(f"unknown dispatch {dispatch!r}")
    if dispatch == "one2all" and not t.remote_sampling:
        raise ValueError("dispatch='one2all' is an isolation-mode knob: set "
                         "train.remote_sampling=True")
    if feature_source == "edge" and not t.on_device_sampling:
        raise NotImplementedError(
            "feature_source='edge' (partition CSR + features sharded across the ranks) is "
            "an on-device mode: set train.on_device_sampling=True")
    if t.halo_pipeline and feature_source != "edge":
        raise ValueError(
            "train.halo_pipeline pipelines the EDGE mode's halo exchange: set "
            "feature_source='edge' (it is a no-op everywhere else)")
    if t.halo_pipeline and cfg.model.arch == "gcn_cv":
        raise NotImplementedError(
            "halo_pipeline is not implemented for the gcn_cv edge epoch "
            "(make_edge_cv_device_epoch_fn runs unpipelined; CV history reads would have to "
            "be pipelined with the batch too)")
    if cfg.model.arch == "gcn_cv" and (not t.on_device_sampling or feature_source == "ici"):
        raise NotImplementedError(
            "multi-chip gcn_cv needs device-resident per-partition histories: set "
            "train.on_device_sampling=True with feature_source='cache' or 'edge' (ici samples "
            "the FULL graph on every chip, so chips would write divergent histories for the "
            "same vertex; see the design note on "
            "train/device_epoch.make_edge_cv_device_epoch_fn)")
    if t.epoch_dispatch == "steps":
        raise NotImplementedError(STEPS_DISPATCH_ERROR)


class DataParallelTrainer(Trainer):
    """This rank's trainer over its partition ``part`` (local graph, train
    ids and labels, ``local2full`` into the full ``store``), in the default
    process group, which must be up.
    ``device=None`` is the card (``cuda``, the rank's current device);
    ``eval_data``: ``(graph, features, labels, mask)`` of the full graph,
    needed on rank 0 for ``train.eval_every``."""

    data_parallel = True

    def __init__(self, cfg: Config, store: FeatureStore, part: PartitionArtifact, *,
                 device=None, seed: int = 0, log: bool = False,
                 feature_source: str = "cache", dispatch: str = "one2one",
                 eval_data: Optional[tuple] = None):
        refuse_unported(cfg, feature_source, dispatch)
        if not dist.is_initialized():
            raise RuntimeError(
                "DataParallelTrainer is built inside a rank whose process group is up "
                "(parallel.multihost.init_distributed or spawn_local)")
        t = cfg.train
        self.rank = dist.get_rank()
        self.world_size = dist.get_world_size()
        self.backend = dist.get_backend()
        self.device = resolve_device(device)
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError("backend 'nccl' runs on CUDA devices: use backend='gloo' on "
                             "the CPU")
        if t.eval_every and self.rank == 0 and eval_data is None:
            raise ValueError("cfg.train.eval_every is set but rank 0 has no eval_data "
                             "(DataParallelTrainer.from_dataset wires it)")
        self.cfg, self.store, self.log, self.part = cfg, store, log, part
        self.feature_source = feature_source
        self._eval_data = eval_data
        self._seed = seed
        self.timers = PhaseTimers()
        self.epoch_metrics = []
        self._cache_filled = False
        self._device_mode = t.on_device_sampling
        self._side_stream = (torch.cuda.Stream(device=self.device)
                             if self.device.type == "cuda" else None)
        self._is_cv = cfg.model.arch == "gcn_cv"
        self.cv_history = self.cv_state = None
        self.halo_drops = 0
        with self.timers.scope("setup.cache"):
            self.cache = FeatureCache(store, layer0_fields(cfg), part.graph, part.local2full,
                                      device=self.device, dtype=cfg.cache.dtype,
                                      reserve_bytes=cfg.cache.hbm_reserve_bytes)
        n_train = len(part.train_nids)
        batch = cfg.sampler.batch_size
        # the figures every rank must agree on: the largest partition, the
        # lockstep step count, and (negated) the fewest train vertices
        self.max_nodes, self.steps, neg_min_train = self._all_reduce_ints(
            [part.num_nodes, num_batches(n_train, batch), -n_train], dist.ReduceOp.MAX)
        # replicas identical by construction: rank 0's parameters everywhere
        with self.timers.scope("setup.state"):
            self.state = create_state(cfg, seed=seed, device=self.device)
            self._broadcast_state()
            self.grad_sync = attach_grad_sync(self.state)
        self.exchange = None
        if feature_source != "cache":
            self._shard_features()
        if self._device_mode:
            self._init_device_mode(n_train)
            return
        if neg_min_train == 0:
            raise ValueError("a rank's partition has no train vertices: the host path needs "
                             "at least one on every rank")
        one2all = t.remote_sampling and dispatch == "one2all"
        if one2all and (part.num_nodes != store.num_nodes
                        or not np.array_equal(part.local2full, np.arange(part.num_nodes))):
            raise ValueError("dispatch='one2all' samples FULL-graph vertex ids: partitions "
                             "must be identity full-graph views (use from_dataset, which "
                             "builds them)")
        sampler_seed = seed if one2all else seed + 31 * self.rank
        self.sampler = NeighborSampler(part.graph, part.train_nids, cfg.sampler,
                                       labels=part.labels, seed=sampler_seed,
                                       caps=cfg.sampler.layer_capacities(self.max_nodes))
        if cfg.sampler.auto_caps:
            # uniform caps across ranks: the elementwise max of their probes
            caps = self._all_reduce_ints(self.sampler.calibrate_caps(), dist.ReduceOp.MAX)
            self.sampler.set_caps(tuple(caps))
        self.caps = self.sampler.caps
        if t.remote_sampling:
            from ..sampling.service import SampleService

            # one2one: a pool over this rank's partition; one2all: this
            # rank's share of the full graph's round robin, from its own pool
            self.sampler = SampleService(
                part.graph, part.train_nids, cfg.sampler, labels=part.labels,
                seed=sampler_seed, caps=self.caps,
                num_consumers=self.world_size if one2all else 1,
                consumer=self.rank if one2all else 0)
            if one2all:
                self.steps = self.sampler.num_batches
        planner = None
        if feature_source == "ici":
            # the host pipeline's plans are [P, H] a batch: H from the
            # calibrated layer-0 capacity
            planner = self._make_exchange(self.caps[0])
        elif cfg.cache.rank_by == "access_freq":
            self.cache.track_access = True
        self.loader = PrefetchLoader(self.sampler, self.cache, prefetch=cfg.sampler.prefetch,
                                     device=self.device, num_batches=self.steps, halo=planner,
                                     timers=self.timers)
        self.steps_per_dispatch = max(1, t.steps_per_dispatch)
        # gloo waits for the device on the host: no CUDA graph can hold it
        self.host_graphs = self.device.type == "cuda" and self.backend == "nccl"
        self.group_graphs = None
        self._acc = torch.zeros(2, dtype=torch.float32, device=self.device)
        self._host_epochs = 0

    def _init_device_mode(self, n_train: int) -> None:
        """This rank's CSR, train ids and labels on the device, the epoch's
        buffers for the lockstep step count; warns on a large edge skew.
        The halo sources: the exchange at the width of ``cap0 = B *
        prod(f + 1)``; ``ici`` runs ``ceil(n_train / (P * B))`` steps over
        the whole graph, which every rank must hold."""
        part, dev, s = self.part, self.device, self.cfg.sampler
        self.sampler = self.loader = None
        self._halo = None
        if self.feature_source != "cache":
            l2f = None
            if self.feature_source == "ici":
                if (part.num_nodes != self.store.num_nodes
                        or not np.array_equal(part.local2full, np.arange(part.num_nodes))):
                    raise ValueError(
                        "on_device_sampling with feature_source='ici' samples the FULL graph "
                        "on every rank: give each rank the whole graph as its part "
                        "(from_dataset does this)")
                self.steps = max(1, -(-n_train // (self.world_size * s.batch_size)))
            else:
                if part.local2full.max(initial=0) >= np.iinfo(np.int32).max:
                    raise ValueError("full vertex id overflows int32")
                l2f = torch.from_numpy(part.local2full.astype(np.int32)).to(dev, copy=True)
            cap0 = s.batch_size
            for f in s.hop_fanouts():
                cap0 *= f + 1
            self._make_exchange(cap0)
            self._halo = HaloEpoch(self.exchange, self.rank, self.world_size, l2f,
                                   self.cfg.train.halo_pipeline)
        with self.timers.scope("setup.csr"):
            self._dev_csr = DeviceCSR.from_graph(part.graph, dev)
            self._dev_train_nids = torch.from_numpy(
                np.asarray(part.train_nids, dtype=np.int32)).to(dev, copy=True)
            self._dev_labels = torch.from_numpy(
                np.asarray(part.labels, dtype=np.int32)).to(dev, copy=True)
        with self.timers.scope("setup.state"):
            if self._is_cv:
                # the rank's histories over its partition, before the cache fill
                self.cv_state = CVDeviceState.allocate(self.cfg, part.graph, dev)
            self.epoch_inputs = EpochInputs.allocate(self.cfg, n_train, dev, steps=self.steps)
        self.device_graphs = self._side_stream is not None and self.backend == "nccl"
        self.epoch_runner = None
        self._device_epochs = 0
        edges = np.zeros(self.world_size, dtype=np.int64)
        edges[self.rank] = part.graph.num_edges
        edges = np.asarray(self._all_reduce_ints(edges, dist.ReduceOp.SUM))
        self.structure_skew = float(edges.max()) / max(float(edges.mean()), 1.0)
        if self.structure_skew > 1.5 and self.rank == 0:
            warnings.warn(
                f"partition edge skew max/mean = {self.structure_skew:.2f} (edges a "
                f"partition {edges.tolist()}): the rank of the largest holds "
                f"{self.structure_skew:.2f} times the mean CSR in device memory. Partition "
                "with edge_balance=True to rebalance.", RuntimeWarning, stacklevel=3)

    # -- collectives ------------------------------------------------------------

    @property
    def _host_side(self) -> torch.device:
        """Where a collective of host values runs: the card under ``nccl``,
        the CPU under gloo."""
        return self.device if self.backend == "nccl" else torch.device("cpu")

    def _all_reduce_ints(self, values, op) -> list:
        """``values`` (ints) reduced over the group with ``op``."""
        t = torch.tensor(np.asarray(values, dtype=np.int64), device=self._host_side)
        dist.all_reduce(t, op=op)
        return [int(v) for v in t.tolist()]

    def _broadcast_state(self) -> None:
        with torch.no_grad():
            for t in self.state.model.state_dict().values():
                buf = t.to(self._host_side)
                dist.broadcast(buf, src=0)
                t.copy_(buf)

    # -- the halo exchange ---------------------------------------------------------

    def _shard_features(self) -> None:
        """This rank's cyclic shard of the full feature matrix on its device
        (``halo.shard_features``' row ``rank``): the store's rows of
        ``np.arange(rank, N, P)`` in the cache tier's dtype (quantized with
        the store-wide scale at the int8 tier, or read as stored from a
        pre-quantized store), zero-padded to ``ceil(N / P)`` rows."""
        n, world = self.store.num_nodes, self.world_size
        mine = halo.shard_ids(self.rank, world, n)
        self.shard_rows = -(-n // world)
        self.shard = torch.zeros((self.shard_rows, self.cache.total_dim),
                                 dtype=self.cache.row_dtype, device=self.device)
        self.shard[:len(mine)].copy_(self.cache.tier_rows(mine))
        self._halo_group = dist.new_group() if self.cfg.train.halo_pipeline else None

    def _make_exchange(self, cap0: int):
        """The exchange at the static halo width for ``cap0`` layer-0 rows
        (``halo.halo_width_for`` at ``train.halo_slack``); returns the host
        planner of that width."""
        self.halo_width = halo.halo_width_for(cap0, self.world_size,
                                              slack=self.cfg.train.halo_slack)
        self.exchange = halo.HaloExchange(self.shard, self.halo_width, group=self._halo_group,
                                          scale=self.cache.dequant_scale_dev)
        if self.log and self.rank == 0:
            print(f"[{self.feature_source}] {self.store.num_nodes} x {self.cache.total_dim} "
                  f"features sharded {self.world_size} ways ({self.shard.nbytes / 1e6:.1f} "
                  f"MB a rank), halo width {self.halo_width}")
        return halo.HaloPlanner(self.world_size, self.shard_rows, self.halo_width)

    def _warn_halo_drops(self, epoch: int, drops: int) -> None:
        """One warning an epoch whose requests overflowed the static halo
        width: they trained on zero rows."""
        if drops <= 0:
            return
        warnings.warn(
            f"epoch {epoch}: {drops} halo requests overflowed the static halo width "
            f"{self.halo_width} and trained on zeroed features; raise cfg.train.halo_slack "
            f"(currently {self.cfg.train.halo_slack}) or rebalance partitions",
            RuntimeWarning, stacklevel=3)

    def _count_halo_drops(self, em, drops: int) -> None:
        em.halo_drops = drops
        self.halo_drops += drops
        self._warn_halo_drops(em.epoch, drops)

    def _layer0_table(self) -> torch.Tensor:
        return self.shard if self.feature_source == "ici" else self.cache.cache_values

    def _group_step(self, graph: bool):
        if self.feature_source != "ici":
            return super()._group_step(graph)
        return make_dp_halo_train_step(self.state, self.exchange, graph=graph,
                                       stream=self._side_stream if graph else None)

    def _halo_epoch(self) -> Optional[HaloEpoch]:
        return self._halo

    def _perm_generator(self, epoch: int, gen: torch.Generator) -> torch.Generator:
        """``ici``'s permutation is shared by the ranks: from ``(seed,
        epoch)`` alone; the other sources draw it from the rank's own."""
        if self.feature_source != "ici":
            return gen
        return torch.Generator(device=self.device).manual_seed(epoch_seed(self._seed, epoch))

    def device_data(self) -> DeviceData:
        if self.feature_source == "cache":
            return super().device_data()
        return DeviceData(self._dev_train_nids, self._dev_labels, self._dev_csr, None)

    # -- construction helpers ---------------------------------------------------

    @classmethod
    def from_dataset(cls, cfg: Config, ds: Dataset, *, seed: int = 0,
                     feature_source: str = "cache", dispatch: str = "one2one",
                     **kw) -> "DataParallelTrainer":
        """Partition ``ds`` into one part a rank (``partition.method``: dg,
        kl or hash, at ``partition.num_hops``), deterministically on every
        rank, and train this rank's part over the full store (built with
        the preprocess the model asks for, as ``Trainer.from_dataset``).
        ``ici`` on the device and ``one2all`` sample the full graph: each
        rank's part is the whole graph."""
        refuse_unported(cfg, feature_source, dispatch)
        world, rank = dist.get_world_size(), dist.get_rank()
        hops = cfg.partition.num_hops
        method = cfg.partition.method
        t = cfg.train
        if (feature_source == "ici" and t.on_device_sampling) or (
                t.remote_sampling and dispatch == "one2all"):
            whole = PartitionArtifact(ds.graph, ds.train_nids,
                                      np.arange(ds.num_nodes, dtype=np.int64), ds.labels)
            parts = [whole] * world
        elif method == "dg":
            parts = dg_partition(ds.graph, ds.train_nids, ds.labels, world, hops,
                                 edge_balance=cfg.partition.edge_balance)
        elif method == "kl":
            parts = kl_partition(ds.graph, ds.train_nids, ds.labels, world, hops, seed=seed)
        elif method == "hash":
            parts = hash_partition(ds.graph, ds.train_nids, ds.labels, world, hops, seed=seed)
        else:
            raise ValueError(f"unknown partition method {method!r}")
        m = cfg.model
        pre = ("gcn" if m.arch in ("gcn", "gcn_cv") else m.arch) if m.preprocess else None
        store = FeatureStore.build(ds.graph, ds.features, preprocess=pre)
        if cfg.train.eval_every and "eval_data" not in kw:
            kw["eval_data"] = (ds.graph, ds.features, ds.labels, ds.val_mask)
        return cls(cfg, store, parts[rank], seed=seed,
                   feature_source=feature_source, dispatch=dispatch, **kw)

    @classmethod
    def from_partition(cls, cfg: Config, part: PartitionArtifact, store: FeatureStore,
                       **kw) -> "DataParallelTrainer":
        """This rank's trainer over ``part`` (the constructor's order of
        ``Trainer.from_partition``)."""
        return cls(cfg, store, part, **kw)

    @classmethod
    def from_partition_dir(cls, cfg: Config, dirpath: str, store: FeatureStore,
                           **kw) -> "DataParallelTrainer":
        """This rank's part from partition artifacts on disk
        (``data.formats.save_partition``: one caller partitions once, each
        rank loads only its own part) over the full ``store``."""
        return cls(cfg, store, load_partition(dirpath, dist.get_rank()), **kw)

    # -- cache --------------------------------------------------------------------

    def _maybe_fill_cache(self) -> None:
        """Fill this rank's cache once (never under a halo source).  Host
        path: one capacity for every rank (``cache.capacity``, or the
        smallest of the ranks' ``auto_capacity``), bounded by the largest
        partition; each rank fills ``min(capacity, its vertices)``.
        On-device path: every vertex of the partition, as the JAX
        package's."""
        if self._cache_filled or self.feature_source != "cache":
            return
        c = self.cfg.cache
        if self._device_mode:
            cap = self.cache.graph.num_nodes
        elif not c.enabled:
            cap = 0
        elif c.capacity is not None:
            cap = c.capacity
        else:
            cap = self._all_reduce_ints([self.cache.auto_capacity()], dist.ReduceOp.MIN)[0]
        if not self._device_mode:
            cap = max(0, min(cap, self.max_nodes))
        with self.timers.scope("cache.fill"):
            self.cache.fill(capacity=min(cap, self.cache.graph.num_nodes), rank_by=c.rank_by)
        self._cache_filled = True
        if self.log and self.rank == 0:
            print(f"[cache] per-rank capacity={cap} vertices")

    # -- epochs ---------------------------------------------------------------------

    def _reseed_dropout(self, epoch: int) -> None:
        with self.timers.scope("epoch.seed"):
            self.state.generator.manual_seed(
                rank_epoch_seed(self._seed, epoch, self.rank, _DROPOUT_STREAM))

    def run_epoch(self, epoch: int = 0):
        """One lockstep epoch on every rank (each rank calls it)."""
        self._reseed_dropout(epoch)
        em = super().run_epoch(epoch)
        if self.feature_source == "ici" and not self._device_mode:
            self._count_halo_drops(em, em.halo_drops)
        return em

    def train(self, epochs: Optional[int] = None, *, start_epoch: int = 0) -> Dict:
        """``Trainer.train`` on every rank; on the device path with neither
        evaluation nor checkpoints, the epochs overlap
        (:meth:`_train_on_device`)."""
        tc = self.cfg.train
        if self._device_mode and not tc.eval_every and not (tc.ckpt_dir and tc.ckpt_every):
            with self.timers.scope("train"):
                self._train_on_device(epochs or tc.epochs, start_epoch)
                with self.timers.scope("epoch.metrics"):
                    return self.summary()
        return super().train(epochs, start_epoch=start_epoch)

    def _train_on_device(self, epochs: int, start_epoch: int = 0) -> None:
        """The JAX package's overlapped epochs: epoch e + 1 is enqueued
        before epoch e's metrics are read.  Each epoch's all-reduced metrics
        are copied out of its accumulator on the stream (into pinned memory
        on the card) before the next epoch zeroes it; an epoch's ``time_s``
        runs from the previous epoch's metrics being ready to its own, less
        any capture.  The copy-out is timed as ``epoch.metrics``."""
        prev, t_prev = None, time.perf_counter()
        for e in range(start_epoch, epochs):
            self._reseed_dropout(e)
            capture_s = self.timers.total["capture"]
            self._ready_device_runner()
            t_prev += self.timers.total["capture"] - capture_s
            with self.timers.scope("enqueue"):
                acc = self.enqueue_device_epoch(e)
            with self.timers.scope("epoch.metrics"):
                snap = torch.cat([acc.sums.double(), acc.counts.double()])
                ready = None
                if self.device.type == "cuda":
                    snap = snap.to("cpu", non_blocking=True)     # pinned by PyTorch
                    ready = torch.cuda.Event()
                    ready.record()
            if prev is not None:
                t_prev = self._finish_epoch(*prev, t_prev)
            prev = (e, snap, ready)
        if prev is not None:
            self._finish_epoch(*prev, t_prev)

    def _finish_epoch(self, epoch: int, snap: torch.Tensor, ready, t_prev: float) -> float:
        with self.timers.scope("epoch.wait"):
            if ready is not None:
                ready.synchronize()
        now = time.perf_counter()
        with self.timers.scope("epoch.metrics"):
            self._device_epoch_metrics(epoch, dict(zip(METRIC_NAMES, snap.tolist())),
                                       now - t_prev)
        return now

    def _device_epoch_metrics(self, epoch: int, vals: Dict[str, float], time_s: float):
        em = super()._device_epoch_metrics(epoch, vals, time_s)
        if self.feature_source != "cache":
            self._count_halo_drops(em, int(vals["halo_drops"]))
        return em

    def _host_epoch_totals(self) -> Dict[str, float]:
        """The epoch's metrics over every rank, in one ``all_reduce``: loss
        and accuracy sums divided by the world size (the means over the
        ranks a step, as the JAX package ``pmean``s them), edges, vertices
        and halo drops summed, the miss rate the mean of the ranks' rates."""
        own = super()._host_epoch_totals()
        own["halo_drops"] = self.loader.epoch_halo_drops
        keys = ("loss_sum", "acc_sum", "miss_rate", "edges", "vertices", "halo_drops")
        t = torch.tensor([float(own[k]) for k in keys], dtype=torch.float64,
                         device=self._host_side)
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        t[:3].div_(self.world_size)
        return dict(zip(keys, t.tolist()))

    def _epoch_seed(self, epoch: int) -> int:
        """This rank's epoch randomness (its permutation, and the lockstep
        step count's random integers) comes from ``(seed, epoch, rank)``."""
        return rank_epoch_seed(self._seed, epoch, self.rank)

    # -- checkpoints and evaluation ---------------------------------------------------

    def _checkpoint(self, epoch: int) -> None:
        """Rank 0 writes the replicated train state, and under CV-GCN every
        rank its own histories (``save_aux_shards``); every rank waits
        until all are written."""
        tc, arch = self.cfg.train, self.cfg.model.arch
        if self.rank == 0:
            save_checkpoint(tc.ckpt_dir, arch, epoch, self.state)
        if self.cv_state is not None:
            save_aux_shards(tc.ckpt_dir, arch, epoch, self._cv_aux(), self.rank,
                            self.world_size)
        dist.barrier()

    def _restore_cv_aux(self, epoch: int) -> None:
        """This rank's histories from the complete shard set of checkpoint
        ``epoch``, in place; a set written at another world size raises
        ``ValueError``, and none at all resumes with zero histories and a
        ``RuntimeWarning``, as the JAX package does."""
        shards = open_aux_shards(self.cfg.train.ckpt_dir, self.cfg.model.arch, epoch)
        if shards is None:
            self._zero_cv_aux(epoch)
            return
        mine = shards.get(self.rank)
        if len(shards) != self.world_size or mine is None:
            raise ValueError(
                f"CV aux shard files for epoch {epoch} are missing row {self.rank} -- was "
                f"the checkpoint written with a different mesh size? ({len(shards)} shards "
                f"for {self.world_size} ranks; rows are keyed by rank, the world size must "
                "match)")
        with torch.no_grad():
            for name, dsts in (("hist", self.cv_state.hist_views()),
                               ("agg", self.cv_state.aggs)):
                for b, dst in enumerate(dsts):
                    src = mine[f"{name}{b}"]
                    if src.shape != dst.shape:
                        raise ValueError(f"CV aux shard {name}{b} of rank {self.rank} is "
                                         f"{tuple(src.shape)}, this rank's is "
                                         f"{tuple(dst.shape)}: another partition")
                    dst.copy_(src)

    def _maybe_eval(self, epoch: int) -> None:
        """Every ``train.eval_every`` epochs: rank 0's full-graph accuracy,
        broadcast into every rank's epoch metrics."""
        ev = self.cfg.train.eval_every
        if not ev or (epoch + 1) % ev != 0:
            return
        acc = torch.zeros(1, dtype=torch.float64, device=self._host_side)
        if self.rank == 0:
            from ..models.inference import evaluate

            graph, feats, labels, mask = self._eval_data
            acc.fill_(evaluate(self.state.model, self.cfg.model, graph, feats, labels, mask,
                               backend=self.cfg.train.eval_backend))
        dist.broadcast(acc, src=0)
        if self.epoch_metrics:
            self.epoch_metrics[-1].val_acc = float(acc.item())
        if self.log and self.rank == 0:
            print(f"  [eval] epoch {epoch}: val acc {acc.item():.3f}")

    def summary(self) -> Dict:
        """The JAX package's summary keys: ``num_devices`` and
        ``num_processes`` are the world size, ``halo_drops`` the requests
        dropped over every epoch and rank (0 on the cache source)."""
        out = super().summary()
        last = self.epoch_metrics[-1] if self.epoch_metrics else None
        out.update(num_devices=self.world_size, num_processes=self.world_size,
                   edges_per_epoch=last.edges if last else 0,
                   first_loss=self.epoch_metrics[0].mean_loss if last else None,
                   halo_drops=self.halo_drops)
        return out
