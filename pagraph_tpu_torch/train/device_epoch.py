"""Whole-epoch training on the device (the port of the single-device part of
``pagraph_tpu/train/device_epoch.py``).

When the CSR and the full feature cache live in device memory, an epoch
needs nothing from the host: the train-vertex permutation and every step's
random integers are drawn on the device up front, then each step samples
(:mod:`pagraph_tpu_torch.sampling.device_sampler`), fetches layer 0 from the
cache in the compute dtype (:func:`pagraph_tpu_torch.ops.gather.take_rows`,
one ``pg_assemble`` launch), and runs forward, the masked cross-entropy,
backward and Adam (through ``cast_apply`` at ``train.dtype="bfloat16"``).
Loss, accuracy and the edge and vertex counts accumulate in device tensors,
read once at the end of the epoch.

An epoch reads and writes static buffers (:class:`EpochInputs`), allocated
once and refilled in place: the randomness is drawn into them outside any
graph, from the ``(seed, epoch)`` generator, and the schedule (seeds and
mask) and the accumulator's zeroing run inside the epoch, as in JAX.

Dispatch (``train.epoch_dispatch``): one function a mode, named after
the JAX function it ports, each with two forms chosen by its ``graph``
argument: the eager form (run as PyTorch enqueues it; the CPU's, and the
first epoch's on the card) and the graph form, CUDA graphs captured once
(:class:`CapturedGraph`) and replayed:

* ``scan``, :func:`make_device_epoch_fn`: the whole epoch, schedule and
  ``num_batches`` steps, one graph replayed once an epoch;
* ``steps``, :func:`make_device_step_fns`: a prepare graph (schedule,
  zeroing) and one step's graph replayed ``num_batches`` times; the step
  takes its batch at ``state.step_t % num_batches`` on the device, so
  ``state.step_t`` must be a multiple of ``num_batches`` when an epoch
  starts, as in JAX;
* ``pipelined``, :func:`make_device_pipelined_fns`: a prepare graph, and a
  sample-and-fetch graph and a train graph for each of two batch slots.
  :class:`DeviceEpochRunner` replays the fetch of batch i+1 on a second
  stream ahead of the training of batch i, with events so that a slot is
  not refilled while its batch trains: two fetched batches, as JAX's
  lookahead 1 keeps two fused buffers.

A graph is captured on a warmed state (Adam's moments exist; the kernels
are built), after ``zero_grad(set_to_none=True)``, with the dropout
generator registered, so a replay draws what the eager form draws.
``train.scan_unroll`` has no meaning for a graph and is ignored.

CV-GCN (:func:`make_cv_device_epoch_fn`, the JAX package's
``make_cv_device_epoch_fn``; ``scan`` only): the histories and their
aggregates are device tensors (:class:`CVDeviceState`).  Each step gathers
its slices before the update and scatters the fresh activations after it
(:func:`scatter_last`: the last occurrence of a repeated id in a layer
wins, masked rows go to a spare row), and the epoch ends with the exact
refresh ``agg[b] = window sum of hist[b] * inv_deg``
(``models.inference._BucketedNeighborhoods``, one ``gather_reduce`` launch
a window table).  The whole epoch, refresh included, is one graph.

Data parallel (:func:`make_dp_device_epoch_fn`, the JAX package's
``make_dp_device_epoch_fn``): each rank of the process group runs this
epoch over its own partition, its gradients averaged a step through the
state's ``grad_sync`` (``parallel/train_step.py``).  Its schedule
(:func:`dp_epoch_schedule`) runs ``num_batches``, the lockstep maximum
over the ranks, and a rank with fewer train vertices wraps its permutation
with every seed valid (the reference's make-up sends); only a rank with no
train vertices masks everything.  Its randomness comes from a generator
seeded by ``(seed, epoch, rank)`` (:func:`rank_epoch_seed`).  The epoch
ends with one all-reduce of its metrics (:meth:`EpochAccumulator.
all_reduce_`), after which the accumulator holds what the JAX package's
does: loss and accuracy summed over the steps of their means over the
ranks, the lockstep step count, and the edges and vertices of every rank.
Under ``nccl`` both collectives are inside the epoch's CUDA graph; gloo is
not stream-ordered (it waits for the device on the host), so under gloo
the epoch runs in the eager form only.  ``epoch_dispatch="pipelined"`` runs
this whole-epoch function, as the JAX package's data-parallel trainer
runs its whole-epoch ``shard_map`` in every mode it accepts; ``"steps"`` is
refused (``parallel/dp_trainer.py``).

The halo feature sources (:func:`make_halo_device_epoch_fn`, the JAX
package's ``make_ici_device_epoch_fn`` and ``make_edge_device_epoch_fn``):
the features are sharded across the ranks and each step's layer-0 rows
come from their owners over the halo exchange (``parallel/halo.py``), its
plan built on the device (``device_halo_plan``) from the sampled ids.
``ici`` samples the full graph on every rank: the permutation of the full
train set is shared (drawn from ``(seed, epoch)`` alone), rank ``r`` trains
column ``r`` of the ``[num_batches, P, B]`` seed grid, and the seeds past
the train set are masked (:func:`ici_epoch_schedule`; it does not wrap).
``edge`` samples the rank's own partition with the dp schedule and maps its
layer-0 ids to full ids through ``local2full`` before the exchange.  Both
draw each rank's random integers from ``(seed, epoch, rank)``, count the
dropped requests in the accumulator, and end with its all-reduce.  With
``train.halo_pipeline`` (``edge``) the epoch is a one-deep pipeline: the
sampling and exchange of batch i+1 are issued before batch i trains.  Its
eager form runs them in that order on one stream; its graph form runs the
fetches on a stream of their own inside the one graph, fetch i+1 after
the training of batch i-1 and the training of batch i after fetch i, with
the exchange in a process group of its own (an ``all_to_all`` must not run
beside the step's ``all_reduce`` on one NCCL communicator).  A fetched
batch lives until the graph's end.  The trajectory is the unpipelined
one's to the bit (the fetch draws nothing from the dropout generator).

Data-parallel CV-GCN (the JAX package's ``make_dp_cv_device_epoch_fn`` and
``make_edge_cv_device_epoch_fn``): the ``cache`` and ``edge`` epochs above
(:func:`make_dp_device_epoch_fn`, :func:`make_halo_device_epoch_fn`) given
``cv``, a :class:`CVDeviceState` a rank over the rank's own partition.  Each step
reads and writes the rank's histories as on one device, the epoch ends
with the rank's own refresh, and no collective touches a history: only the
gradients, the metrics and the ``edge`` exchange's rows cross ranks.  The
``edge`` CV epoch runs unpipelined only, as the JAX package's does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config
from ..graph import CSRGraph
from ..models.gcn_cv import layer_widths
from ..models.inference import _BucketedNeighborhoods
from ..ops.gather import take_rows
from ..sampling.block import MiniBatch
from ..sampling.device_sampler import (DeviceCSR, draw_width, hop_draws, hop_sizes,
                                       sample_minibatch_device)
from .state import CapturedGraph, TrainState, capture_train, compute_dtype, train_on_features

METRIC_NAMES = ("loss_sum", "acc_sum", "steps", "edges", "vertices", "halo_drops")


@dataclasses.dataclass
class EpochAccumulator:
    """Device-side metric sums: ``loss_sum`` and ``acc_sum`` in f32;
    ``steps``, ``edges``, ``vertices`` and ``halo_drops`` (the halo
    requests dropped past the static width) in int64 (exact at any
    count)."""

    sums: torch.Tensor      # f32 [2]
    counts: torch.Tensor    # int64 [4]

    @classmethod
    def zeros(cls, device) -> "EpochAccumulator":
        return cls(torch.zeros(2, dtype=torch.float32, device=device),
                   torch.zeros(4, dtype=torch.int64, device=device))

    def zero_(self) -> "EpochAccumulator":
        self.sums.zero_()
        self.counts.zero_()
        return self

    def values(self) -> Dict[str, float]:
        """The metrics by :data:`METRIC_NAMES` (waits for the device)."""
        return dict(zip(METRIC_NAMES, self.sums.tolist() + self.counts.tolist()))

    def all_reduce_(self) -> "EpochAccumulator":
        """Each rank's sums to the process group's, in one ``all_reduce``
        (of f64 copies: the counts stay exact below 2^53), then loss,
        accuracy and steps divided by the world size: the means over the
        ranks, as the JAX package ``pmean``s them a step, and the lockstep
        step count.  No host sync: it can be captured under ``nccl``."""
        import torch.distributed as dist

        world = dist.get_world_size()
        both = torch.cat([self.sums.double(), self.counts.double()])
        dist.all_reduce(both, op=dist.ReduceOp.SUM)
        both[:3].div_(world)
        self.sums.copy_(both[:2])
        self.counts.copy_(both[2:].round())
        return self


@dataclasses.dataclass
class DeviceData:
    """What every step of the on-device epoch reads and never writes:
    ``train_nids`` int32 ``[n_train]``, ``labels`` int32 ``[N]``, the CSR,
    the full cache (cache row = vertex id) and its int8 dequant scale (the
    halo epochs read no cache: ``None``)."""

    train_nids: torch.Tensor
    labels: torch.Tensor
    csr: DeviceCSR
    cache_values: Optional[torch.Tensor]
    dequant_scale: Optional[torch.Tensor] = None


@dataclasses.dataclass
class HaloEpoch:
    """What a halo device epoch adds to :class:`DeviceData`: the rank's
    ``exchange`` (``parallel.halo.HaloExchange``), its ``rank`` and the
    ``world_size``; ``local2full`` int32 ``[N_local]`` for ``edge``
    (``None``: ``ici``, whose ids are full ids and whose schedule is
    :func:`ici_epoch_schedule`); ``pipeline``: ``train.halo_pipeline``."""

    exchange: object
    rank: int
    world_size: int
    local2full: Optional[torch.Tensor] = None
    pipeline: bool = False

    @property
    def ici(self) -> bool:
        return self.local2full is None


def num_batches(n_train: int, batch_size: int) -> int:
    return -(-n_train // batch_size)


@dataclasses.dataclass
class EpochInputs:
    """An epoch's static buffers, allocated once and refilled in place each
    epoch, so that a captured graph finds them at the same addresses:
    ``perm`` int64 ``[n_train]`` and ``draws`` (one int32 ``[num_batches,
    hop dst vertices, draw width]`` a hop), drawn outside the graphs; the
    schedule ``seeds_all`` int32 and ``mask_all`` bool ``[num_batches,
    B]`` and the accumulator, written inside; ``counter``, the pipelined
    fetch's batch index (int64, 0-d)."""

    perm: torch.Tensor
    draws: Tuple[torch.Tensor, ...]
    seeds_all: torch.Tensor
    mask_all: torch.Tensor
    acc: EpochAccumulator
    counter: torch.Tensor

    @classmethod
    def allocate(cls, cfg: Config, n_train: int, device,
                 steps: Optional[int] = None) -> "EpochInputs":
        """``steps``: the batches an epoch (default: ``n_train``'s; the
        data-parallel epoch's lockstep maximum over the ranks)."""
        s = cfg.sampler
        b = s.batch_size
        nb = num_batches(n_train, b) if steps is None else steps
        draws = tuple(torch.empty((nb, n, draw_width(f, s.paired_draws)), dtype=torch.int32,
                                  device=device)
                      for n, f in zip(hop_sizes(b, s.hop_fanouts()), s.hop_fanouts()))
        return cls(perm=torch.empty(n_train, dtype=torch.int64, device=device), draws=draws,
                   seeds_all=torch.empty((nb, b), dtype=torch.int32, device=device),
                   mask_all=torch.empty((nb, b), dtype=torch.bool, device=device),
                   acc=EpochAccumulator.zeros(device),
                   counter=torch.zeros((), dtype=torch.int64, device=device))

    @property
    def num_batches(self) -> int:
        return self.seeds_all.shape[0]

    def load(self, perm: torch.Tensor, draws: Sequence[torch.Tensor]) -> None:
        """Take an epoch's ``(perm, draws)``: copied in, unless they were
        drawn into these buffers (:func:`epoch_draws` with ``out``)."""
        for dst, src in zip((self.perm, *self.draws), (perm, *draws), strict=True):
            if src.data_ptr() != dst.data_ptr():
                dst.copy_(src)


def epoch_seed(seed: int, epoch: int) -> int:
    """The seed of an epoch's generator: a function of ``(seed, epoch)``
    only, so any epoch can be replayed alone."""
    return int(np.random.SeedSequence([seed ^ 0x5EED, epoch]).generate_state(1, np.uint64)[0])


def rank_epoch_seed(seed: int, epoch: int, rank: int, stream: int = 0) -> int:
    """The seed of a data-parallel rank's epoch generator, a function of
    ``(seed, epoch, rank)`` only (the counterpart of the JAX package's
    ``fold_in(fold_in(key, epoch), rank)``, ``host_fold_key``); ``stream``
    tells apart generators of one epoch (0: the epoch's randomness, 1: the
    rank's dropout)."""
    return int(np.random.SeedSequence([seed ^ 0x5EED, epoch, rank, stream])
               .generate_state(1, np.uint64)[0])


def dp_epoch_schedule(perm: torch.Tensor, train_nids: torch.Tensor,
                      out: Tuple[torch.Tensor, torch.Tensor]) -> None:
    """A data-parallel rank's seeds and mask into ``out`` (``[nb, B]``,
    ``nb`` the lockstep maximum): the permutation wrapped around with every
    seed valid (the JAX package's make-up seeds); a rank with no train
    vertices trains on vertex 0, every seed masked."""
    seeds, mask = out
    n_train = train_nids.shape[0]
    if n_train == 0:
        seeds.zero_()
        mask.fill_(False)
        return
    idx = torch.arange(seeds.numel(), device=train_nids.device)
    seeds.view(-1).copy_(train_nids.index_select(0, perm.index_select(0, idx % n_train)))
    mask.fill_(True)


def ici_epoch_schedule(perm: torch.Tensor, train_nids: torch.Tensor, rank: int, world: int,
                       out: Tuple[torch.Tensor, torch.Tensor]) -> None:
    """An ``ici`` rank's seeds and mask into ``out`` (``[nb, B]``): column
    ``rank`` of the ``[nb, world, B]`` grid of the shared permutation of
    the full train set, wrapped to fill the grid, the wrapped seeds masked
    (the JAX package's one2all round robin inside
    ``make_ici_device_epoch_fn``)."""
    seeds, mask = out
    nb, b = seeds.shape
    n_train = train_nids.shape[0]
    dev = train_nids.device
    idx = ((torch.arange(nb, device=dev)[:, None] * world + rank) * b
           + torch.arange(b, device=dev)[None, :]).view(-1)
    seeds.view(-1).copy_(train_nids.index_select(0, perm.index_select(0, idx % n_train)))
    torch.lt(idx, n_train, out=mask.view(-1))


def epoch_schedule(perm: torch.Tensor, train_nids: torch.Tensor, batch_size: int,
                   out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Seeds int32 ``[nb, B]`` and their mask bool ``[nb, B]`` of an epoch
    from a permutation of ``range(n_train)``.  The tail batch is padded by
    wrapping the permutation, and the padded seeds are masked out of
    sampling, loss and metrics (the JAX package's ``_epoch_schedule`` with
    the permutation as an argument).  ``out``: the ``(seeds, mask)``
    buffers to write."""
    n_train = train_nids.shape[0]
    nb = num_batches(n_train, batch_size)
    if out is None:
        out = (torch.empty((nb, batch_size), dtype=torch.int32, device=train_nids.device),
               torch.empty((nb, batch_size), dtype=torch.bool, device=train_nids.device))
    seeds, mask = out
    idx = torch.arange(nb * batch_size, device=train_nids.device)
    seeds.view(-1).copy_(train_nids.index_select(0, perm.index_select(0, idx % n_train)))
    torch.lt(idx, n_train, out=mask.view(-1))
    return seeds, mask


def epoch_draws(generator: torch.Generator, num_batches: int, batch_size: int,
                fanouts: Sequence[int], paired: bool, device,
                out: Optional[Sequence[torch.Tensor]] = None) -> Tuple[torch.Tensor, ...]:
    """Every step's random integers for an epoch, one int32 tensor a hop,
    ``[num_batches, hop dst vertices, draw width]`` (the JAX package derives
    them from per-step keys), into ``out`` when given.  At batch 6000,
    fan-out 2, 2 hops: 48,000 integers, 192 KB, a step; 24,000 with paired
    draws."""
    outs = out if out is not None else (None,) * len(fanouts)
    return tuple(hop_draws(generator, n, f, paired, device, steps=num_batches, out=o)
                 for n, f, o in zip(hop_sizes(batch_size, fanouts), fanouts, outs,
                                    strict=True))


def fetch_batch(cfg: Config, seeds: torch.Tensor, smask: torch.Tensor,
                draws: Sequence[torch.Tensor], labels: torch.Tensor, csr: DeviceCSR,
                cache_values: torch.Tensor,
                dequant_scale: Optional[torch.Tensor] = None) -> Tuple[MiniBatch, torch.Tensor]:
    """Sample one batch on the device and fetch its layer-0 features from
    the full cache in the compute dtype (f32, or bf16 at
    ``train.dtype="bfloat16"``): ``(mb, feats)``."""
    s = cfg.sampler
    mb = sample_minibatch_device(csr, seeds, smask, s.num_hops, s.hop_fanouts(), draws,
                                 labels=labels, paired=s.paired_draws)
    return mb, take_rows(cache_values, mb.input_nids, dequant_scale,
                         out_dtype=compute_dtype(cfg))


@dataclasses.dataclass
class CVDeviceState:
    """CV-GCN's state on the device: ``hists[b]`` f32 ``[N + 1, w_b]`` (row
    ``N`` is spare: masked rows and the losing occurrences of a repeated id
    are written there, and nothing reads it), ``aggs[b]`` f32 ``[N, w_b]``,
    the refresh's window tables (built on the host once, before any
    capture) and ``inv_deg`` f32 ``[N, 1]``, ``1 / max(in_degree, 1)``."""

    hists: Tuple[torch.Tensor, ...]
    aggs: Tuple[torch.Tensor, ...]
    windows: _BucketedNeighborhoods
    inv_deg: torch.Tensor

    @classmethod
    def allocate(cls, cfg: Config, graph: CSRGraph, device) -> "CVDeviceState":
        n, widths = graph.num_nodes, layer_widths(cfg.model)
        inv = (1.0 / np.maximum(graph.in_degrees, 1)).astype(np.float32)
        return cls(hists=tuple(torch.zeros((n + 1, w), device=device) for w in widths),
                   aggs=tuple(torch.zeros((n, w), device=device) for w in widths),
                   windows=_BucketedNeighborhoods(graph, device),
                   inv_deg=torch.from_numpy(inv).to(device)[:, None])

    @property
    def num_nodes(self) -> int:
        return self.aggs[0].shape[0]

    def hist_views(self) -> List[torch.Tensor]:
        """Each ``hists[b]`` without its spare row: ``[N, w_b]``."""
        return [h[:self.num_nodes] for h in self.hists]

    def refresh(self) -> None:
        """``aggs[b] = (sum over in-neighbors of hist[b]) * inv_deg``, into
        the aggregates' own tensors."""
        for h, a in zip(self.hist_views(), self.aggs):
            torch.mul(self.windows.aggregate(h, "sum"), self.inv_deg, out=a)


def scatter_last(table: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor,
                 values: torch.Tensor) -> None:
    """``table[ids[i]] = values[i]`` for every valid ``i`` (``mask``), where
    of the valid positions holding one id the last wins; every other
    position writes the spare last row of ``table``.  Deterministic (the
    winner is the int64 ``amax`` of the positions an id takes, one write a
    winning id), with no host sync, so a CUDA graph replays it
    bit-equal."""
    spare = table.shape[0] - 1
    pos = torch.arange(ids.shape[0], device=ids.device)
    tgt = torch.where(mask, ids.long(), spare)
    last = torch.full((table.shape[0],), -1, dtype=torch.int64, device=ids.device)
    last.scatter_reduce_(0, tgt, pos, "amax")
    win = (last.index_select(0, tgt) == pos) & mask
    table.index_copy_(0, torch.where(win, tgt, spare), values)


def train_batch(state: TrainState, acc: EpochAccumulator, mb: MiniBatch,
                feats: torch.Tensor, cv: Optional[CVDeviceState] = None,
                drops: Optional[torch.Tensor] = None) -> None:
    """Forward, loss, backward and Adam on a fetched batch; its loss,
    accuracy, valid edges and valid vertices (and the halo requests it
    dropped, ``drops``) are added to ``acc``.  With ``cv`` (CV-GCN) the
    batch's history slices are gathered before the update and the fresh
    activations scattered after it."""
    hists = None
    if cv is not None:
        nl = len(mb.blocks)
        hists = ([cv.hists[b].index_select(0, mb.layer_nids[b]) for b in range(nl)],
                 [cv.aggs[b].index_select(0, mb.layer_nids[b + 1]) for b in range(nl)])
    m = train_on_features(state, mb, feats, hists)
    if cv is not None:
        with torch.no_grad():
            for b, nh in enumerate(m["new_hists"]):
                scatter_last(cv.hists[b], mb.layer_nids[b], mb.layer_mask[b], nh)
    edges = sum(b.neigh_mask.sum() for b in mb.blocks)
    verts = sum(msk.sum() for msk in mb.layer_mask)
    acc.sums += torch.stack([m["loss"], m["acc"]])
    acc.counts += torch.stack([edges.new_ones(()), edges, verts,
                               edges.new_zeros(()) if drops is None else drops])


def device_batch_step(cfg: Config, state: TrainState, acc: EpochAccumulator,
                      seeds: torch.Tensor, smask: torch.Tensor,
                      draws: Sequence[torch.Tensor], labels: torch.Tensor,
                      csr: DeviceCSR, cache_values: torch.Tensor,
                      dequant_scale: Optional[torch.Tensor] = None,
                      cv: Optional[CVDeviceState] = None) -> None:
    """One step of the on-device epoch (the JAX package's
    ``_make_batch_body``, and with ``cv`` the body of its
    ``make_cv_device_epoch_fn``): sample, fetch, train, accumulate."""
    train_batch(state, acc, *fetch_batch(cfg, seeds, smask, draws, labels, csr,
                                         cache_values, dequant_scale), cv)


def _prepare(cfg: Config, inputs: EpochInputs, data: DeviceData) -> None:
    """The epoch's schedule into its buffers, the accumulator and the fetch
    counter zeroed (the JAX package's ``prepare_fn``)."""
    epoch_schedule(inputs.perm, data.train_nids, cfg.sampler.batch_size,
                   out=(inputs.seeds_all, inputs.mask_all))
    inputs.acc.zero_()
    inputs.counter.zero_()


def _batch_at(inputs: EpochInputs, i: torch.Tensor):
    """Seeds, mask and draws of batch ``i`` (int64 0-d on the device)."""
    i = i.view(1)
    return (inputs.seeds_all.index_select(0, i)[0], inputs.mask_all.index_select(0, i)[0],
            [d.index_select(0, i)[0] for d in inputs.draws])


def make_device_epoch_fn(cfg: Config, state: TrainState, inputs: EpochInputs,
                         data: DeviceData, *, graph: bool = False,
                         stream: Optional[torch.cuda.Stream] = None) -> Callable:
    """``scan``: ``acc = epoch_fn()`` trains ``state`` for one epoch over
    ``inputs`` (the randomness loaded) and returns ``inputs.acc`` without
    waiting for the device: the schedule, the zeroing and every step.
    ``graph=True`` captures it on ``stream`` as one CUDA graph."""
    if not cfg.sampler.include_self:
        raise ValueError("on-device sampling requires include_self=True")
    nb = inputs.num_batches

    def epoch_fn() -> EpochAccumulator:
        _prepare(cfg, inputs, data)
        for i in range(nb):
            device_batch_step(cfg, state, inputs.acc, inputs.seeds_all[i], inputs.mask_all[i],
                              [d[i] for d in inputs.draws], data.labels, data.csr,
                              data.cache_values, data.dequant_scale)
        return inputs.acc

    return capture_train(state, epoch_fn, nb, stream=stream) if graph else epoch_fn


def make_dp_device_epoch_fn(cfg: Config, state: TrainState, inputs: EpochInputs,
                            data: DeviceData, *, graph: bool = False,
                            stream: Optional[torch.cuda.Stream] = None,
                            cv: Optional[CVDeviceState] = None) -> Callable:
    """The data-parallel ``scan``: ``acc = epoch_fn()`` trains ``state``
    (its ``grad_sync`` set) for one lockstep epoch over this rank's
    ``inputs`` (:func:`dp_epoch_schedule`) and returns ``inputs.acc``
    all-reduced over the ranks (:meth:`EpochAccumulator.all_reduce_`),
    without waiting for the device.  ``cv``: the rank's CV-GCN histories,
    read and written each step and refreshed at the epoch's end (the JAX
    package's ``make_dp_cv_device_epoch_fn``).
    ``graph=True`` captures it on ``stream`` as one CUDA graph, the
    collectives (and the refresh) inside (``nccl`` only)."""
    if not cfg.sampler.include_self:
        raise ValueError("on-device sampling requires include_self=True")
    if state.grad_sync is None:
        raise ValueError("the data-parallel epoch needs the state's grad_sync")
    nb = inputs.num_batches

    def epoch_fn() -> EpochAccumulator:
        dp_epoch_schedule(inputs.perm, data.train_nids, out=(inputs.seeds_all, inputs.mask_all))
        inputs.acc.zero_()
        for i in range(nb):
            device_batch_step(cfg, state, inputs.acc, inputs.seeds_all[i], inputs.mask_all[i],
                              [d[i] for d in inputs.draws], data.labels, data.csr,
                              data.cache_values, data.dequant_scale, cv)
        if cv is not None:
            cv.refresh()
        return inputs.acc.all_reduce_()

    return capture_train(state, epoch_fn, nb, stream=stream) if graph else epoch_fn


def fetch_halo_batch(cfg: Config, seeds: torch.Tensor, smask: torch.Tensor,
                     draws: Sequence[torch.Tensor], labels: torch.Tensor, csr: DeviceCSR,
                     halo: HaloEpoch) -> Tuple[MiniBatch, torch.Tensor, torch.Tensor]:
    """Sample one batch on the device and fetch its layer-0 rows from their
    owners (the plan built on the device, one exchange) in the compute
    dtype: ``(mb, feats, drops)``, ``drops`` the valid rows whose request
    was dropped (int64, 0-d)."""
    from ..parallel.halo import device_halo_plan, src_rows

    s = cfg.sampler
    mb = sample_minibatch_device(csr, seeds, smask, s.num_hops, s.hop_fanouts(), draws,
                                 labels=labels, paired=s.paired_draws)
    ids = mb.input_nids if halo.ici else halo.local2full.index_select(0, mb.input_nids)
    ex = halo.exchange
    plan = device_halo_plan(ids, mb.input_mask, ex.world_size, ex.halo_width)
    feats = ex(plan.req, src_rows(plan), compute_dtype(cfg))
    return mb, feats, (mb.input_mask & ~plan.valid).sum()


def make_halo_device_epoch_fn(cfg: Config, state: TrainState, inputs: EpochInputs,
                              data: DeviceData, halo: HaloEpoch, *, graph: bool = False,
                              stream: Optional[torch.cuda.Stream] = None,
                              cv: Optional[CVDeviceState] = None) -> Callable:
    """The halo feature sources' ``scan`` (``ici`` or ``edge``, :class:`HaloEpoch`):
    ``acc = epoch_fn()`` trains ``state`` (its ``grad_sync`` set) for one
    lockstep epoch and returns ``inputs.acc`` all-reduced over the ranks,
    without waiting for the device; with ``halo.pipeline`` one-deep
    pipelined.  ``cv``: the rank's CV-GCN histories (``edge`` unpipelined
    only: the JAX package's ``make_edge_cv_device_epoch_fn``), refreshed at
    the epoch's end.  ``graph=True`` captures it on
    ``stream`` as one CUDA graph, every collective inside (``nccl`` only)."""
    if not cfg.sampler.include_self:
        raise ValueError("on-device sampling requires include_self=True")
    if state.grad_sync is None:
        raise ValueError("the data-parallel epoch needs the state's grad_sync")
    if cv is not None and (halo.ici or halo.pipeline):
        raise ValueError("CV-GCN's halo epoch is the unpipelined edge source's")
    nb = inputs.num_batches
    fetch_stream = (torch.cuda.Stream(device=inputs.perm.device)
                    if graph and halo.pipeline else None)

    def fetch(i: int):
        return fetch_halo_batch(cfg, inputs.seeds_all[i], inputs.mask_all[i],
                                [d[i] for d in inputs.draws], data.labels, data.csr, halo)

    def train(batch) -> None:
        mb, feats, drops = batch
        train_batch(state, inputs.acc, mb, feats, cv, drops)

    def pipelined_on_streams() -> None:
        """Fetch i+1 on ``fetch_stream`` once batch i-1 has trained; train
        i on the current stream once fetch i is done."""
        main = torch.cuda.current_stream()
        fetched = [torch.cuda.Event() for _ in range(nb)]
        trained = [torch.cuda.Event() for _ in range(nb)]
        batches = []
        fetch_stream.wait_stream(main)
        with torch.cuda.stream(fetch_stream):
            batches.append(fetch(0))
            fetched[0].record()
        for i in range(nb):
            if i + 1 < nb:
                with torch.cuda.stream(fetch_stream):
                    if i:
                        fetch_stream.wait_event(trained[i - 1])
                    batches.append(fetch(i + 1))
                    fetched[i + 1].record()
            main.wait_event(fetched[i])
            train(batches[i])
            trained[i].record()
        main.wait_stream(fetch_stream)

    def epoch_fn() -> EpochAccumulator:
        if halo.ici:
            ici_epoch_schedule(inputs.perm, data.train_nids, halo.rank, halo.world_size,
                               out=(inputs.seeds_all, inputs.mask_all))
        else:
            dp_epoch_schedule(inputs.perm, data.train_nids,
                              out=(inputs.seeds_all, inputs.mask_all))
        inputs.acc.zero_()
        if fetch_stream is not None:
            pipelined_on_streams()
        elif halo.pipeline:
            batch = fetch(0)
            for i in range(nb):
                nxt = fetch(i + 1) if i + 1 < nb else None
                train(batch)
                batch = nxt
        else:
            for i in range(nb):
                train(fetch(i))
        if cv is not None:
            cv.refresh()
        return inputs.acc.all_reduce_()

    return capture_train(state, epoch_fn, nb, stream=stream) if graph else epoch_fn


def make_cv_device_epoch_fn(cfg: Config, state: TrainState, inputs: EpochInputs,
                            data: DeviceData, cv: CVDeviceState, *, graph: bool = False,
                            stream: Optional[torch.cuda.Stream] = None) -> Callable:
    """CV-GCN's ``scan``: ``acc = epoch_fn()`` trains ``state`` and the
    histories ``cv`` for one epoch over ``inputs`` and ends with the exact
    refresh of every aggregate (:meth:`CVDeviceState.refresh`); returns
    ``inputs.acc`` without waiting for the device.  ``graph=True`` captures
    all of it on ``stream`` as one CUDA graph."""
    if not cfg.sampler.include_self:
        raise ValueError("on-device sampling requires include_self=True")
    nb = inputs.num_batches

    def epoch_fn() -> EpochAccumulator:
        _prepare(cfg, inputs, data)
        for i in range(nb):
            device_batch_step(cfg, state, inputs.acc, inputs.seeds_all[i], inputs.mask_all[i],
                              [d[i] for d in inputs.draws], data.labels, data.csr,
                              data.cache_values, data.dequant_scale, cv)
        cv.refresh()
        return inputs.acc

    return capture_train(state, epoch_fn, nb, stream=stream) if graph else epoch_fn


def make_device_step_fns(cfg: Config, state: TrainState, inputs: EpochInputs,
                         data: DeviceData, *, graph: bool = False,
                         stream: Optional[torch.cuda.Stream] = None) -> Tuple[Callable, Callable]:
    """``steps``: ``(prepare_fn, step_fn)``; an epoch is ``prepare_fn()``,
    then ``step_fn()`` ``num_batches`` times.  ``step_fn`` trains on batch
    ``state.step_t % num_batches``, indexed on the device: nothing comes
    from the host a step.  ``graph=True`` captures each as a CUDA graph."""
    if not cfg.sampler.include_self:
        raise ValueError("on-device sampling requires include_self=True")
    nb = inputs.num_batches

    def prepare_fn() -> None:
        _prepare(cfg, inputs, data)

    def step_fn() -> None:
        seeds, smask, draws = _batch_at(inputs, torch.remainder(state.step_t, nb))
        device_batch_step(cfg, state, inputs.acc, seeds, smask, draws, data.labels,
                          data.csr, data.cache_values, data.dequant_scale)

    if not graph:
        return prepare_fn, step_fn
    return (CapturedGraph(prepare_fn, stream=stream),
            capture_train(state, step_fn, 1, stream=stream))


def make_device_pipelined_fns(cfg: Config, state: TrainState, inputs: EpochInputs,
                              data: DeviceData, *, graph: bool = False,
                              stream: Optional[torch.cuda.Stream] = None) -> tuple:
    """``pipelined``: ``(prepare_fn, gather_fns, train_fns)``, the last two
    one function for each of two batch slots.  ``gather_fns[k]()`` samples
    and fetches batch ``inputs.counter`` (then advances it) into slot k,
    state-independent; ``train_fns[k]()`` trains on slot k.  An epoch is
    ``prepare_fn()``, ``gather_fns[0]()``, then for each batch i the gather
    of i+1 into slot (i+1) % 2 and the training of slot i % 2
    (:class:`DeviceEpochRunner`).  In the eager form a slot is emptied
    once trained; in the graph form each slot is the static output of its
    gather graph.  A gather may run beside the training of the other slot,
    so each gather graph has a memory pool of its own: in a shared pool one
    gather's scratch could be the other's slot.  The train graphs, which run
    one after the other, share a pool."""
    if not cfg.sampler.include_self:
        raise ValueError("on-device sampling requires include_self=True")
    nb = inputs.num_batches
    slots: List[Optional[Tuple[MiniBatch, torch.Tensor]]] = [None, None]

    def prepare_fn() -> None:
        _prepare(cfg, inputs, data)

    def gather(k: int):
        seeds, smask, draws = _batch_at(inputs, torch.remainder(inputs.counter, nb))
        inputs.counter.add_(1)
        slots[k] = fetch_batch(cfg, seeds, smask, draws, data.labels, data.csr,
                               data.cache_values, data.dequant_scale)
        return slots[k]

    def train(k: int) -> None:
        train_batch(state, inputs.acc, *slots[k])

    if not graph:
        def train_and_free(k: int) -> None:
            train(k)
            slots[k] = None
        return (prepare_fn, tuple(lambda k=k: gather(k) for k in range(2)),
                tuple(lambda k=k: train_and_free(k) for k in range(2)))
    train_pool = torch.cuda.graph_pool_handle()
    gathers = tuple(CapturedGraph(lambda k=k: gather(k), stream=stream) for k in range(2))
    trains = tuple(capture_train(state, lambda k=k: train(k), 1, stream=stream,
                                  pool=train_pool) for k in range(2))
    return CapturedGraph(prepare_fn, stream=stream), gathers, trains


DISPATCH_FNS = {"scan": make_device_epoch_fn, "steps": make_device_step_fns,
            "pipelined": make_device_pipelined_fns}

# the JAX package's refusal of the per-step dispatch modes for CV-GCN
CV_DISPATCH_ERROR = ("epoch_dispatch={!r} does not support gcn_cv (the epoch-end "
                     "aggregated-history refresh needs the whole-epoch dispatch); use "
                     "epoch_dispatch='scan'")


class DeviceEpochRunner:
    """One epoch of ``train.epoch_dispatch``'s function a call:
    ``acc = runner()`` enqueues it over ``inputs`` (the epoch's randomness
    loaded) and returns ``inputs.acc`` without waiting for the device.
    ``cv``: CV-GCN's device state, whose epoch is
    :func:`make_cv_device_epoch_fn` (``scan`` only: any other mode raises
    ``ValueError``).  ``dp``: a data-parallel rank, whose epoch is
    :func:`make_dp_device_epoch_fn` in every mode the trainer accepts, or
    with ``halo`` (:class:`HaloEpoch`) :func:`make_halo_device_epoch_fn`,
    either given ``cv`` for data-parallel CV-GCN.
    ``graph`` picks the function's form; the graph form of ``pipelined``
    replays each gather on a stream of its own, ``stream`` is where graphs
    are captured.  ``graphs``: the captured graphs (none in the eager
    form)."""

    def __init__(self, cfg: Config, state: TrainState, inputs: EpochInputs,
                 data: DeviceData, *, graph: bool = False,
                 stream: Optional[torch.cuda.Stream] = None,
                 cv: Optional[CVDeviceState] = None, dp: bool = False,
                 halo: Optional[HaloEpoch] = None):
        self.mode = cfg.train.epoch_dispatch
        self.graph = graph
        self.state, self.inputs = state, inputs
        if halo is not None:
            self.mode = "scan"
            fns = make_halo_device_epoch_fn(cfg, state, inputs, data, halo, graph=graph,
                                            stream=stream, cv=cv)
        elif dp:
            self.mode = "scan"
            fns = make_dp_device_epoch_fn(cfg, state, inputs, data, graph=graph,
                                          stream=stream, cv=cv)
        elif cv is not None:
            if self.mode != "scan":
                raise ValueError(CV_DISPATCH_ERROR.format(self.mode))
            fns = make_cv_device_epoch_fn(cfg, state, inputs, data, cv, graph=graph,
                                          stream=stream)
        else:
            fns = DISPATCH_FNS[self.mode](cfg, state, inputs, data, graph=graph,
                                          stream=stream)
        self.fns = fns if isinstance(fns, tuple) else (fns,)
        flat = [f for x in self.fns for f in (x if isinstance(x, tuple) else (x,))]
        self.graphs = [f for f in flat if isinstance(f, CapturedGraph)]
        if graph and self.mode == "pipelined":
            self._fetch_stream = torch.cuda.Stream(device=inputs.perm.device)
            self._fetched = [torch.cuda.Event() for _ in range(2)]
            self._trained = [torch.cuda.Event() for _ in range(2)]

    def replayed_launches(self) -> Dict[str, int]:
        """Gather-kernel launches made by the replays so far."""
        out: Dict[str, int] = {}
        for g in self.graphs:
            for k, v in g.launches.items():
                out[k] = out.get(k, 0) + v * g.replays
        return out

    def __call__(self) -> EpochAccumulator:
        nb = self.inputs.num_batches
        if self.mode == "scan":
            return self.fns[0]()
        if self.mode == "steps":
            prepare_fn, step_fn = self.fns
            prepare_fn()
            for _ in range(nb):
                step_fn()
            return self.inputs.acc
        prepare_fn, gathers, trains = self.fns
        gather = self._gather_on_stream if self.graph else (lambda k: gathers[k]())
        prepare_fn()
        if self.graph:
            self._fetch_stream.wait_stream(torch.cuda.current_stream())
        gather(0)
        for i in range(nb):
            if i + 1 < nb:
                gather((i + 1) % 2)
            k = i % 2
            if self.graph:
                torch.cuda.current_stream().wait_event(self._fetched[k])
            trains[k]()
            if self.graph:
                self._trained[k].record()
        return self.inputs.acc

    def _gather_on_stream(self, k: int) -> None:
        """Replay slot k's gather on the fetch stream once the training
        that last read slot k is done; record when it is fetched."""
        gathers = self.fns[1]
        with torch.cuda.stream(self._fetch_stream):
            self._fetch_stream.wait_event(self._trained[k])
            gathers[k]()
            self._fetched[k].record()
