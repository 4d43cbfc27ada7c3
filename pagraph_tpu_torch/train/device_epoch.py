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

Not ported: the data-parallel, ici, edge and CV-GCN device epochs (ROADMAP
queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config
from ..ops.gather import take_rows
from ..sampling.block import MiniBatch
from ..sampling.device_sampler import (DeviceCSR, draw_width, hop_draws, hop_sizes,
                                       sample_minibatch_device)
from .state import CapturedGraph, TrainState, capture_train, compute_dtype, train_on_features

METRIC_NAMES = ("loss_sum", "acc_sum", "steps", "edges", "vertices")


@dataclasses.dataclass
class EpochAccumulator:
    """Device-side metric sums: ``loss_sum`` and ``acc_sum`` in f32;
    ``steps``, ``edges`` and ``vertices`` in int64 (exact at any count)."""

    sums: torch.Tensor      # f32 [2]
    counts: torch.Tensor    # int64 [3]

    @classmethod
    def zeros(cls, device) -> "EpochAccumulator":
        return cls(torch.zeros(2, dtype=torch.float32, device=device),
                   torch.zeros(3, dtype=torch.int64, device=device))

    def zero_(self) -> "EpochAccumulator":
        self.sums.zero_()
        self.counts.zero_()
        return self

    def values(self) -> Dict[str, float]:
        """The metrics by :data:`METRIC_NAMES` (waits for the device)."""
        return dict(zip(METRIC_NAMES, self.sums.tolist() + self.counts.tolist()))


@dataclasses.dataclass
class DeviceData:
    """What every step of the on-device epoch reads and never writes:
    ``train_nids`` int32 ``[n_train]``, ``labels`` int32 ``[N]``, the CSR,
    the full cache (cache row = vertex id) and its int8 dequant scale."""

    train_nids: torch.Tensor
    labels: torch.Tensor
    csr: DeviceCSR
    cache_values: torch.Tensor
    dequant_scale: Optional[torch.Tensor] = None


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
    def allocate(cls, cfg: Config, n_train: int, device) -> "EpochInputs":
        s = cfg.sampler
        nb, b = num_batches(n_train, s.batch_size), s.batch_size
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


def train_batch(state: TrainState, acc: EpochAccumulator, mb: MiniBatch,
                feats: torch.Tensor) -> None:
    """Forward, loss, backward and Adam on a fetched batch; its loss,
    accuracy, valid edges and valid vertices are added to ``acc``."""
    m = train_on_features(state, mb, feats)
    edges = sum(b.neigh_mask.sum() for b in mb.blocks)
    verts = sum(msk.sum() for msk in mb.layer_mask)
    acc.sums += torch.stack([m["loss"], m["acc"]])
    acc.counts += torch.stack([edges.new_ones(()), edges, verts])


def device_batch_step(cfg: Config, state: TrainState, acc: EpochAccumulator,
                      seeds: torch.Tensor, smask: torch.Tensor,
                      draws: Sequence[torch.Tensor], labels: torch.Tensor,
                      csr: DeviceCSR, cache_values: torch.Tensor,
                      dequant_scale: Optional[torch.Tensor] = None) -> None:
    """One step of the on-device epoch (the JAX package's
    ``_make_batch_body``): sample, fetch, train, accumulate."""
    train_batch(state, acc, *fetch_batch(cfg, seeds, smask, draws, labels, csr,
                                         cache_values, dequant_scale))


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


class DeviceEpochRunner:
    """One epoch of ``train.epoch_dispatch``'s function a call:
    ``acc = runner()`` enqueues it over ``inputs`` (the epoch's randomness
    loaded) and returns ``inputs.acc`` without waiting for the device.
    ``graph`` picks the function's form; the graph form of ``pipelined``
    replays each gather on a stream of its own, ``stream`` is where graphs
    are captured.  ``graphs``: the captured graphs (none in the eager
    form)."""

    def __init__(self, cfg: Config, state: TrainState, inputs: EpochInputs,
                 data: DeviceData, *, graph: bool = False,
                 stream: Optional[torch.cuda.Stream] = None):
        self.mode = cfg.train.epoch_dispatch
        self.graph = graph
        self.state, self.inputs = state, inputs
        fns = DISPATCH_FNS[self.mode](cfg, state, inputs, data, graph=graph, stream=stream)
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
