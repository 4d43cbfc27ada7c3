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

Dispatch (``train.epoch_dispatch``): the JAX package compiles ``scan`` into
one dispatch an epoch and ``steps`` into one a step, and ``pipelined``
splits a step into a sample-and-fetch dispatch enqueued one batch ahead and
a train dispatch.  PyTorch runs eagerly and enqueues every kernel on one
stream without waiting, so all three are the same loop here: the host
enqueues the whole epoch with no sync, and enqueuing batch i+1's fetch
before batch i's training would only reorder work on that stream, not
overlap it (it would also keep two batches alive).  A separate pipelined
path needs a second stream or a CUDA graph.  ``train.scan_unroll`` (how
many steps XLA unrolls into one scan iteration) has no meaning in an eager
loop and is ignored.  Capturing a step as a CUDA graph is the tool for the
per-step launch cost; it is not done here.

Not ported: the data-parallel, ici, edge and CV-GCN device epochs (ROADMAP
queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config
from ..ops.gather import take_rows
from ..sampling.block import MiniBatch
from ..sampling.device_sampler import (DeviceCSR, hop_draws, hop_sizes,
                                       sample_minibatch_device)
from .state import TrainState, compute_dtype, train_on_features

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

    def values(self) -> Dict[str, float]:
        """The metrics by :data:`METRIC_NAMES` (waits for the device)."""
        return dict(zip(METRIC_NAMES, self.sums.tolist() + self.counts.tolist()))


def epoch_seed(seed: int, epoch: int) -> int:
    """The seed of an epoch's generator: a function of ``(seed, epoch)``
    only, so any epoch can be replayed alone."""
    return int(np.random.SeedSequence([seed ^ 0x5EED, epoch]).generate_state(1, np.uint64)[0])


def epoch_schedule(perm: torch.Tensor, train_nids: torch.Tensor,
                   batch_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Seeds int32 ``[nb, B]`` and their mask bool ``[nb, B]`` of an epoch
    from a permutation of ``range(n_train)``.  The tail batch is padded by
    wrapping the permutation, and the padded seeds are masked out of
    sampling, loss and metrics (the JAX package's ``_epoch_schedule`` with
    the permutation as an argument)."""
    n_train = train_nids.shape[0]
    num_batches = -(-n_train // batch_size)
    idx = torch.arange(num_batches * batch_size, device=train_nids.device)
    seeds = train_nids.index_select(0, perm.index_select(0, idx % n_train))
    mask = idx < n_train
    return (seeds.view(num_batches, batch_size).to(torch.int32),
            mask.view(num_batches, batch_size))


def epoch_draws(generator: torch.Generator, num_batches: int, batch_size: int,
                fanouts: Sequence[int], paired: bool, device) -> Tuple[torch.Tensor, ...]:
    """Every step's random integers for an epoch, one int32 tensor a hop,
    ``[num_batches, hop dst vertices, draw width]`` (the JAX package derives
    them from per-step keys).  At batch 6000, fan-out 2, 2 hops: 48,000
    integers, 192 KB, a step; 24,000 with paired draws."""
    return tuple(hop_draws(generator, n, f, paired, device, steps=num_batches)
                 for n, f in zip(hop_sizes(batch_size, fanouts), fanouts))


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


def make_device_epoch_fn(cfg: Config) -> Callable:
    """The epoch function of ``train.epoch_dispatch``::

        acc = epoch_fn(state, perm, draws, train_nids, labels, csr,
                       cache_values, dequant_scale=None)

    ``perm`` is a permutation of ``range(n_train)`` and ``draws`` the
    :func:`epoch_draws` of the epoch, both on the device; ``train_nids`` int32
    ``[n_train]``, ``labels`` int32 ``[N]``, ``cache_values`` the full cache
    (cache row = vertex id).  Updates ``state`` in place and returns the
    epoch's :class:`EpochAccumulator` without waiting for the device.  Every
    ``train.epoch_dispatch`` value runs this one loop (module docstring).
    """
    if not cfg.sampler.include_self:
        raise ValueError("on-device sampling requires include_self=True")
    batch_size = cfg.sampler.batch_size

    def epoch_fn(state: TrainState, perm: torch.Tensor, draws: Sequence[torch.Tensor],
                 train_nids: torch.Tensor, labels: torch.Tensor, csr: DeviceCSR,
                 cache_values: torch.Tensor,
                 dequant_scale: Optional[torch.Tensor] = None) -> EpochAccumulator:
        seeds_all, mask_all = epoch_schedule(perm, train_nids, batch_size)
        acc = EpochAccumulator.zeros(train_nids.device)
        for i in range(seeds_all.shape[0]):
            device_batch_step(cfg, state, acc, seeds_all[i], mask_all[i],
                              [d[i] for d in draws], labels, csr, cache_values,
                              dequant_scale)
        return acc

    return epoch_fn
