"""Prefetching batch loader: overlap host sampling and the miss-row fetch
with device compute (the port of ``pagraph_tpu/sampling/loader.py``).

Producer threads run [sample -> cache hit/miss split -> host miss gather ->
pack] while the main thread runs the step on an earlier batch.  A batch is
packed into three flat host buffers (``sampling/pack.py``), the JAX
package's packed, host-output mode: the item is ``(layout, i32, u8,
miss)``.  With ``packed=False`` (CV-GCN's
loader, the JAX package's unpacked mode) the item is the host batch and its
plan, ``(mb, plan)``, and the consumer ships them.  Items carry sequence
numbers and the consumer reorders them, so
the epoch order — and the training trajectory — is deterministic.  A
bounded queue gives backpressure.

``PrefetchLoader.num_batches`` set (the data-parallel trainer's lockstep
step count), an epoch is that many batches: when the sampler's epoch ends
first, the sampler's next epoch supplies the rest (the JAX package's
make-up batches, ``DataParallelTrainer._next_round``), and the next loader
epoch starts a fresh sampler epoch (:func:`lockstep_batches`).

With ``halo`` (a ``parallel.halo.HaloPlanner``: the data-parallel
trainer's ``ici`` feature source) a producer maps the batch's layer-0 ids
through the cache's ``local2full`` and plans the halo exchange on the host
in place of the cache's fetch plan: the item carries no miss rows, and its
int32 buffer ends in the plan's requests (``pack.halo_req``).  The
requests dropped past the static halo width are counted in
``epoch_halo_drops``.

:meth:`PrefetchLoader.groups` stacks K items into one group
(``pack.stack``), in pinned memory for a CUDA device: the only pinned copy
a batch makes, from which its group crosses in one copy a buffer (the
Trainer's ``steps_per_dispatch``).

Spans (``timers``, the Trainer's ``PhaseTimers``; ``record_function``
ranges of the thread that runs them under ``use_scopes``): a producer's
``load.sample`` (the sampler's next batch, under the iterator's lock),
``load.pack`` (the fetch plan and the packing) and ``load.put`` (its wait
on a full queue), one an item; the consumer's ``load.wait`` (on an empty
queue, one a ``get``) and ``load.stack`` (one a group).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..storage.cache import FeatureCache
from ..utils.device import resolve_device
from ..utils.timers import PhaseTimers
from .block import MiniBatch
from .pack import BatchLayout, PackedGroup, make_layout, pack, stack
from .sampler import NeighborSampler

_END = object()


def lockstep_batches(sampler: NeighborSampler, n: int) -> Iterator[MiniBatch]:
    """``n`` batches of ``sampler``: its epoch, and where that ends first,
    its next epochs (each drawing its permutation when its first batch is
    taken, as the JAX package's wrap-around does).  The sampler's last
    epoch is closed when this one is (a sampling service's waits for its
    batches in flight)."""
    if n > 0 and not sampler.num_batches:
        raise ValueError("a sampler with no train vertices cannot supply lockstep batches")
    it = sampler.epoch()
    try:
        for _ in range(n):
            try:
                mb = next(it)
            except StopIteration:
                it = sampler.epoch()
                mb = next(it)
            yield mb
    finally:
        it.close()

Item = Tuple[BatchLayout, torch.Tensor, torch.Tensor, torch.Tensor]  # layout, i32, u8, miss


class PrefetchLoader:
    """Iterates one epoch's packed host batches ``(layout, i32, u8,
    miss)``, the miss rows in the cache tier's dtype (:meth:`epoch`), or
    groups of them (:meth:`groups`) for ``device``; with ``packed=False``
    the host ``(mb, plan)`` pairs.  ``device=None`` is the GPU
    (``RuntimeError`` without one).  ``num_batches``: the batches an epoch
    (:func:`lockstep_batches`), ``None`` for the sampler's epoch.
    ``halo``: a ``HaloPlanner``, whose plan replaces the cache's.
    ``timers``: where the loader's spans add up (a fresh ``PhaseTimers``
    when ``None``)."""

    def __init__(self, sampler: NeighborSampler, cache: FeatureCache, *,
                 prefetch: int = 2, device=None, workers: int = 2, packed: bool = True,
                 num_batches: Optional[int] = None, halo=None,
                 timers: Optional[PhaseTimers] = None):
        self.sampler = sampler
        self.timers = PhaseTimers() if timers is None else timers
        self.num_batches = num_batches
        self.cache = cache
        self.packed = packed
        self.prefetch = max(1, prefetch)
        self.device = resolve_device(device)
        self.workers = max(1, workers)
        self.halo = halo
        if halo is not None and not packed:
            raise ValueError("the halo exchange's plan travels in the packed layout")
        # per-epoch accounting: valid sampled edges and loaded vertices, and
        # the halo requests dropped
        self.epoch_edges = 0
        self.epoch_vertices = 0
        self.epoch_halo_drops = 0
        self._drops_lock = threading.Lock()

    def _produce(self, q: queue.Queue, stop: threading.Event, it,
                 it_lock: threading.Lock, done_counter: list) -> None:
        try:
            while not stop.is_set():
                with it_lock:
                    try:
                        with self.timers.scope("load.sample"):
                            mb = next(it)
                    except StopIteration:
                        break
                    seq = done_counter[1]
                    done_counter[1] += 1
                    self.epoch_edges += mb.num_sampled_edges()
                    self.epoch_vertices += mb.num_loaded_vertices()
                with self.timers.scope("load.pack"):
                    item = self._pack(mb)
                with self.timers.scope("load.put"):
                    q.put((seq, item))
            with it_lock:
                done_counter[0] += 1
                if done_counter[0] == self.workers:
                    q.put(_END)
        except BaseException as e:  # surface errors to the consumer
            q.put(e)

    def _pack(self, mb: MiniBatch):
        if self.halo is not None:
            return self._pack_halo(mb)
        plan = self.cache.fetch_plan(mb.input_nids, mb.input_mask)
        if not self.packed:
            return mb, plan
        layout = make_layout(self.sampler.caps, self.sampler.config.block_fanouts(),
                             self.cache.total_dim, plan.miss_feats.shape[0])
        return (layout, *pack(mb, plan.src_row, plan.miss_feats, layout))

    def _pack_halo(self, mb: MiniBatch):
        """The batch with its host-planned halo exchange in place of a fetch
        plan: ``src_row`` the exchange's, no miss rows, the requests last."""
        from ..parallel.halo import src_rows

        mask = np.asarray(mb.input_mask)
        plan = self.halo.plan(self.cache.local2full[np.asarray(mb.input_nids)], mask)
        with self._drops_lock:
            self.epoch_halo_drops += int(mask.sum() - plan.valid.sum())
        layout = make_layout(self.sampler.caps, self.sampler.config.block_fanouts(),
                             self.cache.total_dim, 0, halo=plan.req.size)
        miss = torch.empty((0, self.cache.total_dim), dtype=self.cache.row_dtype)
        return (layout, *pack(mb, src_rows(plan), miss, layout, halo_req=plan.req))

    def epoch(self) -> Iterator[Item]:
        self.epoch_edges = 0
        self.epoch_vertices = 0
        self.epoch_halo_drops = 0
        q: queue.Queue = queue.Queue(maxsize=max(self.prefetch, self.workers))
        stop = threading.Event()
        it = (self.sampler.epoch() if self.num_batches is None
              else lockstep_batches(self.sampler, self.num_batches))
        it_lock = threading.Lock()
        done_counter = [0, 0]   # [workers finished, next sequence number]
        threads = [
            threading.Thread(target=self._produce,
                             args=(q, stop, it, it_lock, done_counter),
                             daemon=True)
            for _ in range(self.workers)
        ]
        for t in threads:
            t.start()
        try:
            pending: dict = {}
            expect = 0
            while True:
                with self.timers.scope("load.wait"):
                    item = q.get()
                if item is _END:
                    break
                if isinstance(item, BaseException):
                    raise item
                seq, payload = item
                pending[seq] = payload
                while expect in pending:
                    yield pending.pop(expect)
                    expect += 1
            while expect in pending:    # drain the reorder buffer
                yield pending.pop(expect)
                expect += 1
        finally:
            stop.set()
            while any(t.is_alive() for t in threads):   # unblock producers
                try:
                    q.get(timeout=0.05)
                except queue.Empty:
                    pass
            for t in threads:
                t.join()
            it.close()

    def groups(self, k: int) -> Iterator[PackedGroup]:
        """One epoch in groups of ``k`` batches (the last one shorter),
        stacked in pinned memory for a CUDA device: the consumer side of
        the JAX package's grouped transfer."""
        pin = self.device.type == "cuda"
        group = []
        for item in self.epoch():
            group.append(item)
            if len(group) == k:
                yield self._stack(group, pin)
                group = []
        if group:
            yield self._stack(group, pin)

    def _stack(self, items, pin: bool) -> PackedGroup:
        with self.timers.scope("load.stack"):
            return stack(items, pin_memory=pin)

    def __iter__(self):
        return self.epoch()
