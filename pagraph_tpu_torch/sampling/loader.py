"""Prefetching batch loader: overlap host sampling and the miss-row fetch
with device compute (the port of ``pagraph_tpu/sampling/loader.py``).

Producer threads run [sample -> cache hit/miss split -> host miss gather ->
pack] while the main thread runs the step on an earlier batch.  A batch is
packed into three flat host buffers (``sampling/pack.py``), the JAX
package's packed, host-output mode: the item is ``(layout, i32, u8,
miss)``.  Items carry sequence numbers and the consumer reorders them, so
the epoch order — and the training trajectory — is deterministic.  A
bounded queue gives backpressure.

:meth:`PrefetchLoader.groups` stacks K items into one group
(``pack.stack``), in pinned memory for a CUDA device: the only pinned copy
a batch makes, from which its group crosses in one copy a buffer (the
Trainer's ``steps_per_dispatch``).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Tuple

import torch

from ..storage.cache import FeatureCache
from ..utils.device import resolve_device
from .block import MiniBatch
from .pack import BatchLayout, PackedGroup, make_layout, pack, stack
from .sampler import NeighborSampler

_END = object()

Item = Tuple[BatchLayout, torch.Tensor, torch.Tensor, torch.Tensor]  # layout, i32, u8, miss


class PrefetchLoader:
    """Iterates one epoch's packed host batches ``(layout, i32, u8,
    miss)``, the miss rows in the cache tier's dtype (:meth:`epoch`), or
    groups of them (:meth:`groups`) for ``device``.  ``device=None`` is the
    GPU (``RuntimeError`` without one)."""

    def __init__(self, sampler: NeighborSampler, cache: FeatureCache, *,
                 prefetch: int = 2, device=None, workers: int = 2):
        self.sampler = sampler
        self.cache = cache
        self.prefetch = max(1, prefetch)
        self.device = resolve_device(device)
        self.workers = max(1, workers)
        # per-epoch accounting: valid sampled edges and loaded vertices
        self.epoch_edges = 0
        self.epoch_vertices = 0

    def _produce(self, q: queue.Queue, stop: threading.Event, it,
                 it_lock: threading.Lock, done_counter: list) -> None:
        try:
            while not stop.is_set():
                with it_lock:
                    try:
                        mb = next(it)
                    except StopIteration:
                        break
                    seq = done_counter[1]
                    done_counter[1] += 1
                    self.epoch_edges += mb.num_sampled_edges()
                    self.epoch_vertices += mb.num_loaded_vertices()
                q.put((seq, self._pack(mb)))
            with it_lock:
                done_counter[0] += 1
                if done_counter[0] == self.workers:
                    q.put(_END)
        except BaseException as e:  # surface errors to the consumer
            q.put(e)

    def _pack(self, mb: MiniBatch) -> Item:
        plan = self.cache.fetch_plan(mb.input_nids, mb.input_mask)
        layout = make_layout(self.sampler.caps, self.sampler.config.block_fanouts(),
                             self.cache.total_dim, plan.miss_feats.shape[0])
        return (layout, *pack(mb, plan.src_row, plan.miss_feats, layout))

    def epoch(self) -> Iterator[Item]:
        self.epoch_edges = 0
        self.epoch_vertices = 0
        q: queue.Queue = queue.Queue(maxsize=max(self.prefetch, self.workers))
        stop = threading.Event()
        it = self.sampler.epoch()
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

    def groups(self, k: int) -> Iterator[PackedGroup]:
        """One epoch in groups of ``k`` batches (the last one shorter),
        stacked in pinned memory for a CUDA device: the consumer side of
        the JAX package's grouped transfer."""
        pin = self.device.type == "cuda"
        group = []
        for item in self.epoch():
            group.append(item)
            if len(group) == k:
                yield stack(group, pin_memory=pin)
                group = []
        if group:
            yield stack(group, pin_memory=pin)

    def __iter__(self):
        return self.epoch()
