"""Prefetching batch loader: overlap host sampling and the miss-row fetch
with device compute (the port of ``pagraph_tpu/sampling/loader.py``).

Producer threads run [sample -> cache hit/miss split -> host miss gather ->
copy to the device] while the main thread runs the step on an earlier batch.
Host arrays go through pinned buffers with ``non_blocking=True`` copies on
the producer's current stream (the default stream, so the step that uses
them is ordered after the copy).  Items carry sequence numbers and the
consumer reorders them, so the epoch order — and the training trajectory —
is deterministic.  A bounded queue gives backpressure.

The JAX package packs each batch into three flat buffers
(``sampling/pack.py``) to cut per-array round trips on its TPU host link;
that format is not ported.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Tuple

import numpy as np
import torch

from ..storage.cache import FeatureCache
from ..utils.device import resolve_device
from .block import MiniBatch, _ship
from .sampler import NeighborSampler

_END = object()

Item = Tuple[MiniBatch, torch.Tensor, torch.Tensor]   # (mb, miss_feats, src_row)


class PrefetchLoader:
    """Iterates ``(device MiniBatch, miss_feats, src_row)`` for one epoch,
    the miss rows in the cache tier's dtype.  ``device=None`` is the GPU
    (``RuntimeError`` without one)."""

    def __init__(self, sampler: NeighborSampler, cache: FeatureCache, *,
                 prefetch: int = 2, device=None, workers: int = 2):
        self.sampler = sampler
        self.cache = cache
        self.prefetch = max(1, prefetch)
        self.device = resolve_device(device)
        self.workers = max(1, workers)
        # per-epoch accounting: valid sampled edges, loaded vertices, and the
        # bytes shipped host -> device (miss rows at the tier's width)
        self.epoch_edges = 0
        self.epoch_vertices = 0
        self.epoch_h2d_bytes = 0

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
                plan = self.cache.fetch_plan(mb.input_nids, mb.input_mask)
                nbytes = (plan.miss_feats.nbytes + plan.src_row.nbytes
                          + sum(np.asarray(a).nbytes for a in _arrays(mb)))
                item = (mb.to(self.device, non_blocking=True),
                        _ship(plan.miss_feats, self.device, True),
                        _ship(plan.src_row, self.device, True))
                with it_lock:
                    self.epoch_h2d_bytes += nbytes
                q.put((seq, item))
            with it_lock:
                done_counter[0] += 1
                if done_counter[0] == self.workers:
                    q.put(_END)
        except BaseException as e:  # surface errors to the consumer
            q.put(e)

    def epoch(self) -> Iterator[Item]:
        self.epoch_edges = 0
        self.epoch_vertices = 0
        self.epoch_h2d_bytes = 0
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

    def __iter__(self):
        return self.epoch()


def _arrays(mb: MiniBatch):
    yield from mb.layer_nids
    yield from mb.layer_mask
    yield mb.labels
    for b in mb.blocks:
        yield from (b.neigh_pos, b.neigh_mask, b.self_pos)
