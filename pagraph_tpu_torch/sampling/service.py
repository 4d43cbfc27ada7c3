"""Isolation-mode sampling service: sampling in worker processes (the port of
``pagraph_tpu/sampling/service.py``).

The reference isolates its sampling in separate server processes and
streams the batches to the trainers over loopback TCP with a 50-batch
barrier window (PaGraph/parallel/dataloader.py ``SampleDeliver``,
``SampleLoader``).  Here ``spawn`` worker processes run the native sampler
(``sampling/native.py``) over a graph held in shared memory and write each
batch into a shared-memory slot (``pack.SlotLayout``); a bounded set of
slots gives the backpressure the barrier gave.  The workers import only
host modules, not torch (so they never initialise CUDA and start in about
a second), and share the cores: each samples on its share of the OpenMP
threads.

Dispatch (the reference's ``one2one_sample`` / ``one2all_sample``):

* one2one (``num_consumers=1``): the service's workers serve its one
  consumer, :meth:`SampleService.epoch`;
* one2all (``num_consumers=N``, ``consumer=r``): the train set is split
  round-robin over ``N`` consumers, each consumer short of the largest
  count topped up with make-up chunks (:meth:`SampleService._epoch_chunks`).
  A service serves one consumer ``r``: a data-parallel rank's own pool (one
  process a rank), whose :meth:`SampleService.epoch` gives the batches the
  JAX package's shared pool gives in ``epoch_for(r)`` from the same seeds.

A batch's chunk and its 31-bit sampling seed are fixed by the epoch's
seeds alone, so the batches do not depend on which worker samples them;
their order is the workers' completion order (fixed with one worker).

The JAX package's generator yields views into a slot and hands the slot
back to the workers when it is resumed, so a consumer that still holds the
batch (the loader's second producer thread, or any caller that keeps a
batch) can see a later batch's rows written over it.  Here a batch owns
its memory: the slot is copied (one copy of its int32 and uint8 rows)
before it is handed back.  A generator closed before its epoch's end waits
for the batches still in flight, so that its slots are free for the next
epoch.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue as queue_mod
from multiprocessing import shared_memory
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..config import SamplerConfig
from ..graph import CSRGraph
from .block import MiniBatch
from .pack import SlotLayout, make_slot_layout, pack_slot, unpack_numpy

_STOP = None
POLL_S = 5.0            # the wait between two checks that a worker is alive


def _share(arr: np.ndarray, registry: list) -> Tuple[str, tuple, str]:
    shm = shared_memory.SharedMemory(create=True, size=max(arr.nbytes, 1))
    np.ndarray(arr.shape, dtype=arr.dtype, buffer=shm.buf)[...] = arr
    registry.append(shm)
    return shm.name, arr.shape, str(arr.dtype)


def _attach(spec, registry: list) -> np.ndarray:
    name, shape, dtype = spec
    shm = shared_memory.SharedMemory(name=name)
    registry.append(shm)
    return np.ndarray(shape, dtype=np.dtype(dtype), buffer=shm.buf)


def _worker_threads(num_workers: int) -> int:
    """The OpenMP threads a worker samples with: the process's cores (or
    ``OMP_NUM_THREADS``) shared among the workers.  Each worker's sampler
    at every core slows all of them several times over."""
    total = int(os.environ.get("OMP_NUM_THREADS") or len(os.sched_getaffinity(0)))
    return max(1, total // num_workers)


def _worker_main(graph_spec: dict, config: SamplerConfig, caps: Tuple[int, ...],
                 slot_spec: dict, task_q, done_q, threads: int) -> None:
    """A worker: a task ``(slot, seeds, batch_seed)`` is sampled into the
    slot, then ``(slot, len(seeds))`` goes to ``done_q``; ``None`` ends the
    loop.  ``threads``: its OpenMP threads, set
    before the host library (and its OpenMP runtime) loads."""
    os.environ["OMP_NUM_THREADS"] = str(threads)
    from .native import NativeSampler

    registry: list = []
    try:
        indptr = _attach(graph_spec["indptr"], registry)
        graph = CSRGraph(indptr=indptr, indices=_attach(graph_spec["indices"], registry),
                         out_degrees=np.zeros(len(indptr) - 1, dtype=np.int32))
        labels = (_attach(graph_spec["labels"], registry)
                  if graph_spec["labels"] is not None else None)
        sampler = NativeSampler(graph, config, caps)
        i32_slots = _attach(slot_spec["i32"], registry)
        u8_slots = _attach(slot_spec["u8"], registry)
        layout = make_slot_layout(caps, config.block_fanouts())
        while True:
            task = task_q.get()
            if task is _STOP:
                break
            slot, seeds, batch_seed = task
            pack_slot(sampler.sample(seeds, labels, batch_seed), layout, i32_slots[slot],
                      u8_slots[slot])
            done_q.put((slot, len(seeds)))
    finally:
        for shm in registry:
            shm.close()


class SampleService:
    """Sampling workers feeding one consumer through ``num_slots``
    shared-memory slots: the only one (one2one), or ``consumer`` of
    ``num_consumers`` (one2all's round robin).  ``caps``: the layer
    capacities (default the config's for the graph).  :meth:`close` ends
    the workers and frees the shared memory."""

    def __init__(self, graph: CSRGraph, train_nids: np.ndarray, config: SamplerConfig, *,
                 labels: Optional[np.ndarray] = None, num_workers: int = 2,
                 num_slots: int = 8, caps: Optional[Sequence[int]] = None, seed: int = 0,
                 num_consumers: int = 1, consumer: int = 0):
        if not 0 <= consumer < num_consumers:
            raise ValueError(f"consumer {consumer} of {num_consumers}")
        self.num_consumers = num_consumers
        self.consumer = consumer
        self.config = config
        self.train_nids = np.asarray(train_nids, dtype=np.int64)
        self.caps = (tuple(int(c) for c in caps) if caps is not None
                     else config.layer_capacities(graph.num_nodes))
        self.layout: SlotLayout = make_slot_layout(self.caps, config.block_fanouts())
        self.num_slots = num_slots
        self._base_seed = seed
        self._epoch_idx = 0
        self._registry: list = []
        self.workers: list = []
        graph_spec = {
            "indptr": _share(graph.indptr, self._registry),
            "indices": _share(graph.indices, self._registry),
            "labels": (_share(np.asarray(labels, dtype=np.int32), self._registry)
                       if labels is not None else None)}
        self.i32_slots, i32_spec = self._slot_table((num_slots, self.layout.i32_size), np.int32)
        self.u8_slots, u8_spec = self._slot_table((num_slots, self.layout.u8_size), np.uint8)
        slot_spec = {"i32": i32_spec, "u8": u8_spec}
        ctx = mp.get_context("spawn")       # a worker must not inherit CUDA state
        self._task_q = ctx.Queue()
        self._done_q = ctx.Queue()
        self.workers = [ctx.Process(target=_worker_main,
                                    args=(graph_spec, config, self.caps, slot_spec,
                                          self._task_q, self._done_q,
                                          _worker_threads(num_workers)), daemon=True)
                        for _ in range(num_workers)]
        for w in self.workers:
            w.start()

    def _slot_table(self, shape, dtype) -> Tuple[np.ndarray, tuple]:
        """A new shared table of ``shape``: the array and its spec."""
        size = max(int(np.prod(shape)) * np.dtype(dtype).itemsize, 1)
        shm = shared_memory.SharedMemory(create=True, size=size)
        self._registry.append(shm)
        return (np.ndarray(shape, dtype=dtype, buffer=shm.buf),
                (shm.name, shape, np.dtype(dtype).name))

    @property
    def num_batches(self) -> int:
        """Batches an epoch gives each consumer: one2all tops every consumer
        up to the largest share (the reference's make-up sends)."""
        total = -(-len(self.train_nids) // self.config.batch_size)
        return total if self.num_consumers == 1 else -(-total // self.num_consumers)

    def _epoch_chunks(self) -> List[np.ndarray]:
        """The consumer's seed chunks of its next epoch: every consumer
        shuffles the train set with the epoch's seed, so their round-robin
        shares are disjoint; a consumer short of :attr:`num_batches` takes
        make-up chunks from the front."""
        ep = self._epoch_idx
        self._epoch_idx += 1
        rng = np.random.default_rng(np.random.SeedSequence((self._base_seed, ep)))
        nids = self.train_nids[rng.permutation(len(self.train_nids))]
        b = self.config.batch_size
        chunks = [nids[i:i + b] for i in range(0, len(nids), b)]
        if self.num_consumers == 1:
            return chunks
        mine = chunks[self.consumer::self.num_consumers]
        i = 0
        while len(mine) < self.num_batches:
            mine.append(chunks[i % len(chunks)])
            i += 1
        return mine

    def epoch(self) -> Iterator[MiniBatch]:
        """The consumer's next epoch: its batches, each owning its memory,
        in the order the workers finish them."""
        rng = np.random.default_rng(
            np.random.SeedSequence((self._base_seed, self.consumer, self._epoch_idx, 7)))
        chunks = self._epoch_chunks()
        free = list(range(self.num_slots))
        done_q = self._done_q
        submitted = received = 0

        def submit(slot: int) -> None:
            nonlocal submitted
            self._task_q.put((slot, chunks[submitted], int(rng.integers(0, 2**31 - 1))))
            submitted += 1

        try:
            while free and submitted < len(chunks):
                submit(free.pop())
            while received < len(chunks):
                slot = self._wait(done_q)
                received += 1
                mb = unpack_numpy(self.layout, self.i32_slots[slot].copy(),
                                  self.u8_slots[slot].copy())
                if submitted < len(chunks):       # the slot is free once copied
                    submit(slot)
                yield mb
        finally:
            # closed early: wait for the batches in flight, so that no worker
            # writes a slot the next epoch hands out
            while received < submitted and any(w.is_alive() for w in self.workers):
                try:
                    done_q.get(timeout=POLL_S)
                    received += 1
                except queue_mod.Empty:
                    pass

    def _wait(self, done_q) -> int:
        """The next finished slot; ``RuntimeError`` once every worker is
        dead (the reference waits forever)."""
        while True:
            try:
                return done_q.get(timeout=POLL_S)[0]
            except queue_mod.Empty:
                if not any(w.is_alive() for w in self.workers):
                    raise RuntimeError("all sampling workers died; check worker stderr")

    def close(self) -> None:
        """End the workers (terminated if they do not stop) and unlink the
        shared memory; idempotent."""
        for w in self.workers:
            if w.is_alive():
                self._task_q.put(_STOP)
        for w in self.workers:
            w.join(timeout=5)
            if w.is_alive():
                w.terminate()
                w.join(timeout=5)
        self.workers = []
        self.i32_slots = self.u8_slots = None       # the views into the slot tables
        for shm in self._registry:
            try:
                shm.close()
                shm.unlink()
            except FileNotFoundError:
                pass
        self._registry = []

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
