"""Single-device training loop (the port of ``pagraph_tpu/train/loop.py``).

Host path: attach the store, fill the device cache, then per batch: sample,
split hits/misses and gather the miss rows on the host (the loader's
producer threads), and run one train step on the device.  The measurement
follows the reference: epoch times excluding warm-up epochs, per-epoch cache
miss rate, and valid sampled edges per epoch.

On-device path (``train.on_device_sampling=True``): the CSR and the full
feature cache live in device memory, and the whole epoch (permutation,
sampling, layer-0 fetch, forward, backward, Adam) runs on the device with
one host sync an epoch, to read the metrics (``train/device_epoch.py``).
There is no sampler or loader.  Each epoch's random integers come from a
generator on the device seeded from ``(seed, epoch)``, so an epoch can be
replayed alone; they are drawn into static buffers (``EpochInputs``)
allocated once.  Its edges and vertices count every valid slot of the
undeduplicated layers, as the JAX package's device path does; the host path
counts deduplicated ones, so the two compare by epoch time.

The on-device epoch runs ``train.epoch_dispatch``'s function
(``DeviceEpochRunner``).  The first epoch a Trainer runs is the eager form
(on the card on a side stream: it creates Adam's state, builds the kernels
and warms the libraries, as the JAX package's first epoch compiles).  On
the card every later epoch replays CUDA graphs, captured once before the
second epoch on that side stream and timed under the ``"capture"`` phase
timer, outside the epoch's ``time_s``; a capture or replay error raises.
The CPU runs the eager form throughout.

Host path, at the JAX package's defaults: the sampler's ``backend``
(``"auto"``: the native one, ``sampler.backend_name`` says which ran), the
loader's producers pack each batch into three buffers
(``sampling/pack.py``), and the loop groups ``K = max(1,
train.steps_per_dispatch)`` batches, stacks them into pinned host buffers
(``PrefetchLoader.groups``: their miss rows padded to the group's largest
bucket, the one pinned copy a batch makes) and dispatches K
steps at once (``make_multistep_train_step``), the last group holding the
remainder.  The first epoch a Trainer runs, and every epoch on the CPU, is
the eager form (on the card on a side stream: it creates Adam's state and
builds the kernels); on the card later epochs replay CUDA graphs, one a
``(k, layout)`` key (``GroupGraphs``), each captured at its key's first
group under the ``"capture"`` phase timer, which the epoch's ``time_s``
leaves out.  A capture or replay error raises.  The loop never waits for
the device inside an epoch (loss and accuracy accumulate on the device and
are read once at the end).  ``host_graphs`` picks the form from the
second epoch on: True on the card, False for the eager form throughout.

``train.dtype="bfloat16"`` runs both paths at bf16 compute
(``state.cast_apply``) at every cache tier.  ``Trainer(cfg, store, ...)``
takes a pre-quantized store (``storage.feature_store.quantize_store`` or
``build_prequantized``) as well as an f32 one; the int8 cache then holds
and ships the store's own rows, on the on-device path too.

Not ported yet, and refused with ``NotImplementedError``: remote
(isolation-mode) sampling, evaluation and checkpoints during training, and
every architecture but GraphSAGE (``models.get_model``), CV-GCN included.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import Config
from ..data.formats import Dataset
from ..graph import CSRGraph
from ..sampling.device_sampler import DeviceCSR
from ..sampling.loader import PrefetchLoader
from ..sampling.sampler import NeighborSampler
from ..storage.cache import FeatureCache
from ..storage.feature_store import FeatureStore
from ..utils.device import resolve_device
from ..utils.timers import PhaseTimers
from .device_epoch import (DeviceData, DeviceEpochRunner, EpochInputs, epoch_draws,
                           epoch_seed, num_batches)
from .state import GroupGraphs, create_state, make_multistep_train_step


@dataclasses.dataclass
class EpochMetrics:
    epoch: int
    mean_loss: float
    mean_acc: float
    time_s: float
    miss_rate: float
    num_batches: int
    edges: int = 0          # valid sampled edges aggregated this epoch
    vertices: int = 0       # valid vertices loaded this epoch
    val_acc: Optional[float] = None
    h2d_bytes: int = 0      # batch bytes shipped host -> device this epoch


class Trainer:
    """One-device trainer over a (partition of a) dataset.  ``store`` holds
    the ``features`` field, f32 or pre-quantized int8 (with its scale)."""

    def __init__(
        self,
        cfg: Config,
        store: FeatureStore,
        local_graph: CSRGraph,
        train_nids: np.ndarray,          # LOCAL ids
        labels: np.ndarray,              # LOCAL space labels
        local2full: Optional[np.ndarray] = None,
        *,
        device=None,
        seed: int = 0,
        log: bool = False,
    ):
        t = cfg.train
        for flag, what in ((t.remote_sampling, "train.remote_sampling"),
                           (t.eval_every, "train.eval_every"),
                           (t.ckpt_dir and t.ckpt_every, "checkpointing")):
            if flag:
                raise NotImplementedError(
                    f"{what} is not ported yet (ROADMAP queue 1)")
        if t.halo_pipeline:
            raise ValueError(
                "train.halo_pipeline is a multi-device edge-mode knob; the "
                "single-device trainer has no halo exchange to pipeline")
        self.cfg = cfg
        self.store = store
        self.device = resolve_device(device)
        self.log = log
        self.cache = FeatureCache(store, ["features"], local_graph, local2full,
                                  device=self.device, dtype=cfg.cache.dtype)
        self.timers = PhaseTimers()
        self._cache_filled = False
        self.epoch_metrics: List[EpochMetrics] = []
        self._device_mode = t.on_device_sampling
        self._side_stream = (torch.cuda.Stream(device=self.device)
                             if self.device.type == "cuda" else None)
        if self._device_mode:
            # no sampler or loader: the CSR, the train vertices and the labels
            # live on the device beside the full cache (filled before epoch 0)
            self.sampler = self.loader = None
            self._seed = seed
            self._dev_csr = DeviceCSR.from_graph(local_graph, self.device)
            self._dev_train_nids = torch.from_numpy(
                np.asarray(train_nids, dtype=np.int32)).to(self.device, copy=True)
            self._dev_labels = torch.from_numpy(
                np.asarray(labels, dtype=np.int32)).to(self.device, copy=True)
            self.state = create_state(cfg, seed=seed, device=self.device)
            self.epoch_inputs = EpochInputs.allocate(cfg, len(train_nids), self.device)
            # the eager form for the first epoch, then (on the card) the graphs
            self.epoch_runner: Optional[DeviceEpochRunner] = None
            self._device_epochs = 0             # epochs enqueued
            return
        if cfg.cache.rank_by == "access_freq":
            self.cache.track_access = True
        self.sampler = NeighborSampler(local_graph, train_nids, cfg.sampler,
                                       labels=labels, seed=seed)
        if cfg.sampler.auto_caps:
            self.sampler.calibrate_caps()
        self.loader = PrefetchLoader(self.sampler, self.cache,
                                     prefetch=cfg.sampler.prefetch,
                                     device=self.device)
        self.state = create_state(cfg, seed=seed, device=self.device)
        self.steps_per_dispatch = max(1, t.steps_per_dispatch)
        self.host_graphs = self.device.type == "cuda"
        self.group_graphs: Optional[GroupGraphs] = None    # made at the second epoch
        self._acc = torch.zeros(2, dtype=torch.float32, device=self.device)   # loss, acc
        self._host_epochs = 0                               # epochs run

    @classmethod
    def from_dataset(cls, cfg: Config, ds: Dataset, **kw) -> "Trainer":
        if cfg.model.preprocess:
            raise NotImplementedError(
                "preprocess mode is not ported yet (ROADMAP queue 1)")
        store = FeatureStore.build(ds.graph, ds.features)
        return cls(cfg, store, ds.graph, ds.train_nids, ds.labels, **kw)

    def _maybe_fill_cache(self) -> None:
        """Size and fill the cache once, before the first step (capacity 0
        when the cache is disabled; ``None`` sizes it from free memory, or
        on the device path means every vertex, which that path needs:
        anything less raises ``ValueError``)."""
        if self._cache_filled:
            return
        c = self.cfg.cache
        cap = c.capacity if c.enabled else 0
        if self._device_mode and cap is None:
            cap = self.cache.graph.num_nodes
        self.cache.fill(capacity=cap, rank_by=c.rank_by)
        if self._device_mode and not self.cache.fully_cached:
            raise ValueError(
                f"on_device_sampling needs the full feature set in device memory: "
                f"capacity {self.cache.capacity} < {self.cache.graph.num_nodes} "
                "vertices. Use cache.dtype='bfloat16' (or 'int8'), or the host path.")
        self._cache_filled = True
        if self.log:
            print(f"[cache] capacity={self.cache.capacity} vertices "
                  f"({'full' if self.cache.fully_cached else 'partial'})")

    def run_epoch(self, epoch: int = 0) -> EpochMetrics:
        if self._device_mode:
            return self._run_epoch_on_device(epoch)
        self._maybe_fill_cache()
        t_epoch = time.perf_counter()
        capture_s = self.timers.total["capture"]
        self.cache.reset_stats()
        graphs = self._ready_group_graphs()
        eager = side = None
        if graphs is None:          # on the card on the side stream (None on the CPU)
            eager = make_multistep_train_step(self.state, self.cache.cache_values,
                                              self.cache.dequant_scale_dev)
            side = self._side_stream
        self._acc.zero_()
        if side:
            side.wait_stream(torch.cuda.current_stream(self.device))
        nb = h2d = 0
        for group in self.loader.groups(self.steps_per_dispatch):
            h2d += group.nbytes
            if graphs is not None and graphs.needs_capture(group):
                with self.timers.scope("capture"):
                    graphs.capture(group, self._acc)
            with self.timers.scope("step"):
                if graphs is not None:
                    graphs(group, self._acc)
                else:
                    with torch.cuda.stream(side):
                        eager(group, self._acc)
            nb += group.k
            if self.log and nb % self.cfg.train.log_every < group.k:
                print(f"  step {nb}")
        if side:
            torch.cuda.current_stream(self.device).wait_stream(side)
        tot_loss, tot_acc = self._acc.tolist()      # the epoch's one device sync
        self._host_epochs += 1
        c = self.cfg.cache
        if (epoch == 0 and c.enabled and c.rank_by == "access_freq"
                and not self.cache.fully_cached):
            # refill by observed access frequency after the probe epoch.  The
            # loader's threads have been joined: every plan of this epoch
            # indexed the old fill, and the next epoch's index the new one
            # (graphs, captured from the next epoch on, read the new rows)
            self.cache.fill(capacity=c.capacity, rank_by="access_freq")
        em = EpochMetrics(
            epoch=epoch,
            mean_loss=tot_loss / max(nb, 1),
            mean_acc=tot_acc / max(nb, 1),
            time_s=time.perf_counter() - t_epoch - (self.timers.total["capture"] - capture_s),
            miss_rate=self.cache.miss_rate(),
            num_batches=nb,
            edges=self.loader.epoch_edges,
            vertices=self.loader.epoch_vertices,
            h2d_bytes=h2d,
        )
        self.epoch_metrics.append(em)
        if self.log:
            print(f"epoch {epoch}: loss={em.mean_loss:.4f} acc={em.mean_acc:.3f} "
                  f"time={em.time_s:.2f}s miss={em.miss_rate:.1%}")
        return em

    def _ready_group_graphs(self) -> Optional[GroupGraphs]:
        """The host-step graphs from the second epoch on (``host_graphs``),
        made at the first call after the first epoch, after any refill of
        the cache, whose rows they read at the address they had then; else
        ``None``, the eager form."""
        if not self.host_graphs or not self._host_epochs:
            return None
        if self.group_graphs is None:
            self.group_graphs = make_multistep_train_step(
                self.state, self.cache.cache_values, self.cache.dequant_scale_dev,
                graph=True, stream=self._side_stream)
        elif self.group_graphs.cache_values is not self.cache.cache_values:
            raise RuntimeError("the cache was refilled after the host-step graphs "
                               "were captured: they read the old rows")
        return self.group_graphs

    def epoch_randomness(self, epoch: int, out: Optional[EpochInputs] = None):
        """``(perm, draws)`` of an epoch, drawn on the device from a
        generator seeded by ``(seed, epoch)``: the permutation of the train
        vertices and every step's random integers (``epoch_draws``), into
        ``out``'s buffers when given, else fresh tensors."""
        gen = torch.Generator(device=self.device).manual_seed(epoch_seed(self._seed, epoch))
        s = self.cfg.sampler
        n_train = self._dev_train_nids.shape[0]
        if out is None:
            perm = torch.randperm(n_train, generator=gen, device=self.device)
        else:
            perm = torch.randperm(n_train, generator=gen, out=out.perm)
        draws = epoch_draws(gen, num_batches(n_train, s.batch_size), s.batch_size,
                            s.hop_fanouts(), s.paired_draws, self.device,
                            out=None if out is None else out.draws)
        return perm, draws

    def device_data(self) -> DeviceData:
        """What the on-device epoch reads (the cache filled first)."""
        self._maybe_fill_cache()
        return DeviceData(self._dev_train_nids, self._dev_labels, self._dev_csr,
                          self.cache.cache_values, self.cache.dequant_scale_dev)

    def _ready_device_runner(self) -> None:
        """The eager form before the first epoch; on the card, the graphs
        captured before the second (timed as ``"capture"``)."""
        if self.epoch_runner is None:
            self.epoch_runner = DeviceEpochRunner(self.cfg, self.state, self.epoch_inputs,
                                                  self.device_data())
        elif self._side_stream is not None and not self.epoch_runner.graph \
                and self._device_epochs:
            with self.timers.scope("capture"):
                self.epoch_runner = DeviceEpochRunner(
                    self.cfg, self.state, self.epoch_inputs, self.device_data(),
                    graph=True, stream=self._side_stream)
                torch.cuda.synchronize(self.device)

    def enqueue_device_epoch(self, epoch: int):
        """Load the epoch's randomness and enqueue the epoch; its
        ``EpochAccumulator``, without waiting for the device.  On the card
        the eager form runs on the side stream (PyTorch's warm-up before a
        capture), after the randomness and before what follows."""
        self._ready_device_runner()
        self.epoch_inputs.load(*self.epoch_randomness(epoch, out=self.epoch_inputs))
        self._device_epochs += 1
        if self._side_stream is None or self.epoch_runner.graph:
            return self.epoch_runner()
        main = torch.cuda.current_stream(self.device)
        self._side_stream.wait_stream(main)
        with torch.cuda.stream(self._side_stream):
            acc = self.epoch_runner()
        main.wait_stream(self._side_stream)
        return acc

    def _run_epoch_on_device(self, epoch: int) -> EpochMetrics:
        """Enqueue the epoch, then read its metrics: the epoch's one sync."""
        self._ready_device_runner()
        t_epoch = time.perf_counter()
        with self.timers.scope("enqueue"):          # the whole epoch's
            acc = self.enqueue_device_epoch(epoch)
        vals = acc.values()
        steps = max(int(vals["steps"]), 1)
        em = EpochMetrics(
            epoch=epoch,
            mean_loss=vals["loss_sum"] / steps,
            mean_acc=vals["acc_sum"] / steps,
            time_s=time.perf_counter() - t_epoch,
            miss_rate=0.0,                  # fully cached by construction
            num_batches=int(vals["steps"]),
            edges=int(vals["edges"]),
            vertices=int(vals["vertices"]),
            h2d_bytes=0,                    # nothing crosses the host link
        )
        self.epoch_metrics.append(em)
        if self.log:
            print(f"epoch {epoch}: loss={em.mean_loss:.4f} acc={em.mean_acc:.3f} "
                  f"time={em.time_s:.2f}s [on-device]")
        return em

    def train(self, epochs: Optional[int] = None, *, start_epoch: int = 0) -> Dict:
        epochs = epochs or self.cfg.train.epochs
        for e in range(start_epoch, epochs):
            self.run_epoch(e)
        return self.summary()

    def summary(self) -> Dict:
        """Mean epoch time excluding warm-up epochs."""
        w = self.cfg.train.warmup_epochs
        steady = self.epoch_metrics[w:] or self.epoch_metrics
        last = self.epoch_metrics[-1] if self.epoch_metrics else None
        return {
            "epochs": len(self.epoch_metrics),
            "mean_epoch_time_s": float(np.mean([m.time_s for m in steady])),
            "final_loss": last.mean_loss if last else None,
            "final_acc": last.mean_acc if last else None,
            "miss_rate": last.miss_rate if last else None,
            "val_acc": None,
            "phase_timers": self.timers.summary(),
        }
