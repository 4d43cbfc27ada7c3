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

Architectures: GraphSAGE, GCN, CV-GCN, GIN and GAT (``models.get_model``),
on both paths.  Preprocess (``model.preprocess=True``, GraphSAGE, GCN and
CV-GCN): the sampler expands one hop less, on both paths, and
``from_dataset`` builds the store's layer-0 aggregate: for GraphSAGE its
``neigh`` field (``FeatureStore.build(preprocess="graphsage")``), which the
cache holds and fetches beside ``features`` (``state.layer0_fields``); for
GCN and CV-GCN in place of ``features`` (``preprocess="gcn"``), as the JAX
package's does.

CV-GCN (``model.arch="gcn_cv"``) carries per-block histories beside the
train state.  On the host path they are a :class:`models.gcn_cv.CVHistory`
on the host, and an epoch runs as the JAX package's does: the loader hands
over one unpacked ``(mb, plan)`` a batch (no packing, no
``steps_per_dispatch``), the step (``state.train_step`` with the batch's
history slices) runs eagerly, on the card too (no CUDA graph: its shapes
change with the miss bucket, and it waits for the device each step to copy
the fresh histories back), and the epoch ends with the exact refresh on
the host (``"cv-refresh"`` timer, inside ``time_s``).  On the device path
they are device tensors (``device_epoch.CVDeviceState``, allocated before
the cache fill) and the epoch, refresh included, is ``scan``'s one function
(``steps`` and ``pipelined`` raise ``ValueError``), a CUDA graph from the
second epoch on.  A checkpoint writes them to its ``.aux`` sidecar and
:meth:`Trainer.resume` restores them (zeros and a ``RuntimeWarning`` for a
checkpoint without one).

:meth:`Trainer.from_partition` builds one PaGraph trainer over a partition
(``partition/``, ``data.formats.PartitionArtifact``): its local graph,
train ids and labels, the cache reading the full store through
``local2full``.

Evaluation and checkpoints, on both paths: every ``train.eval_every``
epochs the full-graph accuracy on ``eval_data`` (``models.inference.
evaluate``, ``train.eval_backend``) goes into the epoch's ``val_acc``;
every ``train.ckpt_every`` epochs the whole train state is saved to
``train.ckpt_dir`` (``train/checkpoint.py``), and :meth:`Trainer.resume`
restores the newest (or a given) checkpoint into the trainer's own tensors,
in place, so CUDA graphs captured before it replay the restored state.
Both read the parameters after the epoch's one sync, which waits for the
stream that ran the epoch.

Tracing (``timers``, a ``PhaseTimers``; with ``use_scopes`` each scope is
a ``torch.profiler`` range, and the steps mark their phases,
``state.trace_marks``): set-up ``setup.cache``, ``setup.csr`` (on-device
path), ``setup.state``, ``cache.fill``; ``train`` around a whole
:meth:`Trainer.train`, and in it an on-device epoch
``marks.switch`` (the marks set to the switch), ``enqueue`` (around
``enqueue.randomness`` and ``enqueue.launch``, which holds ``epoch.eager``
for the eager form), then ``epoch.wait`` (the host blocked on the device)
and ``epoch.metrics`` (the metrics, the evaluation and checkpoint checks,
``summary``); ``capture``; the host path's ``step`` and the loader's
``load.*``.

Isolation-mode sampling (``train.remote_sampling``, the host path): the
batches come from worker processes sampling into shared memory
(``sampling/service.py`` ``SampleService``, the caps probed first by an
in-process ``NeighborSampler`` under ``sampler.auto_caps``); the loader
packs them, and the K-step groups and their CUDA graphs run, as with the
in-process sampler.  Its checkpoints hold no sampler state, as the JAX
package's do not; :meth:`Trainer.close` shuts the workers down.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import Config
from ..data.formats import Dataset, PartitionArtifact
from ..graph import CSRGraph
from ..models.gcn_cv import CVHistory
from ..sampling.device_sampler import DeviceCSR
from ..sampling.loader import PrefetchLoader
from ..sampling.sampler import NeighborSampler
from ..storage.cache import FeatureCache
from ..storage.feature_store import FeatureStore
from ..utils.device import resolve_device
from ..utils.timers import PhaseTimers
from .device_epoch import (CV_DISPATCH_ERROR, CVDeviceState, DeviceData, DeviceEpochRunner,
                           EpochInputs, epoch_draws, epoch_seed)
from .checkpoint import list_checkpoints, restore_aux, restore_checkpoint, save_checkpoint
from .state import (GroupGraphs, create_state, layer0_fields, make_multistep_train_step,
                    train_step)


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
    halo_drops: int = 0     # halo requests dropped (parallel/halo.py; 0 without one)


class Trainer:
    """One-device trainer over a (partition of a) dataset.  ``store`` holds
    the ``features`` field (and under GraphSAGE preprocess ``neigh``), f32
    or pre-quantized int8 (with its scales).  ``eval_data``: ``(graph,
    features, labels, mask)`` in the full graph's id space, which
    ``train.eval_every`` evaluates on."""

    data_parallel = False   # a parallel.DataParallelTrainer rank
    feature_source = "cache"   # where layer 0 comes from (a rank's: also ici, edge)

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
        eval_data: Optional[tuple] = None,
    ):
        t = cfg.train
        if t.eval_every and eval_data is None:
            raise ValueError("cfg.train.eval_every is set but no eval_data was given "
                             "(Trainer.from_dataset wires it)")
        if t.halo_pipeline:
            raise ValueError(
                "train.halo_pipeline is a multi-device edge-mode knob; the "
                "single-device trainer has no halo exchange to pipeline")
        self.cfg = cfg
        self.store = store
        self.device = resolve_device(device)
        self.log = log
        self._eval_data = eval_data
        self.timers = PhaseTimers()
        with self.timers.scope("setup.cache"):
            self.cache = FeatureCache(store, layer0_fields(cfg), local_graph, local2full,
                                      device=self.device, dtype=cfg.cache.dtype,
                                      reserve_bytes=cfg.cache.hbm_reserve_bytes)
        self._cache_filled = False
        self.epoch_metrics: List[EpochMetrics] = []
        self._device_mode = t.on_device_sampling
        self._side_stream = (torch.cuda.Stream(device=self.device)
                             if self.device.type == "cuda" else None)
        self._is_cv = cfg.model.arch == "gcn_cv"
        self.cv_history: Optional[CVHistory] = None
        self.cv_state: Optional[CVDeviceState] = None
        if self._device_mode:
            if self._is_cv and t.epoch_dispatch != "scan":
                raise ValueError(CV_DISPATCH_ERROR.format(t.epoch_dispatch))
            # no sampler or loader: the CSR, the train vertices and the labels
            # live on the device beside the full cache (filled before epoch 0)
            self.sampler = self.loader = None
            self._seed = seed
            with self.timers.scope("setup.csr"):
                self._dev_csr = DeviceCSR.from_graph(local_graph, self.device)
                self._dev_train_nids = torch.from_numpy(
                    np.asarray(train_nids, dtype=np.int32)).to(self.device, copy=True)
                self._dev_labels = torch.from_numpy(
                    np.asarray(labels, dtype=np.int32)).to(self.device, copy=True)
            with self.timers.scope("setup.state"):
                self.state = create_state(cfg, seed=seed, device=self.device)
                self.epoch_inputs = EpochInputs.allocate(cfg, len(train_nids), self.device)
            if self._is_cv:
                # allocated before the cache fill, which they must not lose to
                self.cv_state = CVDeviceState.allocate(cfg, local_graph, self.device)
            # the eager form for the first epoch, then (on the card) the graphs
            self.device_graphs = self._side_stream is not None
            self.epoch_runner: Optional[DeviceEpochRunner] = None
            self._device_epochs = 0             # epochs enqueued
            return
        if cfg.cache.rank_by == "access_freq":
            self.cache.track_access = True
        self.sampler = NeighborSampler(local_graph, train_nids, cfg.sampler,
                                       labels=labels, seed=seed)
        if cfg.sampler.auto_caps:
            self.sampler.calibrate_caps()
        if t.remote_sampling:
            # isolation mode: the in-process sampler only probed the caps
            from ..sampling.service import SampleService

            self.sampler = SampleService(local_graph, train_nids, cfg.sampler, labels=labels,
                                         seed=seed, caps=self.sampler.caps)
        # CV-GCN takes one unpacked batch a step, as the JAX package's does
        self.loader = PrefetchLoader(self.sampler, self.cache,
                                     prefetch=cfg.sampler.prefetch,
                                     device=self.device, packed=not self._is_cv,
                                     timers=self.timers)
        if self._is_cv:
            self.cv_history = CVHistory(cfg.model, local_graph, local_graph.num_nodes)
        with self.timers.scope("setup.state"):
            self.state = create_state(cfg, seed=seed, device=self.device)
        self.steps_per_dispatch = max(1, t.steps_per_dispatch)
        self.host_graphs = self.device.type == "cuda"
        self.group_graphs: Optional[GroupGraphs] = None    # made at the second epoch
        self._acc = torch.zeros(2, dtype=torch.float32, device=self.device)   # loss, acc
        self._host_epochs = 0                               # epochs run

    @classmethod
    def from_dataset(cls, cfg: Config, ds: Dataset, **kw) -> "Trainer":
        m = cfg.model
        # GCN preprocess replaces the features field with the full-graph mean
        # aggregate; GraphSAGE's keeps it and adds that aggregate as neigh
        pre = ("gcn" if m.arch in ("gcn", "gcn_cv") else m.arch) if m.preprocess else None
        store = FeatureStore.build(ds.graph, ds.features, preprocess=pre)
        if cfg.train.eval_every and "eval_data" not in kw:
            kw["eval_data"] = (ds.graph, ds.features, ds.labels, ds.val_mask)
        return cls(cfg, store, ds.graph, ds.train_nids, ds.labels, **kw)

    @classmethod
    def from_partition(cls, cfg: Config, part: PartitionArtifact, store: FeatureStore,
                       **kw) -> "Trainer":
        """One PaGraph trainer over a partition: its local graph, local
        train ids and labels, reading the *full* ``store`` through
        ``part.local2full``."""
        return cls(cfg, store, part.graph, part.train_nids, part.labels, part.local2full,
                   **kw)

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
        with self.timers.scope("cache.fill"):
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
        self._acc.zero_()
        nb, h2d = self._run_cv_steps() if self._is_cv else self._run_group_steps()
        totals = self._host_epoch_totals()          # the epoch's one device sync
        self._host_epochs += 1
        if self._is_cv:
            with self.timers.scope("cv-refresh"):
                self.cv_history.refresh_agg()
        c = self.cfg.cache
        if (epoch == 0 and c.enabled and c.rank_by == "access_freq"
                and self.feature_source == "cache" and not self.cache.fully_cached):
            # refill by observed access frequency after the probe epoch.  The
            # loader's threads have been joined: every plan of this epoch
            # indexed the old fill, and the next epoch's index the new one
            # (graphs, captured from the next epoch on, read the new rows).
            # The refill keeps the first fill's capacity: at capacity=None,
            # sizing again would count the first fill's rows as used
            self.cache.fill(capacity=self.cache.capacity, rank_by="access_freq")
        em = EpochMetrics(
            epoch=epoch,
            mean_loss=totals["loss_sum"] / max(nb, 1),
            mean_acc=totals["acc_sum"] / max(nb, 1),
            time_s=time.perf_counter() - t_epoch - (self.timers.total["capture"] - capture_s),
            miss_rate=totals["miss_rate"],
            num_batches=nb,
            edges=int(totals["edges"]),
            vertices=int(totals["vertices"]),
            h2d_bytes=h2d,
            halo_drops=int(totals.get("halo_drops", 0)),
        )
        self.epoch_metrics.append(em)
        if self.log:
            print(f"epoch {epoch}: loss={em.mean_loss:.4f} acc={em.mean_acc:.3f} "
                  f"time={em.time_s:.2f}s miss={em.miss_rate:.1%}")
        return em

    def _host_epoch_totals(self) -> Dict[str, float]:
        """The host epoch's loss and accuracy sums (read from the device: the
        epoch's one sync), miss rate, edges and vertices."""
        tot_loss, tot_acc = self._acc.tolist()
        return {"loss_sum": tot_loss, "acc_sum": tot_acc, "miss_rate": self.cache.miss_rate(),
                "edges": self.loader.epoch_edges, "vertices": self.loader.epoch_vertices}

    def _run_group_steps(self):
        """The epoch's groups of ``steps_per_dispatch`` batches, eager or
        replayed (:meth:`_ready_group_graphs`): ``(batches, bytes
        shipped)``.  The eager form's closure, which holds the cache rows,
        is gone when this returns, before any refill."""
        graphs = self._ready_group_graphs()
        self.state.trace_marks = self.timers.use_scopes     # each replay applies it
        eager = side = None
        if graphs is None:          # on the card on the side stream (None on the CPU)
            eager = self._group_step(graph=False)
            side = self._side_stream
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
        return nb, h2d

    def _run_cv_steps(self):
        """CV-GCN's epoch on the host path, as the JAX package's: a batch at
        a time, the history slices gathered on the host and shipped with
        the batch, one eager step, the fresh histories copied back and
        scattered (a device sync a step); ``(batches, bytes shipped)``."""
        dev, nb, h2d = self.device, 0, 0
        for mb, plan in self.loader.epoch():
            h_hist, agg_hist = self.cv_history.gather(mb, dev)
            shipped = [mb.to(dev), torch.from_numpy(plan.src_row).to(dev),
                       plan.miss_feats.to(dev)]
            h2d += sum(x.nbytes for x in (*mb.layer_nids, *mb.layer_mask, mb.labels,
                                          plan.src_row, plan.miss_feats, *h_hist, *agg_hist))
            h2d += sum(x.nbytes for b in mb.blocks
                       for x in (b.neigh_pos, b.neigh_mask, b.self_pos))
            with self.timers.scope("step"):
                m = train_step(self.state, shipped[0], shipped[2], shipped[1],
                               self.cache.cache_values, self.cache.dequant_scale_dev,
                               (h_hist, agg_hist))
                self._acc.add_(torch.stack([m["loss"], m["acc"]]))
            self.cv_history.scatter(mb, m["new_hists"])
            nb += 1
            if self.log and nb % self.cfg.train.log_every == 0:
                print(f"  step {nb}")
        return nb, h2d

    def _ready_group_graphs(self) -> Optional[GroupGraphs]:
        """The host-step graphs from the second epoch on (``host_graphs``),
        made at the first call after the first epoch, after any refill of
        the cache, whose rows they read at the address they had then; else
        ``None``, the eager form."""
        if not self.host_graphs or not self._host_epochs:
            return None
        if self.group_graphs is None:
            self.group_graphs = self._group_step(graph=True)
        elif self.group_graphs.cache_values is not self._layer0_table():
            raise RuntimeError("the cache was refilled after the host-step graphs "
                               "were captured: they read the old rows")
        return self.group_graphs

    def _layer0_table(self) -> torch.Tensor:
        """The device table the host steps read layer 0 from: the cache's."""
        return self.cache.cache_values

    def _group_step(self, graph: bool):
        """The host path's K-step dispatch over the cache (its graph form a
        ``GroupGraphs`` captured on the side stream)."""
        return make_multistep_train_step(self.state, self.cache.cache_values,
                                         self.cache.dequant_scale_dev, graph=graph,
                                         stream=self._side_stream if graph else None)

    def epoch_randomness(self, epoch: int, out: Optional[EpochInputs] = None):
        """``(perm, draws)`` of an epoch, drawn on the device from a
        generator seeded by ``(seed, epoch)``: the permutation of the train
        vertices and every step's random integers (``epoch_draws``), into
        ``out``'s buffers when given, else fresh tensors."""
        gen = torch.Generator(device=self.device).manual_seed(self._epoch_seed(epoch))
        perm_gen = self._perm_generator(epoch, gen)
        s = self.cfg.sampler
        n_train = self._dev_train_nids.shape[0]
        if out is None:
            perm = torch.randperm(n_train, generator=perm_gen, device=self.device)
        else:
            perm = torch.randperm(n_train, generator=perm_gen, out=out.perm)
        draws = epoch_draws(gen, self.epoch_inputs.num_batches, s.batch_size,
                            s.hop_fanouts(), s.paired_draws, self.device,
                            out=None if out is None else out.draws)
        return perm, draws

    def _epoch_seed(self, epoch: int) -> int:
        return epoch_seed(self._seed, epoch)

    def _perm_generator(self, epoch: int, gen: torch.Generator) -> torch.Generator:
        """The generator of the epoch's permutation: the epoch's own."""
        return gen

    def device_data(self) -> DeviceData:
        """What the on-device epoch reads (the cache filled first)."""
        self._maybe_fill_cache()
        return DeviceData(self._dev_train_nids, self._dev_labels, self._dev_csr,
                          self.cache.cache_values, self.cache.dequant_scale_dev)

    def _make_device_runner(self, graph: bool) -> DeviceEpochRunner:
        return DeviceEpochRunner(self.cfg, self.state, self.epoch_inputs, self.device_data(),
                                 graph=graph, stream=self._side_stream if graph else None,
                                 cv=self.cv_state, dp=self.data_parallel,
                                 halo=self._halo_epoch())

    def _halo_epoch(self):
        """The halo exchange of a data-parallel rank's device epoch
        (``device_epoch.HaloEpoch``); ``None`` here."""
        return None

    def _ready_device_runner(self) -> None:
        """The eager form before the first epoch; on the card (while
        ``device_graphs``), the graphs captured before the second (timed
        as ``"capture"``).  Then the phase marks follow
        ``timers.use_scopes`` (``state.trace_marks`` and the graphs' marker
        nodes, switched under ``"marks.switch"``, outside ``"enqueue"``)."""
        if self.epoch_runner is None:
            self.epoch_runner = self._make_device_runner(graph=False)
        elif self.device_graphs and not self.epoch_runner.graph and self._device_epochs:
            with self.timers.scope("capture"):
                self.epoch_runner = self._make_device_runner(graph=True)
                torch.cuda.synchronize(self.device)
        with self.timers.scope("marks.switch"):
            self.state.trace_marks = self.timers.use_scopes
            self.epoch_runner.set_marks(self.state.trace_marks)

    def enqueue_device_epoch(self, epoch: int):
        """Load the epoch's randomness and enqueue the epoch; its
        ``EpochAccumulator``, without waiting for the device.  On the card
        the eager form runs on the side stream (PyTorch's warm-up before a
        capture), after the randomness and before what follows."""
        self._ready_device_runner()
        with self.timers.scope("enqueue.randomness"):
            self.epoch_inputs.load(*self.epoch_randomness(epoch, out=self.epoch_inputs))
        self._device_epochs += 1
        with self.timers.scope("enqueue.launch"):
            if self.epoch_runner.graph:
                return self.epoch_runner()
            with self.timers.scope("epoch.eager"):
                return self._eager_device_epoch()

    def _eager_device_epoch(self):
        """The eager form's epoch, on the card on the side stream."""
        if self._side_stream is None:
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
        with self.timers.scope("epoch.wait"):
            vals = acc.values()
        with self.timers.scope("epoch.metrics"):
            return self._device_epoch_metrics(epoch, vals, time.perf_counter() - t_epoch)

    def _device_epoch_metrics(self, epoch: int, vals: Dict[str, float],
                              time_s: float) -> EpochMetrics:
        """An on-device epoch's metrics from its accumulator's values."""
        steps = max(int(vals["steps"]), 1)
        em = EpochMetrics(
            epoch=epoch,
            mean_loss=vals["loss_sum"] / steps,
            mean_acc=vals["acc_sum"] / steps,
            time_s=time_s,
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
        """Epochs ``start_epoch .. epochs - 1`` (``resume``'s return value is
        the ``start_epoch`` of a resumed run), each followed by the
        evaluation and the checkpoint that ``train.eval_every`` and
        ``train.ckpt_every`` ask for.  The call is the ``train`` span: the
        host's passage from one inner span to the next is inside it too."""
        with self.timers.scope("train"):
            epochs = epochs or self.cfg.train.epochs
            tc = self.cfg.train
            for e in range(start_epoch, epochs):
                self.run_epoch(e)
                with self.timers.scope("epoch.metrics"):
                    self._maybe_eval(e)
                    save = bool(tc.ckpt_dir and tc.ckpt_every and (e + 1) % tc.ckpt_every == 0)
                if save:
                    self._checkpoint(e)
            with self.timers.scope("epoch.metrics"):
                return self.summary()

    def _checkpoint(self, epoch: int) -> None:
        """Save the train state after ``epoch``, with the host path's sampler
        random state (a resumed run draws the uninterrupted run's batches)
        and CV-GCN's histories (the ``.aux`` sidecar)."""
        save_checkpoint(self.cfg.train.ckpt_dir, self.cfg.model.arch, epoch, self.state,
                        sampler=self._stateful_sampler(), aux=self._cv_aux())

    def _stateful_sampler(self) -> Optional[NeighborSampler]:
        """The in-process sampler whose random state a checkpoint holds;
        ``None`` on the device path and for the sampling service, whose
        state the JAX package does not save either."""
        return self.sampler if isinstance(self.sampler, NeighborSampler) else None

    def close(self) -> None:
        """Shut down the sampling service's workers, if there are any."""
        close = getattr(self.sampler, "close", None)
        if close is not None:
            close()

    def _maybe_eval(self, epoch: int) -> None:
        """Validation accuracy by full-graph inference every
        ``train.eval_every`` epochs, into the epoch's ``val_acc``."""
        ev = self.cfg.train.eval_every
        if not (ev and self._eval_data) or (epoch + 1) % ev != 0:
            return
        from ..models.inference import evaluate

        graph, feats, labels, mask = self._eval_data
        acc = evaluate(self.state.model, self.cfg.model, graph, feats, labels, mask,
                       backend=self.cfg.train.eval_backend)
        if self.epoch_metrics:
            self.epoch_metrics[-1].val_acc = acc
        if self.log:
            print(f"  [eval] epoch {epoch}: val acc {acc:.3f}")

    def _cv_aux(self) -> Optional[Dict[str, list]]:
        """CV-GCN's histories, ``{"hist": [...], "agg": [...]}`` (numpy
        arrays on the host path, the device tensors' ``[N, w_b]`` views on
        the device path), for the checkpoint's ``.aux`` sidecar; ``None``
        for every other architecture."""
        if self.cv_state is not None:
            return {"hist": self.cv_state.hist_views(), "agg": list(self.cv_state.aggs)}
        if self.cv_history is not None:
            return {"hist": list(self.cv_history.hist), "agg": list(self.cv_history.agg)}
        return None

    def _restore_cv_aux(self, epoch: int) -> None:
        """CV-GCN's histories from the ``.aux`` sidecar of checkpoint
        ``epoch``, on the device path into the history tensors in place.  A
        checkpoint without one resumes with zero histories and warns, as
        the JAX package does."""
        aux = restore_aux(self.cfg.train.ckpt_dir, self.cfg.model.arch, epoch)
        if aux is None:
            self._zero_cv_aux(epoch)
            return
        if self.cv_state is not None:
            with torch.no_grad():
                for dst, src in zip(self.cv_state.hist_views() + list(self.cv_state.aggs),
                                    aux["hist"] + aux["agg"], strict=True):
                    dst.copy_(src)
        else:
            self.cv_history.hist = [t.numpy().copy() for t in aux["hist"]]
            self.cv_history.agg = [t.numpy().copy() for t in aux["agg"]]

    def _zero_cv_aux(self, epoch: int) -> None:
        """Zero the histories of a checkpoint that has none, with the JAX
        package's ``RuntimeWarning``."""
        import warnings
        warnings.warn(
            f"checkpoint {self.cfg.model.arch}_{epoch} has no .aux CV histories "
            "(pre-aux checkpoint?): resuming with ZERO hist/agg; the control-variate "
            "term is wrong until the first post-resume epoch refreshes them",
            RuntimeWarning, stacklevel=4)
        aux = self._cv_aux()
        for t in aux["hist"] + aux["agg"]:
            t[:] = 0

    def resume(self, epoch: Optional[int] = None) -> int:
        """Restore the train state from the newest (or the given) checkpoint
        in ``train.ckpt_dir``, into the trainer's own tensors in place;
        return the epoch to continue from (0 when there is none).  Under
        ``epoch_dispatch="steps"`` the restored step count must be a
        multiple of the epoch's batches, as the JAX package requires.
        CV-GCN restores its histories from the ``.aux`` sidecar too."""
        tc = self.cfg.train
        if not tc.ckpt_dir:
            raise ValueError("cfg.train.ckpt_dir is not set")
        have = list_checkpoints(tc.ckpt_dir, self.cfg.model.arch)
        if not have:
            return 0
        epoch = have[-1] if epoch is None else epoch
        graphs = self.epoch_runner if self._device_mode else self.group_graphs
        restore_checkpoint(tc.ckpt_dir, self.cfg.model.arch, epoch, self.state,
                           sampler=self._stateful_sampler(),
                           in_place_only=bool(graphs is not None and graphs.graphs))
        if self._is_cv:
            self._restore_cv_aux(epoch)
        if self._device_mode and tc.epoch_dispatch == "steps":
            nb = self.epoch_inputs.num_batches
            if self.state.step % nb != 0:
                raise ValueError(
                    f"epoch_dispatch='steps' requires epoch-aligned checkpoints: "
                    f"restored step {self.state.step} is not a multiple of "
                    f"num_batches={nb}")
        return epoch + 1

    def summary(self) -> Dict:
        """Mean epoch time excluding warm-up epochs; ``val_acc`` the last
        evaluation's."""
        w = self.cfg.train.warmup_epochs
        steady = self.epoch_metrics[w:] or self.epoch_metrics
        last = self.epoch_metrics[-1] if self.epoch_metrics else None
        val_accs = [m.val_acc for m in self.epoch_metrics if m.val_acc is not None]
        return {
            "epochs": len(self.epoch_metrics),
            "mean_epoch_time_s": float(np.mean([m.time_s for m in steady])),
            "final_loss": last.mean_loss if last else None,
            "final_acc": last.mean_acc if last else None,
            "miss_rate": last.miss_rate if last else None,
            "val_acc": val_accs[-1] if val_accs else None,
            "phase_timers": self.timers.summary(),
        }
