"""Single-device training loop (the port of the host branch of
``pagraph_tpu/train/loop.py``).

Attach the store, fill the device cache, then per batch: sample, split
hits/misses and gather the miss rows on the host (the loader's producer
threads), and run one train step on the device.  The measurement follows the
reference: epoch times excluding warm-up epochs, per-epoch cache miss rate,
and valid sampled edges per epoch.

A step is one call of :func:`train_step`.  ``train.steps_per_dispatch`` is
ignored: the JAX package groups K steps into one compiled dispatch to
amortize its per-dispatch host-link latency, while PyTorch enqueues kernels
asynchronously step by step and the loop never waits for the device inside
an epoch (loss and accuracy accumulate on the device and are read once at
the end).

Not ported yet, and refused with ``NotImplementedError``: on-device sampling,
remote (isolation-mode) sampling, evaluation and checkpoints during
training.
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
from ..sampling.loader import PrefetchLoader
from ..sampling.sampler import NeighborSampler
from ..storage.cache import FeatureCache
from ..storage.feature_store import FeatureStore
from ..utils.timers import PhaseTimers
from .state import create_state, train_step


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


def resolve_device(device) -> torch.device:
    """``None`` means the GPU; without one that is an error, not the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pagraph_tpu_torch trains on a GPU; pass "
                "device='cpu' explicitly to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


class Trainer:
    """One-device trainer over a (partition of a) dataset."""

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
        for flag, what in ((t.on_device_sampling, "train.on_device_sampling"),
                           (t.remote_sampling, "train.remote_sampling"),
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
        self.timers = PhaseTimers()
        self._cache_filled = False
        self.epoch_metrics: List[EpochMetrics] = []

    @classmethod
    def from_dataset(cls, cfg: Config, ds: Dataset, **kw) -> "Trainer":
        if cfg.model.preprocess:
            raise NotImplementedError(
                "preprocess mode is not ported yet (ROADMAP queue 1)")
        store = FeatureStore.build(ds.graph, ds.features)
        return cls(cfg, store, ds.graph, ds.train_nids, ds.labels, **kw)

    def _maybe_fill_cache(self) -> None:
        """Size and fill the cache once, before the first step (capacity 0
        when the cache is disabled; ``None`` sizes it from free memory)."""
        if self._cache_filled:
            return
        c = self.cfg.cache
        self.cache.fill(capacity=c.capacity if c.enabled else 0, rank_by=c.rank_by)
        self._cache_filled = True
        if self.log:
            print(f"[cache] capacity={self.cache.capacity} vertices "
                  f"({'full' if self.cache.fully_cached else 'partial'})")

    def run_epoch(self, epoch: int = 0) -> EpochMetrics:
        self._maybe_fill_cache()
        t_epoch = time.perf_counter()
        self.cache.reset_stats()
        sums = torch.zeros(2, dtype=torch.float32, device=self.device)
        nb = 0
        for mb, miss_feats, miss_slot in self.loader.epoch():
            with self.timers.scope("step"):
                m = train_step(self.state, mb, miss_feats, miss_slot,
                               self.cache.cache_values, self.cache.cache_map_dev)
                sums += torch.stack([m["loss"], m["acc"]])
            nb += 1
            if self.log and nb % self.cfg.train.log_every == 0:
                print(f"  step {nb}")
        tot_loss, tot_acc = sums.tolist()      # the epoch's one device sync
        c = self.cfg.cache
        if (epoch == 0 and c.enabled and c.rank_by == "access_freq"
                and not self.cache.fully_cached):
            # refill by observed access frequency after the probe epoch
            self.cache.fill(capacity=c.capacity, rank_by="access_freq")
        em = EpochMetrics(
            epoch=epoch,
            mean_loss=tot_loss / max(nb, 1),
            mean_acc=tot_acc / max(nb, 1),
            time_s=time.perf_counter() - t_epoch,
            miss_rate=self.cache.miss_rate(),
            num_batches=nb,
            edges=self.loader.epoch_edges,
            vertices=self.loader.epoch_vertices,
            h2d_bytes=self.loader.epoch_h2d_bytes,
        )
        self.epoch_metrics.append(em)
        if self.log:
            print(f"epoch {epoch}: loss={em.mean_loss:.4f} acc={em.mean_acc:.3f} "
                  f"time={em.time_s:.2f}s miss={em.miss_rate:.1%}")
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
