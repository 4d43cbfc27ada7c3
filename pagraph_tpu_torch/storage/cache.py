"""Device-resident static feature cache with degree ranking (the port of
``pagraph_tpu/storage/cache.py``).

The cache is a read-only device tensor ``[capacity, total_dim]`` plus a
residency map ``cache_map`` (local id -> cache row or -1) kept both on the
host and on the device.  Per batch, the host splits hits from misses and
gathers the miss rows (:meth:`FeatureCache.fetch_plan`, run by the loader's
producer threads); on the device one CUDA launch assembles the layer-0
features from the cache and the shipped miss rows
(:func:`assemble_features_from_map`).  Only the outermost layer is fetched:
deeper layers are reached through ``self_pos`` (sampling/block.py).

Only ``dtype="float32"`` rows are ported; the bf16 and int8 tiers (with the
dequant folded into the assembly kernel) are ROADMAP queue 1.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from ..graph import CSRGraph
from ..ops.gather_kernels import assemble_from_map
from ..utils.device import resolve_device
from .feature_store import FeatureStore


def bucket_size(n: int, cap: int, min_bucket: int = 512) -> int:
    """Round a miss count up to a power-of-two bucket (bounded set of
    shapes, so the device allocator reuses its blocks)."""
    if n <= 0:
        return 0
    b = min_bucket
    while b < n:
        b *= 2
    return min(b, cap)


@dataclasses.dataclass(frozen=True)
class FetchPlan:
    """Host-computed per-batch cache plan (numpy).  Hits need no field:
    the device reads them through its own copy of ``cache_map``."""

    miss_slot: np.ndarray    # int32 [cap0] row in miss_feats (0 unless a valid miss)
    miss_feats: np.ndarray   # f32   [bucket, total_dim] gathered from the store


def assemble_features_from_map(
    cache_values: torch.Tensor,   # f32 [capacity, total_dim]
    cache_map: torch.Tensor,      # int32 [num_local_nodes] row or -1
    nids: torch.Tensor,           # int32 [cap0] layer-0 local ids
    miss_slot: torch.Tensor,      # int32 [cap0] from FetchPlan.miss_slot
    miss_feats: torch.Tensor,     # f32 [bucket, total_dim]
) -> torch.Tensor:
    """Layer-0 features [cap0, total_dim] in one K1 launch.

    ``pagraph_tpu`` recomputes the miss slots on the device with a cumsum;
    here the host plan's ``miss_slot`` is shipped with the miss rows.  The
    two agree on every valid row; padded rows, which no valid
    ``neigh_pos``/``self_pos`` reads, may differ."""
    return assemble_from_map(cache_values, cache_map, nids, miss_slot, miss_feats)


class FeatureCache:
    """Per-device static cache over a partition's LOCAL vertex space."""

    def __init__(
        self,
        store: FeatureStore,
        field_names: Sequence[str],
        local_graph: CSRGraph,
        local2full: Optional[np.ndarray] = None,
        *,
        device=None,                 # None: the GPU (RuntimeError without one)
        dtype: str = "float32",
    ):
        if dtype != "float32":
            raise NotImplementedError(
                f"cache dtype {dtype!r} is not ported yet: the bf16/int8 "
                "tiers are ROADMAP queue 1 (dequant in the K1 assembly kernel)")
        self.store = store
        self.field_names = list(field_names)
        self.graph = local_graph
        self.local2full = (
            np.asarray(local2full, dtype=np.int64)
            if local2full is not None
            else np.arange(local_graph.num_nodes, dtype=np.int64)
        )
        self.device = resolve_device(device)
        self.total_dim = store.total_dim(self.field_names)
        self.field_offsets = store.field_offsets(self.field_names)
        n = local_graph.num_nodes
        self.cache_map = np.full(n, -1, dtype=np.int32)
        self.cache_map_dev: Optional[torch.Tensor] = None
        self.cache_values: Optional[torch.Tensor] = None
        self.capacity = 0
        self.fully_cached = False
        # miss-rate accounting; the lock keeps counters exact under the
        # loader's producer threads
        self.try_num = 0
        self.miss_num = 0
        self._stat_lock = threading.Lock()
        # per-vertex access counts (rank_by='access_freq' refills)
        self.track_access = False
        self.access_counts = np.zeros(n, dtype=np.int64)

    # -- fill ---------------------------------------------------------------

    def rank_vertices(self, rank_by: str = "out_degree") -> np.ndarray:
        if rank_by == "out_degree":
            score = self.graph.out_degrees
        elif rank_by == "in_degree":
            score = self.graph.in_degrees
        elif rank_by == "access_freq":
            # observed access counts (out-degree before any tracked epoch)
            score = (self.access_counts
                     if self.access_counts.any() else self.graph.out_degrees)
        else:
            raise ValueError(f"unknown rank_by {rank_by!r}")
        return np.argsort(-score, kind="stable")

    def auto_capacity(self, reserve_bytes: int = 1 << 30) -> int:
        """Vertices whose rows fit in the device's free memory."""
        if self.device.type != "cuda":
            raise ValueError("capacity=None sizes the cache from free GPU "
                             "memory: give a capacity on a CPU device")
        free, _ = torch.cuda.mem_get_info(self.device)
        return int(max(free - reserve_bytes, 0) // (self.total_dim * 4))

    def fill(self, capacity: Optional[int] = None,
             rank_by: str = "out_degree") -> None:
        """Size and populate the cache: everything if it fits, else the top
        ``capacity`` vertices by ``rank_by``."""
        n = self.graph.num_nodes
        if capacity is None:
            capacity = self.auto_capacity()
        capacity = max(0, min(capacity, n))
        self.capacity = capacity
        self.fully_cached = capacity >= n
        self.cache_map[:] = -1
        if capacity == 0:
            host_rows = np.zeros((1, self.total_dim), dtype=np.float32)
        else:
            if self.fully_cached:
                chosen = np.arange(n, dtype=np.int64)
            else:
                chosen = self.rank_vertices(rank_by)[:capacity].astype(np.int64)
            self.cache_map[chosen] = np.arange(len(chosen), dtype=np.int32)
            host_rows = self.store.gather(self.field_names, self.local2full[chosen])
        # copy=True: on a CPU device the tensors must not alias the host map,
        # which the next fill() rewrites in place
        self.cache_values = torch.from_numpy(host_rows).to(self.device, copy=True)
        self.cache_map_dev = torch.from_numpy(self.cache_map).to(self.device, copy=True)

    # -- per-batch fetch ----------------------------------------------------

    def fetch_plan(self, input_nids: np.ndarray, input_mask: np.ndarray, *,
                   track: bool = True) -> FetchPlan:
        """Host-side hit/miss split + miss gather.  Miss rows are packed in
        first-occurrence order of the valid misses."""
        nids = np.asarray(input_nids)
        mask = np.asarray(input_mask)
        cap0 = len(nids)
        miss = (self.cache_map[nids] < 0) & mask
        n_miss = int(miss.sum())
        if track:
            with self._stat_lock:
                self.try_num += int(mask.sum())
                self.miss_num += n_miss
                if self.track_access:
                    np.add.at(self.access_counts, nids[mask], 1)
        bucket = bucket_size(n_miss, cap0)
        miss_feats = np.zeros((bucket, self.total_dim), dtype=np.float32)
        miss_slot = np.zeros(cap0, dtype=np.int32)
        if n_miss:
            miss_idx = np.nonzero(miss)[0]
            miss_slot[miss_idx] = np.arange(n_miss, dtype=np.int32)
            self.store.gather(self.field_names, self.local2full[nids[miss_idx]],
                              out=miss_feats[:n_miss])
        return FetchPlan(miss_slot=miss_slot, miss_feats=miss_feats)

    # -- metrics ------------------------------------------------------------

    def miss_rate(self) -> float:
        return self.miss_num / self.try_num if self.try_num else 0.0

    def reset_stats(self) -> None:
        self.try_num = 0
        self.miss_num = 0
