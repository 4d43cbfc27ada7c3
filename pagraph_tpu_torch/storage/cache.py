"""Device-resident static feature cache with degree ranking (the port of
``pagraph_tpu/storage/cache.py``).

The cache is a read-only device tensor ``[capacity, total_dim]`` plus a
host residency map ``cache_map`` (local id -> cache row or -1).  Per batch,
the host splits hits from misses, gathers the miss rows and writes one index
a row, ``src_row`` (:meth:`FeatureCache.fetch_plan`, run by the loader's
producer threads); on the device one CUDA launch assembles the layer-0
features from the cache and the shipped miss rows
(:func:`assemble_features`).  Only the outermost layer is fetched: deeper
layers are reached through ``self_pos`` (sampling/block.py).

Three row tiers, as in the JAX package: ``float32``; ``bfloat16`` (2-byte
rows, round to nearest even); ``int8`` (1-byte rows with a store-wide
per-column scale, :func:`compute_dequant_scale`).  Cache rows and miss rows
are held and shipped in the tier's dtype; the assembly kernel widens them to
f32 (times the scale for int8), and writes f32 or, at bf16 compute, bf16.
A pre-quantized store (int8 fields with their scales,
``feature_store.quantize_store`` / ``build_prequantized``) feeds the int8
tier with no quantization pass: its scale is the store's own, and the cache
rows and the miss rows are gathered as stored, equal bit for bit to those
quantized from the f32 store.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from ..graph import CSRGraph
from ..ops.gather_kernels import assemble
from ..utils.device import resolve_device
from ..utils.platform import free_hbm_bytes
from .feature_store import FeatureStore

ROW_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}


def compute_dequant_scale(store: FeatureStore, field_names: Sequence[str],
                          chunk: int = 1 << 20) -> np.ndarray:
    """Per-column symmetric int8 scale over the FULL store: ``maxabs/127``
    per fused column (zero-variance columns get scale 1 so they quantize to
    exact 0).  One sequential chunked pass.  The scale is store-wide (not
    cache-subset) so cached rows and miss rows dequantize identically.  A
    pre-quantized store short-circuits to its own fused scale: no pass over
    the data."""
    if store.is_quantized(field_names):
        return store.fused_scale(field_names)
    maxabs = np.zeros(store.total_dim(field_names), dtype=np.float32)
    offs = store.field_offsets(field_names)
    for name in field_names:
        f = store.fields[name]
        sl = offs[name]
        for at in range(0, f.shape[0], chunk):
            m = np.max(np.abs(f[at:at + chunk].astype(np.float32)), axis=0)
            np.maximum(maxabs[sl], m, out=maxabs[sl])
    scale = maxabs / 127.0
    scale[scale == 0.0] = 1.0
    return scale


def quantize_rows(rows: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """f32 rows -> int8 with the per-column ``scale`` (round-to-nearest,
    clipped to [-127, 127]; -128 unused to keep the scheme symmetric)."""
    q = np.rint(np.asarray(rows, dtype=np.float32) / scale[None, :])
    return np.clip(q, -127, 127).astype(np.int8)


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
    """Host-computed per-batch cache plan: one index a layer-0 row.

    ``src_row[r] >= 0`` is row r's cache row; ``src_row[r] = -1 - k`` is
    miss row k.  Padded rows read cache row 0.  The JAX package's plan
    carries the same as ``hit_mask``, ``cache_pos`` and ``miss_slot``."""

    src_row: np.ndarray          # int32 [cap0]
    miss_feats: torch.Tensor     # [bucket, total_dim] host rows in the tier's dtype


def assemble_features(
    cache_values: torch.Tensor,   # [capacity, total_dim] f32 | bf16 | int8
    src_row: torch.Tensor,        # int32 [cap0] from FetchPlan.src_row
    miss_feats: torch.Tensor,     # [bucket, total_dim], cache_values' dtype
    dequant_scale: Optional[torch.Tensor] = None,   # f32 [total_dim], int8 only
    out_dtype: torch.dtype = torch.float32,         # f32, or bf16 at bf16 compute
) -> torch.Tensor:
    """Layer-0 features ``[cap0, total_dim]`` in one K1 launch: the port's
    ``dequantize_fused(assemble_features(cache_values, plan), scale)``, as
    f32 or cast to bf16 (``cast_apply``'s cast).  Equal to it on every valid
    row; padded rows, which no valid ``neigh_pos``/``self_pos`` reads, may
    differ."""
    return assemble(cache_values, src_row, miss_feats, dequant_scale, out_dtype)


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
        reserve_bytes: int = 1 << 30,  # device memory a capacity=None fill leaves free
    ):
        if dtype not in ROW_DTYPES:
            raise ValueError(f"cache dtype must be one of {tuple(ROW_DTYPES)}, got {dtype!r}")
        self.dtype = dtype
        self.row_dtype = ROW_DTYPES[dtype]
        self.reserve_bytes = reserve_bytes
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
        # int8 tier: store-wide per-column scale, computed once here, so
        # cached rows and miss rows share it whatever the capacity
        self.dequant_scale: Optional[np.ndarray] = None
        self.dequant_scale_dev: Optional[torch.Tensor] = None
        # a pre-quantized store feeds the int8 tier its rows as stored
        self._store_i8 = dtype == "int8" and store.is_quantized(self.field_names)
        if dtype == "int8":
            self.dequant_scale = compute_dequant_scale(store, self.field_names)
            self.dequant_scale_dev = torch.from_numpy(self.dequant_scale).to(
                self.device, copy=True)
        n = local_graph.num_nodes
        self.cache_map = np.full(n, -1, dtype=np.int32)
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

    def auto_capacity(self, reserve_bytes: Optional[int] = None) -> int:
        """Vertices whose rows fit in the device's free memory less
        ``reserve_bytes`` (the cache's ``reserve_bytes`` by default), at the
        tier's own row width: bf16 caches twice the vertices of f32, int8
        four times."""
        if reserve_bytes is None:
            reserve_bytes = self.reserve_bytes
        free = free_hbm_bytes(self.device, reserve=reserve_bytes)
        row_bytes = self.total_dim * self.row_dtype.itemsize
        return int(free // row_bytes)

    def _to_rows(self, rows: np.ndarray) -> torch.Tensor:
        """Host rows -> host tensor in the tier's dtype: int8 rows as they
        are; f32 rows quantized with the store-wide scale (int8) or rounded
        to nearest even (bf16)."""
        if rows.dtype == np.int8:
            return torch.from_numpy(rows)
        if self.dtype == "int8":
            return torch.from_numpy(quantize_rows(rows, self.dequant_scale))
        return torch.from_numpy(rows).to(self.row_dtype)

    def _gather(self, nids: np.ndarray, out: Optional[np.ndarray] = None) -> np.ndarray:
        """The store's rows of ``nids`` (local ids): as stored (int8) when
        the tier is int8 and the store pre-quantized, else f32."""
        return self.store.gather(self.field_names, self.local2full[nids], out=out,
                                 quantized=self._store_i8)

    def tier_rows(self, full_ids: np.ndarray) -> torch.Tensor:
        """The store's rows of full-graph ``full_ids`` as a host tensor in
        the tier's dtype (the halo exchange's shard, ``parallel/halo.py``)."""
        rows = self.store.gather(self.field_names, np.asarray(full_ids, dtype=np.int64),
                                 quantized=self._store_i8)
        return self._to_rows(rows)

    def fill(self, capacity: Optional[int] = None,
             rank_by: str = "out_degree") -> None:
        """Size and populate the cache: everything if it fits, else the top
        ``capacity`` vertices by ``rank_by``.  A full fill keeps the identity
        map (cache row = vertex id), which the on-device path reads rows by;
        ``fully_cached`` says it holds.  The rows of an earlier fill are
        released first (and on CUDA handed back to the device), so a
        ``capacity=None`` refill sizes itself without them."""
        n = self.graph.num_nodes
        self.cache_values = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
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
            host_rows = self._gather(chosen)
        # copy=True: on a CPU device the tensor must not alias a host buffer
        self.cache_values = self._to_rows(host_rows).to(self.device, copy=True)

    # -- per-batch fetch ----------------------------------------------------

    def fetch_plan(self, input_nids: np.ndarray, input_mask: np.ndarray, *,
                   track: bool = True) -> FetchPlan:
        """Host-side hit/miss split + miss gather.  Miss rows are packed in
        first-occurrence order of the valid misses, in the tier's dtype (from
        a pre-quantized store, gathered straight into the int8 buffer)."""
        nids = np.asarray(input_nids)
        mask = np.asarray(input_mask)
        pos = self.cache_map[nids]
        miss = (pos < 0) & mask
        n_miss = int(miss.sum())
        if track:
            with self._stat_lock:
                self.try_num += int(mask.sum())
                self.miss_num += n_miss
                if self.track_access:
                    np.add.at(self.access_counts, nids[mask], 1)
        bucket = bucket_size(n_miss, len(nids))
        rows = np.zeros((bucket, self.total_dim),
                        dtype=np.int8 if self._store_i8 else np.float32)
        src_row = np.where(mask & (pos >= 0), pos, 0).astype(np.int32)
        if n_miss:
            miss_idx = np.nonzero(miss)[0]
            src_row[miss_idx] = -1 - np.arange(n_miss, dtype=np.int32)
            self._gather(nids[miss_idx], out=rows[:n_miss])
        return FetchPlan(src_row=src_row, miss_feats=self._to_rows(rows))

    # -- metrics ------------------------------------------------------------

    def miss_rate(self) -> float:
        return self.miss_num / self.try_num if self.try_num else 0.0

    def reset_stats(self) -> None:
        self.try_num = 0
        self.miss_num = 0
