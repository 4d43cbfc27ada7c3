"""Host-DRAM feature store — the CPU tier of the two-level feature hierarchy
(the port of ``pagraph_tpu/storage/feature_store.py`` ``FeatureStore``).

Named per-vertex numpy arrays over the full graph id space with a fused row
gather for the cache-miss path.  Fields follow the reference's store schema:
``features`` and ``norm`` (1/in_degree).  Not ported yet: the int8
pre-quantized tier, the native C++ gather, and the preprocess fields, which
need ``full_graph_mean_aggregate`` (ROADMAP queue 1).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from ..graph import CSRGraph, gcn_norm


class FeatureStore:
    """Named float32 per-vertex arrays over the FULL graph id space."""

    def __init__(self, fields: Dict[str, np.ndarray]):
        n = None
        self.fields: Dict[str, np.ndarray] = {}
        for name, arr in fields.items():
            if arr.ndim == 1:
                arr = arr[:, None]
            if arr.dtype != np.float32:
                raise NotImplementedError(
                    f"field {name!r} is {arr.dtype}: the port's store holds "
                    "float32 fields only (the int8 tier is not ported yet)")
            if n is None:
                n = arr.shape[0]
            elif arr.shape[0] != n:
                raise ValueError(f"field {name!r} has {arr.shape[0]} rows, expected {n}")
            self.fields[name] = arr
        self.num_nodes = n or 0

    def dim(self, name: str) -> int:
        return self.fields[name].shape[1]

    def total_dim(self, names: Sequence[str]) -> int:
        return sum(self.dim(n) for n in names)

    def field_offsets(self, names: Sequence[str]) -> Dict[str, slice]:
        offs, at = {}, 0
        for n in names:
            offs[n] = slice(at, at + self.dim(n))
            at += self.dim(n)
        return offs

    def gather(self, names: Sequence[str], nids: np.ndarray,
               out: Optional[np.ndarray] = None) -> np.ndarray:
        """Fused gather of ``names`` fields for ``nids`` -> [len(nids), total_dim]
        (the cache-miss path)."""
        if out is None:
            out = np.empty((len(nids), self.total_dim(names)), dtype=np.float32)
        at = 0
        for n in names:
            f = self.fields[n]
            d = f.shape[1]
            np.take(f, nids, axis=0, out=out[:, at:at + d])
            at += d
        return out

    @classmethod
    def build(cls, graph: CSRGraph, features: np.ndarray, *,
              preprocess: Optional[str] = None) -> "FeatureStore":
        """The serving fields: ``features`` and ``norm``."""
        if preprocess is not None:
            raise NotImplementedError(
                "preprocess fields need full_graph_mean_aggregate, which is "
                "not ported yet (ROADMAP queue 1)")
        return cls({"features": np.asarray(features, dtype=np.float32),
                    "norm": gcn_norm(graph)})
