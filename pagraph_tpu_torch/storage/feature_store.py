"""Host-DRAM feature store — the CPU tier of the two-level feature hierarchy
(the port of ``pagraph_tpu/storage/feature_store.py``).

Named per-vertex numpy arrays over the full graph id space with a fused row
gather for the cache-miss path.  Fields follow the reference's store schema:
``features`` and ``norm`` (1/in_degree).  A field is float32, or int8 with a
per-column dequant scale: the pre-quantized tier (:func:`quantize_store`,
:func:`build_prequantized`), whose miss rows the int8 cache gathers and
ships as they are stored.  ``native=True`` (the default) gathers the miss
rows of a single f32 field, and of each int8 field into the int8 tier's
buffer, with the host library's OpenMP row copies
(``sampling/native.py``), as the JAX package's store does; other gathers
are ``np.take``.  Not ported yet: the preprocess fields, which need
``full_graph_mean_aggregate`` and its int8 SpMM (ROADMAP queue 1 items 4
and 8).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from ..graph import CSRGraph, gcn_norm

FIELD_DTYPES = (np.dtype(np.float32), np.dtype(np.int8))


class FeatureStore:
    """Named per-vertex arrays over the FULL graph id space.

    ``scales``: per-column symmetric dequant scales of the int8 fields, the
    pre-quantized host tier: such a field lives in host memory as int8 (4x
    smaller than f32), the int8 cache gathers and ships its rows as they are,
    and f32 consumers get ``row * scale``.  ``native``: gather with the host
    library where the JAX package's store does (the library is built at the
    first such gather; a failed build raises)."""

    def __init__(self, fields: Dict[str, np.ndarray], *, native: bool = True,
                 scales: Optional[Dict[str, np.ndarray]] = None):
        n = None
        self.fields: Dict[str, np.ndarray] = {}
        for name, arr in fields.items():
            if arr.ndim == 1:
                arr = arr[:, None]
            if arr.dtype not in FIELD_DTYPES:
                raise NotImplementedError(
                    f"field {name!r} is {arr.dtype}: the port's store holds "
                    "float32 fields and int8 fields with a scale")
            if n is None:
                n = arr.shape[0]
            elif arr.shape[0] != n:
                raise ValueError(f"field {name!r} has {arr.shape[0]} rows, expected {n}")
            self.fields[name] = arr
        self.num_nodes = n or 0
        self.scales: Dict[str, np.ndarray] = {}
        for name, sc in (scales or {}).items():
            if self.fields[name].dtype != np.int8:
                raise ValueError(f"scale given for non-int8 field {name!r}")
            sc = np.asarray(sc, dtype=np.float32).reshape(-1)
            if len(sc) != self.fields[name].shape[1]:
                raise ValueError(f"scale length mismatch for field {name!r}")
            self.scales[name] = sc
        for name, arr in self.fields.items():
            if arr.dtype == np.int8 and name not in self.scales:
                raise ValueError(f"int8 field {name!r} requires a dequant scale")
        self.native = native

    def is_quantized(self, names: Sequence[str]) -> bool:
        """True iff every named field is stored int8 (with scales)."""
        return all(self.fields[n].dtype == np.int8 for n in names)

    def fused_scale(self, names: Sequence[str]) -> np.ndarray:
        """Concatenated per-column dequant scale across ``names`` (int8 tier)."""
        return np.concatenate([self.scales[n] for n in names])

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
               out: Optional[np.ndarray] = None, *,
               quantized: bool = False) -> np.ndarray:
        """Fused gather of ``names`` fields for ``nids`` -> [len(nids),
        total_dim] (the cache-miss path).  ``quantized=True`` (every named
        field int8) returns the raw int8 rows, with no f32 copy: the int8
        tier's miss path.  Otherwise the rows are f32, int8 fields times
        their scales."""
        total = self.total_dim(names)
        if quantized and not self.is_quantized(names):
            raise ValueError("quantized gather over non-int8 fields")
        if out is None:
            out = np.empty((len(nids), total), dtype=np.int8 if quantized else np.float32)
        at = 0
        for n in names:
            f = self.fields[n]
            d = f.shape[1]
            dst = out[:, at:at + d]
            if (self.native and f.dtype == (np.int8 if quantized else np.float32)
                    and f.flags.c_contiguous and dst.flags.c_contiguous):
                from ..sampling import native
                (native.gather_rows_i8 if quantized else native.gather_rows_f32)(f, nids, dst)
            elif f.dtype == np.int8 and not quantized:
                rows = np.take(f, nids, axis=0).astype(np.float32)
                rows *= self.scales[n][None, :]
                dst[:] = rows
            else:
                np.take(f, nids, axis=0, out=dst)
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


def _quantize_chunked(f: np.ndarray, chunk: int):
    """Per-column symmetric ``maxabs/127`` scale (1 for an all-zero column)
    and the int8 rows, both in chunks of ``chunk`` rows."""
    maxabs = np.zeros(f.shape[1], dtype=np.float32)
    for at in range(0, f.shape[0], chunk):
        np.maximum(maxabs, np.max(np.abs(f[at:at + chunk].astype(np.float32)), axis=0),
                   out=maxabs)
    scale = maxabs / 127.0
    scale[scale == 0.0] = 1.0
    q = np.empty(f.shape, dtype=np.int8)
    for at in range(0, f.shape[0], chunk):
        blk = np.rint(f[at:at + chunk].astype(np.float32) / scale[None, :])
        q[at:at + chunk] = np.clip(blk, -127, 127).astype(np.int8)
    return q, scale


def quantize_store(store: FeatureStore, field_names: Optional[Sequence[str]] = None,
                   chunk: int = 1 << 20) -> FeatureStore:
    """Convert the named f32 fields (default: all multi-column fields) to the
    pre-quantized int8 tier: per-column symmetric ``maxabs/127`` scales, rows
    stored int8, in chunks, in a NEW store; unnamed fields (e.g. ``norm``)
    pass through unchanged."""
    if field_names is None:
        field_names = [n for n, f in store.fields.items()
                       if f.dtype == np.float32 and f.shape[1] > 1]
    fields, scales = dict(store.fields), dict(store.scales)
    for name in field_names:
        fields[name], scales[name] = _quantize_chunked(store.fields[name], chunk)
    return FeatureStore(fields, scales=scales)


def build_prequantized(graph: CSRGraph, feats_i8: np.ndarray, feat_scale, *,
                       preprocess: Optional[str] = None,
                       chunk: int = 1 << 21) -> FeatureStore:
    """Serving store straight from int8 features, never materializing an
    ``[N, D]`` f32 matrix: ``features`` (int8, with ``feat_scale``, one
    scale or one a column) and ``norm``.  ``preprocess`` needs the chunked
    int8-input SpMM of the native library (``chunk`` is its row chunk),
    which is not ported yet (ROADMAP queue 1 items 3-4)."""
    if preprocess is not None:
        raise NotImplementedError(
            f"build_prequantized(preprocess={preprocess!r}) needs the native int8 "
            "SpMM (spmm_mean_i8_native), which is not ported yet (ROADMAP queue 1 "
            "items 3-4)")
    feats_i8 = np.ascontiguousarray(feats_i8, dtype=np.int8)
    d = feats_i8.shape[1]
    scale = np.broadcast_to(
        np.asarray(feat_scale, dtype=np.float32).reshape(-1), (d,)
    ).copy() if np.ndim(feat_scale) <= 1 else np.asarray(feat_scale)
    return FeatureStore({"features": feats_i8, "norm": gcn_norm(graph)},
                        scales={"features": scale})
