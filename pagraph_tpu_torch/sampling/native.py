"""ctypes binding of the host library: the native sampler, the miss-row
gathers, the mean-aggregate SpMMs of the preprocess field, the R-MAT
generator and CSR conversion, and the partition pipeline's dg assignment, hop
closure, sub-CSR row fill and histogram (the port of the parts of
``pagraph_tpu/sampling/native.py`` that the host path, the store, the
synthetic data and ``partition/`` run).

The library is the port's own ``csrc/host_native.cpp``, compiled with g++
(OpenMP) at first use into ``_build/`` by :func:`ops._build.build_host`
(under a file lock, to a temporary name moved into place), and loaded once
a process.  Its sampler draws from ``splitmix64`` seeded per batch, vertex
and hop, with the JAX package's arithmetic, so :class:`NativeSampler` gives
the batches of ``pagraph_tpu``'s native sampler bit for bit.  The OpenMP
pool takes its size from ``OMP_NUM_THREADS`` (every core when unset).
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from ..config import SamplerConfig
from ..graph import CSRGraph
from ..ops import _build
from .block import Block, MiniBatch

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i8p = ctypes.POINTER(ctypes.c_int8)
_f32p = ctypes.POINTER(ctypes.c_float)
_f64p = ctypes.POINTER(ctypes.c_double)
_u64p = ctypes.POINTER(ctypes.c_uint64)

SIGNATURES = {
    "pg_sample_minibatch": (ctypes.c_int, [
        _i64p, _i32p, ctypes.c_int64,            # indptr, indices, num_nodes
        _i64p, ctypes.c_int64,                    # seeds, num_seeds
        _i32p, ctypes.c_int32, _i64p,             # fanouts[hops], hops, caps
        ctypes.c_uint64,                          # seed
        _i32p,                                    # pos_of scratch
        _i32p, _i64p,                             # layer_nids, layer_sizes
        _i32p, _u8p, _i32p,                       # neigh_pos, neigh_mask, self_pos
    ]),
    "pg_gather_rows_f32": (None, [_f32p, ctypes.c_int64, ctypes.c_int64, _i64p,
                                  ctypes.c_int64, _f32p]),
    "pg_gather_rows_i8": (None, [_i8p, ctypes.c_int64, ctypes.c_int64, _i64p,
                                 ctypes.c_int64, _i8p]),
    "pg_spmm_mean_f32": (None, [_i64p, _i32p, ctypes.c_int64, _f32p, ctypes.c_int64,
                                _f32p, _f32p]),
    "pg_spmm_mean_i8": (None, [_i64p, _i32p, _i8p, ctypes.c_int64, _f32p, _f32p,
                               ctypes.c_int64, ctypes.c_int64, _f32p]),
    "pg_rmat_gen": (None, [ctypes.c_int32, ctypes.c_int64, ctypes.c_double,
                           ctypes.c_double, ctypes.c_double, ctypes.c_uint64,
                           _i32p, _i32p]),
    "pg_coo_to_csr": (ctypes.c_int64, [_i32p, _i32p, ctypes.c_int64, ctypes.c_int64,
                                       ctypes.c_int32, _i64p, _i32p, _i64p, _i32p]),
    "pg_dg_assign": (ctypes.c_int, [
        _i64p, _i32p, ctypes.c_int64,             # indptr, indices, num_nodes
        _i64p, ctypes.c_int64,                    # train_nids, num_train
        ctypes.c_int32, ctypes.c_int32,           # num_parts, hops
        ctypes.c_double, _f64p,                   # avg, weights (NULL: 1.0)
        _i32p,                                    # out: partition a train vertex
    ]),
    "pg_hop_closure": (None, [_i64p, _i32p, ctypes.c_int64, _i64p, ctypes.c_int64,
                              ctypes.c_int32, _u64p, _u64p]),
    "pg_bitmap_extract": (ctypes.c_int64, [_u64p, ctypes.c_int64, _i64p]),
    "pg_map_rows": (ctypes.c_int, [_i64p, _i32p, _i32p, _i64p, _i64p, ctypes.c_int64,
                                   _i32p]),
    "pg_histogram_i32": (None, [_i32p, ctypes.c_int64, ctypes.c_int64, _i32p]),
}


def get_lib() -> ctypes.CDLL:
    """The host library, built first if needed; raises ``RuntimeError``
    (no g++, a failed build) or ``OSError`` (a library that will not load)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build.build_host())
            for name, (restype, argtypes) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
        return _lib


def _ptr(arr: np.ndarray, typ):
    return arr.ctypes.data_as(typ)


class NativeSampler:
    """The native backend of :class:`NeighborSampler`: one batch a call,
    from a 64-bit seed.  Needs ``include_self``."""

    def __init__(self, graph: CSRGraph, config: SamplerConfig, caps):
        if not config.include_self:
            raise NotImplementedError("native sampler requires include_self")
        self.lib = get_lib()
        self.graph = graph
        self.config = config
        self.caps = np.asarray(caps, dtype=np.int64)
        self.hops = config.num_hops
        # hop-ordered for the C call ([0] = from the seeds) and block-ordered
        # for the output layout (outermost block first)
        self.hop_fanouts = np.asarray(config.hop_fanouts(), dtype=np.int32)
        self.block_fanouts = np.asarray(config.block_fanouts(), dtype=np.int64)
        self._indptr = np.ascontiguousarray(graph.indptr, dtype=np.int64)
        self._indices = np.ascontiguousarray(graph.indices, dtype=np.int32)
        self._pos_of = np.full(graph.num_nodes, -1, dtype=np.int32)   # reused scratch
        self._nid_off = np.concatenate([[0], np.cumsum(self.caps)])
        dst_caps = self.caps[1:]
        self._blk_off = np.concatenate([[0], np.cumsum(dst_caps * self.block_fanouts)])
        self._self_off = np.concatenate([[0], np.cumsum(dst_caps)])

    def sample(self, seeds: np.ndarray, labels: Optional[np.ndarray],
               seed: int) -> MiniBatch:
        caps, hops = self.caps, self.hops
        seeds = np.ascontiguousarray(seeds, dtype=np.int64)
        layer_nids = np.zeros(int(caps.sum()), dtype=np.int32)
        layer_sizes = np.zeros(hops + 1, dtype=np.int64)
        neigh_pos = np.zeros(int(self._blk_off[-1]), dtype=np.int32)
        neigh_mask = np.zeros(int(self._blk_off[-1]), dtype=np.uint8)
        self_pos = np.zeros(int(self._self_off[-1]), dtype=np.int32)
        rc = self.lib.pg_sample_minibatch(
            _ptr(self._indptr, _i64p), _ptr(self._indices, _i32p),
            ctypes.c_int64(self.graph.num_nodes),
            _ptr(seeds, _i64p), ctypes.c_int64(len(seeds)),
            _ptr(self.hop_fanouts, _i32p), ctypes.c_int32(hops),
            _ptr(caps, _i64p), ctypes.c_uint64(seed & (2**64 - 1)),
            _ptr(self._pos_of, _i32p),
            _ptr(layer_nids, _i32p), _ptr(layer_sizes, _i64p),
            _ptr(neigh_pos, _i32p), _ptr(neigh_mask, _u8p),
            _ptr(self_pos, _i32p),
        )
        if rc != 0:
            raise ValueError(f"{len(seeds)} seeds exceed seed capacity {int(caps[-1])}")

        nids, masks, blocks = [], [], []
        for i in range(hops + 1):
            nids.append(layer_nids[int(self._nid_off[i]):int(self._nid_off[i + 1])])
            m = np.zeros(int(caps[i]), dtype=bool)
            m[: int(layer_sizes[i])] = True
            masks.append(m)
        for b in range(hops):
            cap_dst, fb = int(caps[b + 1]), int(self.block_fanouts[b])
            psl = slice(int(self._blk_off[b]), int(self._blk_off[b + 1]))
            ssl = slice(int(self._self_off[b]), int(self._self_off[b + 1]))
            blocks.append(Block(
                neigh_pos=neigh_pos[psl].reshape(cap_dst, fb),
                neigh_mask=neigh_mask[psl].reshape(cap_dst, fb).view(bool),
                self_pos=self_pos[ssl],
            ))
        lab = np.zeros(int(caps[-1]), dtype=np.int32)
        if labels is not None:
            lab[: len(seeds)] = labels[seeds].astype(np.int32)
        return MiniBatch(layer_nids=tuple(nids), layer_mask=tuple(masks),
                         blocks=tuple(blocks), labels=lab)


def gather_rows_f32(src: np.ndarray, ids: np.ndarray,
                    out: Optional[np.ndarray] = None) -> np.ndarray:
    """OpenMP row gather: ``out[i] = src[ids[i]]`` for a C-contiguous f32
    ``src`` (``out`` C-contiguous ``[len(ids), D]`` f32 when given)."""
    return _gather_rows("pg_gather_rows_f32", np.float32, _f32p, src, ids, out)


def gather_rows_i8(src: np.ndarray, ids: np.ndarray,
                   out: Optional[np.ndarray] = None) -> np.ndarray:
    """OpenMP int8 row gather: ``out[i] = src[ids[i]]`` (the pre-quantized
    store's miss path)."""
    return _gather_rows("pg_gather_rows_i8", np.int8, _i8p, src, ids, out)


def _gather_rows(fn: str, dtype, ptype, src, ids, out):
    if src.dtype != dtype or src.ndim != 2 or not src.flags.c_contiguous:
        raise ValueError(f"{fn}: src must be C-contiguous 2-D {np.dtype(dtype)}")
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    if len(ids) and (ids.min() < 0 or ids.max() >= src.shape[0]):
        raise IndexError(f"{fn}: ids out of range [0, {src.shape[0]})")
    if out is None:
        out = np.empty((len(ids), src.shape[1]), dtype=dtype)
    elif (out.dtype != dtype or out.shape != (len(ids), src.shape[1])
          or not out.flags.c_contiguous):
        raise ValueError(f"{fn}: out must be C-contiguous {np.dtype(dtype)} "
                         f"{(len(ids), src.shape[1])}")
    getattr(get_lib(), fn)(_ptr(src, ptype), ctypes.c_int64(src.shape[0]),
                           ctypes.c_int64(src.shape[1]), _ptr(ids, _i64p),
                           ctypes.c_int64(len(ids)), _ptr(out, ptype))
    return out


def _check_graph_rows(fn: str, graph: CSRGraph, rows: int) -> None:
    """The SpMMs read ``x[u]`` for every in-neighbor ``u``: ``x`` needs a row
    for each vertex of ``graph``."""
    if rows != graph.num_nodes:
        raise ValueError(f"{fn}: x has {rows} rows, the graph {graph.num_nodes} vertices")
    if graph.num_edges and (graph.indices.min() < 0 or graph.indices.max() >= rows):
        raise IndexError(f"{fn}: in-neighbor ids out of range [0, {rows})")


def spmm_mean_native(graph: CSRGraph, x: np.ndarray, norm: np.ndarray) -> np.ndarray:
    """``out[v] = norm[v] * sum of in-neighbor rows of x`` (f32, OpenMP)."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    norm = np.ascontiguousarray(norm, dtype=np.float32)
    _check_graph_rows("pg_spmm_mean_f32", graph, x.shape[0])
    if norm.shape != (graph.num_nodes,):
        raise ValueError(f"pg_spmm_mean_f32: norm {norm.shape} for {graph.num_nodes} vertices")
    out = np.empty_like(x)
    get_lib().pg_spmm_mean_f32(
        _ptr(graph.indptr, _i64p), _ptr(graph.indices, _i32p),
        ctypes.c_int64(graph.num_nodes), _ptr(x, _f32p), ctypes.c_int64(x.shape[1]),
        _ptr(norm, _f32p), _ptr(out, _f32p))
    return out


def spmm_mean_i8_native(graph: CSRGraph, x_i8: np.ndarray, scale: np.ndarray,
                        norm: np.ndarray, row_lo: int, row_hi: int,
                        out: Optional[np.ndarray] = None) -> np.ndarray:
    """Mean-aggregate rows ``[row_lo, row_hi)`` of the pre-quantized int8
    feature matrix -> f32 ``[row_hi - row_lo, d]``: ``norm[v] * scale[k] *
    sum of int8 in-neighbor rows`` (exact: the per-column scale factors out
    of the neighbor sum; int64 accumulators)."""
    if x_i8.dtype != np.int8 or x_i8.ndim != 2 or not x_i8.flags.c_contiguous:
        raise ValueError("pg_spmm_mean_i8: x must be C-contiguous 2-D int8")
    _check_graph_rows("pg_spmm_mean_i8", graph, x_i8.shape[0])
    if not 0 <= row_lo <= row_hi <= graph.num_nodes:
        raise IndexError(f"pg_spmm_mean_i8: rows [{row_lo}, {row_hi}) outside "
                         f"[0, {graph.num_nodes}]")
    d = x_i8.shape[1]
    scale = np.ascontiguousarray(scale, dtype=np.float32)
    norm = np.ascontiguousarray(norm, dtype=np.float32)
    if scale.shape != (d,) or norm.shape != (graph.num_nodes,):
        raise ValueError(f"pg_spmm_mean_i8: scale {scale.shape} and norm {norm.shape} "
                         f"for [{graph.num_nodes}, {d}]")
    if out is None:
        out = np.empty((row_hi - row_lo, d), dtype=np.float32)
    elif (out.dtype != np.float32 or out.shape != (row_hi - row_lo, d)
          or not out.flags.c_contiguous):
        raise ValueError(f"pg_spmm_mean_i8: out must be C-contiguous f32 {(row_hi - row_lo, d)}")
    get_lib().pg_spmm_mean_i8(
        _ptr(graph.indptr, _i64p), _ptr(graph.indices, _i32p), _ptr(x_i8, _i8p),
        ctypes.c_int64(d), _ptr(norm, _f32p), _ptr(scale, _f32p),
        ctypes.c_int64(row_lo), ctypes.c_int64(row_hi), _ptr(out, _f32p))
    return out


def rmat_edges_native(scale: int, num_edges: int, *, a: float = 0.57, b: float = 0.19,
                      c: float = 0.19, seed: int = 0) -> tuple:
    """R-MAT edge draw (OpenMP, one splitmix64 stream an edge) -> ``(src,
    dst)`` int32 arrays of exactly ``num_edges`` (self-loops re-drawn;
    duplicates removed at the CSR build)."""
    src = np.empty(num_edges, dtype=np.int32)
    dst = np.empty(num_edges, dtype=np.int32)
    get_lib().pg_rmat_gen(ctypes.c_int32(scale), ctypes.c_int64(num_edges),
                          ctypes.c_double(a), ctypes.c_double(b), ctypes.c_double(c),
                          ctypes.c_uint64(seed & (2**64 - 1)),
                          _ptr(src, _i32p), _ptr(dst, _i32p))
    return src, dst


def coo_to_csr_native(src: np.ndarray, dst: np.ndarray, num_nodes: int, *,
                      drop_self: bool = False) -> CSRGraph:
    """COO (src -> dst) to in-CSR with each row sorted and deduplicated (as
    ``CSRGraph.from_coo``)."""
    src = np.ascontiguousarray(src, dtype=np.int32)
    dst = np.ascontiguousarray(dst, dtype=np.int32)
    m, n = len(src), int(num_nodes)
    if len(dst) != m:
        raise ValueError(f"pg_coo_to_csr: {m} sources and {len(dst)} destinations")
    for name, ids in (("src", src), ("dst", dst)):
        if m and (ids.min() < 0 or ids.max() >= n):
            raise IndexError(f"pg_coo_to_csr: {name} ids out of range [0, {n})")
    indptr = np.empty(n + 1, dtype=np.int64)
    indices = np.empty(m, dtype=np.int32)
    cursor = np.empty(n, dtype=np.int64)
    out_deg = np.empty(n, dtype=np.int32)
    e = get_lib().pg_coo_to_csr(
        _ptr(src, _i32p), _ptr(dst, _i32p), ctypes.c_int64(m), ctypes.c_int64(n),
        ctypes.c_int32(1 if drop_self else 0), _ptr(indptr, _i64p),
        _ptr(indices, _i32p), _ptr(cursor, _i64p), _ptr(out_deg, _i32p))
    return CSRGraph(indptr=indptr, indices=np.ascontiguousarray(indices[:e]),
                    out_degrees=out_deg)


# -- the partition pipeline ---------------------------------------------------

def hop_closure_native(graph: CSRGraph, seeds: np.ndarray, hops: int) -> tuple:
    """Bitmap BFS closure: ``(closure_ids, interior_ids)``, sorted int64,
    the same sets as ``partition.utils.hop_closure``'s numpy backend."""
    seeds = np.unique(np.asarray(seeds, dtype=np.int64))
    n = graph.num_nodes
    if len(seeds) and (seeds[0] < 0 or seeds[-1] >= n):
        raise IndexError(f"pg_hop_closure: seeds out of range [0, {n})")
    lib = get_lib()
    words = (n + 63) // 64
    visited = np.zeros(words, dtype=np.uint64)
    interior = np.zeros(words, dtype=np.uint64)
    lib.pg_hop_closure(_ptr(graph.indptr, _i64p), _ptr(graph.indices, _i32p),
                       ctypes.c_int64(n), _ptr(seeds, _i64p), ctypes.c_int64(len(seeds)),
                       ctypes.c_int32(hops), _ptr(visited, _u64p), _ptr(interior, _u64p))
    if hops == 0:
        interior = visited

    def extract(bm: np.ndarray) -> np.ndarray:
        out = np.empty(n, dtype=np.int64)
        cnt = lib.pg_bitmap_extract(_ptr(bm, _u64p), ctypes.c_int64(words), _ptr(out, _i64p))
        return np.ascontiguousarray(out[:cnt])

    return extract(visited), extract(interior)


def map_rows_native(graph: CSRGraph, full2sub: np.ndarray, rows: np.ndarray,
                    out_starts: np.ndarray, total: int) -> np.ndarray:
    """Sub-CSR row fill (OpenMP): ``out[out_starts[i]:...] =
    full2sub[in-neighbors of rows[i]]``; raises ``ValueError`` if a
    neighbor is outside the closure."""
    full2sub = np.ascontiguousarray(full2sub, dtype=np.int32)
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    out_starts = np.ascontiguousarray(out_starts, dtype=np.int64)
    if full2sub.shape != (graph.num_nodes,) or rows.shape != out_starts.shape:
        raise ValueError(f"pg_map_rows: full2sub {full2sub.shape} for {graph.num_nodes} "
                         f"vertices, rows {rows.shape}, out_starts {out_starts.shape}")
    if len(rows) and (rows.min() < 0 or rows.max() >= graph.num_nodes):
        raise IndexError(f"pg_map_rows: rows out of range [0, {graph.num_nodes})")
    lens = graph.indptr[rows + 1] - graph.indptr[rows]
    if len(rows) and (out_starts.min() < 0 or (out_starts + lens).max() > total):
        raise IndexError(f"pg_map_rows: rows do not fit in {total} output slots")
    out = np.empty(total, dtype=np.int32)
    rc = get_lib().pg_map_rows(_ptr(graph.indptr, _i64p), _ptr(graph.indices, _i32p),
                               _ptr(full2sub, _i32p), _ptr(rows, _i64p),
                               _ptr(out_starts, _i64p), ctypes.c_int64(len(rows)),
                               _ptr(out, _i32p))
    if rc != 0:
        raise ValueError("closure must contain all interior in-neighbors")
    return out


def histogram_i32_native(values: np.ndarray, nbins: int) -> np.ndarray:
    """``np.bincount(values, minlength=nbins)`` as int32, OpenMP atomics."""
    values = np.ascontiguousarray(values, dtype=np.int32)
    if len(values) and (values.min() < 0 or values.max() >= nbins):
        raise IndexError(f"pg_histogram_i32: values out of range [0, {nbins})")
    out = np.empty(nbins, dtype=np.int32)
    get_lib().pg_histogram_i32(_ptr(values, _i32p), ctypes.c_int64(len(values)),
                               ctypes.c_int64(nbins), _ptr(out, _i32p))
    return out


def dg_assign_native(graph: CSRGraph, train_nids: np.ndarray, num_parts: int, hops: int,
                     avg: float, weights: Optional[np.ndarray] = None) -> np.ndarray:
    """The greedy dg assignment in C++: the numpy stream of
    ``partition.dg_part.dg_assign`` bit for bit (the same double arithmetic
    and tie rule).  ``weights`` (float64 a train vertex, ``avg`` in the same
    units) is the edge-balance mode."""
    train_nids = np.ascontiguousarray(train_nids, dtype=np.int64)
    out = np.empty(len(train_nids), dtype=np.int32)
    if weights is not None:
        weights = np.ascontiguousarray(weights, dtype=np.float64)
        if weights.shape != train_nids.shape:
            raise ValueError(f"pg_dg_assign: {len(weights)} weights for "
                             f"{len(train_nids)} train vertices")
        wp = _ptr(weights, _f64p)
    else:
        wp = ctypes.cast(None, _f64p)
    rc = get_lib().pg_dg_assign(
        _ptr(graph.indptr, _i64p), _ptr(graph.indices, _i32p),
        ctypes.c_int64(graph.num_nodes), _ptr(train_nids, _i64p),
        ctypes.c_int64(len(train_nids)), ctypes.c_int32(num_parts), ctypes.c_int32(hops),
        ctypes.c_double(avg), wp, _ptr(out, _i32p))
    if rc != 0:
        raise ValueError(f"pg_dg_assign failed (rc={rc}): num_parts {num_parts}, hops "
                         f"{hops}, train ids in [0, {graph.num_nodes})")
    return out
