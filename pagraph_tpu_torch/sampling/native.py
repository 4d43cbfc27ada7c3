"""ctypes binding of the host library: the native sampler and the miss-row
gathers (the port of the part of ``pagraph_tpu/sampling/native.py`` that the
host path runs).

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
