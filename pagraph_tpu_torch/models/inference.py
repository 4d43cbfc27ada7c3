"""Full-graph layer-wise inference and evaluation (the port of
``pagraph_tpu/models/inference.py``), for GraphSAGE, GCN, CV-GCN, GIN and
GAT.

The reference evaluates by building a full-neighborhood NodeFlow over the
test set and running the ``*Infer`` model variants.  Two backends with the
same semantics, as in the JAX package:

  * ``host``: exact aggregation over all in-neighbors on the host (a scipy
    CSR SpMM for sum and mean, a segment max for pool; GAT's edge softmax
    in numpy, ``np.maximum.at`` and ``np.add.at``), the linears on the
    model's device in row batches;
  * ``device``: the whole layer-wise propagation on the model's device.
    Sum, mean and max aggregation is scatter-free: each vertex reduces a
    padded window of its in-neighbor rows (:class:`_BucketedNeighborhoods`,
    vertices bucketed by power-of-two in-degree, hubs split into windows
    whose partials a second level reduces), each bucket one
    ``gather_kernels.gather_reduce`` launch (sum or max kind) at its
    fan-out, 8 to 4096: the block forward kernel's neighbor half at a
    fan-out it has an unrolled instantiation for (8 and 16), the window
    kernel (``pg_window_reduce``) from 32 slots up.  The window tables and
    their masks are built once a graph.  GAT's per-edge softmax needs the
    edges themselves: three chunked scans of the edge list on the device
    (:func:`_gat_device_layer`, library scatters, as the JAX package's XLA
    scatters; the JAX package has no Pallas kernel there).  GAT's residual
    form (``model.residual``) adds each layer's bias and skip on both
    backends, as training does.

Per architecture: GraphSAGE ``fc_self(h) + fc_neigh(agg(h))`` with mean,
gcn (sum), pool (max) or lstm over every in-neighbor, and under preprocess
the ``pre`` update on the full-graph mean of the features (training's
``neigh`` field); GCN the sum over every in-neighbor times the
destination's norm (the exact mean), through ``dense`` first under
preprocess (whose layer-0 aggregate is the store's ``features`` field); GIN
``(1 + eps) h + sum``; GAT the softmax over every in-edge and the self
edge.  The lstm aggregate runs the training op
(``ops.aggregate.block_aggregate_lstm``) on vertices bucketed by
power-of-two in-degree, on the model's device, for both backends, as the
JAX package does.  CV-GCN evaluates as a preprocess GCN with the
concat-skip on whatever ``skip_connection`` says (its output layer is
always built for the doubled width): under exact full-neighborhood
aggregation its control variate vanishes.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import scipy.sparse as spsp
import torch
from torch import nn
from torch.nn import functional as F

from ..config import ModelConfig
from ..graph import CSRGraph, gcn_norm
from ..ops.aggregate import block_aggregate_lstm
from ..ops.gather_kernels import gather_reduce
from ..sampling.block import Block
from .sage import AGG_KIND

# backend="auto" takes the device path from this edge count up (the JAX
# package's threshold); smaller graphs stay on the host
AUTO_DEVICE_EDGES = 2_000_000


def _adj_csr(graph: CSRGraph) -> spsp.csr_matrix:
    n = graph.num_nodes
    return spsp.csr_matrix(
        (np.ones(graph.num_edges, dtype=np.float32), graph.indices, graph.indptr),
        shape=(n, n))


def _segment_max(graph: CSRGraph, h: np.ndarray) -> np.ndarray:
    """Row-wise max over in-neighbors (the pool aggregator, full graph);
    zero-degree rows stay zero."""
    out = np.zeros((graph.num_nodes, h.shape[1]), dtype=h.dtype)
    gathered = h[graph.indices]                        # [E, D]
    ptr = graph.indptr
    nonempty = np.diff(ptr) > 0
    starts = ptr[:-1][nonempty]
    if len(starts):
        out[nonempty] = np.maximum.reduceat(gathered, starts, axis=0)
    return out


def _aggregate(graph: CSRGraph, adj, h: np.ndarray, kind: str,
               norm: np.ndarray) -> np.ndarray:
    if kind == "mean":
        return (adj @ h) * norm[:, None]
    if kind == "sum":
        return adj @ h
    if kind == "max":
        return _segment_max(graph, h)
    raise ValueError(kind)


def _lstm_full_aggregate(graph: CSRGraph, h: torch.Tensor, lstm_params: Dict[str, torch.Tensor],
                         row_budget: int = 1 << 22) -> torch.Tensor:
    """Exact full-neighborhood LSTM aggregation on ``h``'s device: per
    vertex, the LSTM over all its in-neighbors in CSR order, its final
    hidden state; zero-degree rows stay zero.  Vertices are bucketed by
    power-of-two in-degree, each bucket a padded ``[rows, F]`` block for
    :func:`block_aggregate_lstm`, in chunks whose gathered ``[rows, F, D]``
    messages stay within ``row_budget`` elements."""
    n = graph.num_nodes
    dev = h.device
    deg = np.diff(graph.indptr).astype(np.int64)
    hidden = lstm_params["w_hh"].shape[0]
    out = torch.zeros((n, hidden), dtype=h.dtype, device=dev)
    nz = np.nonzero(deg > 0)[0]
    if len(nz) == 0:
        return out
    d_in = h.shape[1]
    buckets = 1 << np.ceil(np.log2(np.maximum(deg[nz], 1))).astype(np.int64)
    indptr = graph.indptr
    for f in np.unique(buckets):
        vs = nz[buckets == f]
        rows_max = max(1, int(row_budget // max(int(f) * d_in, 1)))
        for i in range(0, len(vs), rows_max):
            chunk = vs[i:i + rows_max]
            lens = deg[chunk]
            cols = np.arange(f, dtype=np.int64)[None, :]
            mask = cols < lens[:, None]
            flat = indptr[chunk][:, None] + np.minimum(cols, lens[:, None] - 1)
            blk = Block(neigh_pos=torch.from_numpy(graph.indices[flat].astype(np.int32)),
                        neigh_mask=torch.from_numpy(mask),
                        self_pos=torch.zeros(len(chunk), dtype=torch.int32)).to(dev)
            out[torch.from_numpy(chunk).to(dev)] = block_aggregate_lstm(h, blk, lstm_params)
    return out


class _BucketedNeighborhoods:
    """Degree-bucketed padded in-neighbor windows on a device: exact
    full-graph sum and max aggregation as window reductions, with no
    scatter.

    - vertices with in-degree 1..``f_cap`` are grouped by power-of-two
      in-degree (at least ``f_min``); each bucket is a window table ``pos``
      int32 ``[rows, F]`` with its mask (``idx != n`` in the JAX package,
      whose padded slots index an appended zero row; here padded slots hold
      0 and are masked, so no row is appended and none is loaded);
    - hubs (in-degree above ``f_cap``) split into ``ceil(deg / f_cap)``
      windows of ``f_cap``, whose partial results a second level reduces,
      bucketed by power-of-two window count (at least 2);
    - the buckets' results concatenate in that order and one ``n``-row
      gather puts them back in vertex order.

    Built once a graph (about 2E int32 and 2E mask bytes on the device);
    each :meth:`aggregate` is one ``gather_reduce`` launch a bucket."""

    def __init__(self, graph: CSRGraph, device, f_min: int = 8, f_cap: int = 4096):
        n = graph.num_nodes
        self.num_nodes = n
        self.device = torch.device(device)
        deg = np.diff(graph.indptr).astype(np.int64)
        indptr, indices = graph.indptr, graph.indices
        zero = np.nonzero(deg == 0)[0]
        perm_parts = [zero]
        self._n0 = len(zero)
        self.buckets: List[Tuple[torch.Tensor, torch.Tensor]] = []
        small = np.nonzero((deg > 0) & (deg <= f_cap))[0]
        if len(small):
            fs = np.maximum(f_min, 1 << np.ceil(np.log2(deg[small])).astype(np.int64))
            for f in np.unique(fs):
                vs = small[fs == f]
                perm_parts.append(vs)
                cols = np.arange(f, dtype=np.int64)[None, :]
                mask = cols < deg[vs][:, None]
                flat = indptr[vs][:, None] + np.where(mask, cols, 0)
                self.buckets.append(self._table(np.where(mask, indices[flat], 0), mask))
        big = np.nonzero(deg > f_cap)[0]
        self.hubs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self.level2: List[Tuple[torch.Tensor, torch.Tensor]] = []
        if len(big):
            # the second level is bucketed by each hub's window count, so one
            # mega-hub does not widen every hub's row; hubs are reordered
            # bucket by bucket so the outputs concatenate in perm order
            wc_all = -(-deg[big] // f_cap)
            f2s = np.maximum(2, 1 << np.ceil(np.log2(wc_all)).astype(np.int64))
            order = np.argsort(f2s, kind="stable")
            big, wcounts, f2s = big[order], wc_all[order], f2s[order]
            perm_parts.append(big)
            w = int(wcounts.sum())
            widx = np.zeros((w, f_cap), dtype=np.int32)
            wmask = np.zeros((w, f_cap), dtype=bool)
            row = 0
            for v, wc in zip(big, wcounts):
                nb = indices[indptr[v]:indptr[v] + deg[v]]
                widx.reshape(-1)[row * f_cap:row * f_cap + len(nb)] = nb
                wmask.reshape(-1)[row * f_cap:row * f_cap + len(nb)] = True
                row += int(wc)
            self.hubs = self._table(widx, wmask)
            starts = np.concatenate([[0], np.cumsum(wcounts)[:-1]])
            for f2 in np.unique(f2s):
                sel = f2s == f2
                cols2 = np.arange(f2, dtype=np.int64)[None, :]
                m2 = cols2 < wcounts[sel][:, None]
                self.level2.append(self._table(np.where(m2, starts[sel][:, None] + cols2, 0), m2))
        perm = np.concatenate(perm_parts)
        inv = np.empty(n, dtype=np.int64)
        inv[perm] = np.arange(n, dtype=np.int64)
        self.inv_perm = torch.from_numpy(inv).to(self.device)

    def _table(self, pos: np.ndarray, mask: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        return (torch.from_numpy(np.ascontiguousarray(pos, dtype=np.int32)).to(self.device),
                torch.from_numpy(np.ascontiguousarray(mask)).to(self.device))

    def tables(self) -> List[Tuple[str, torch.Tensor, torch.Tensor]]:
        """``(level, pos, mask)`` of every window table, in the order
        :meth:`aggregate` reduces them (``level``: ``"bucket"``, ``"hubs"``
        or ``"level2"``, which reduces the hub windows' partials)."""
        return ([("bucket", *t) for t in self.buckets]
                + ([("hubs", *self.hubs)] if self.hubs is not None else [])
                + [("level2", *t) for t in self.level2])

    def aggregate(self, h: torch.Tensor, kind: str) -> torch.Tensor:
        """``[n, D]``: each vertex's sum or max (``kind``) over its
        in-neighbors' rows of ``h``; zero-degree vertices get zeros."""
        if h.shape[0] != self.num_nodes:
            raise ValueError(f"h has {h.shape[0]} rows, the graph {self.num_nodes} vertices")
        h = h.contiguous()
        outs = [h.new_zeros((self._n0, h.shape[1]))] if self._n0 else []
        outs += [gather_reduce(h, pos, mask, kind) for pos, mask in self.buckets]
        if self.hubs is not None:
            partials = gather_reduce(h, *self.hubs, kind)
            outs += [gather_reduce(partials, pos, mask, kind) for pos, mask in self.level2]
        return torch.cat(outs).index_select(0, self.inv_perm)


class _Host:
    """The host backend: aggregation on the host (a scipy CSR SpMM for sum
    and mean, a segment max for max), on CPU tensors; the linears on the
    model's device in row batches; the lstm aggregate on the model's
    device."""

    def __init__(self, graph: CSRGraph, device: torch.device, batch_rows: int):
        self.graph, self.device, self.batch_rows = graph, device, batch_rows
        self.adj = _adj_csr(graph)
        self.norm = gcn_norm(graph)

    def tensor(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(x, dtype=np.float32))

    def aggregate(self, h: torch.Tensor, kind: str) -> torch.Tensor:
        return torch.from_numpy(_aggregate(self.graph, self.adj, h.numpy(), kind, self.norm))

    def lstm(self, h: torch.Tensor, params: Dict[str, torch.Tensor]) -> torch.Tensor:
        return _lstm_full_aggregate(self.graph, h.to(self.device), params).cpu()

    def lin(self, fn, h: torch.Tensor) -> torch.Tensor:
        return torch.cat([fn(h[i:i + self.batch_rows].to(self.device)).cpu()
                          for i in range(0, h.shape[0], self.batch_rows)])


class _Device:
    """The device backend: every aggregation a window reduction on the
    model's device (mean: the sum times ``norm``)."""

    def __init__(self, graph: CSRGraph, device: torch.device):
        self.graph, self.device = graph, device
        self.windows = _BucketedNeighborhoods(graph, device)
        self.norm = torch.from_numpy(gcn_norm(graph)).to(device)[:, None]

    def tensor(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(x, dtype=np.float32)).to(self.device)

    def aggregate(self, h: torch.Tensor, kind: str) -> torch.Tensor:
        if kind == "mean":
            return self.windows.aggregate(h, "sum") * self.norm
        return self.windows.aggregate(h, kind)

    def lstm(self, h: torch.Tensor, params: Dict[str, torch.Tensor]) -> torch.Tensor:
        return _lstm_full_aggregate(self.graph, h, params)

    def lin(self, fn, h: torch.Tensor) -> torch.Tensor:
        return fn(h)


def _leaky(x):
    return np.where(x > 0, x, 0.2 * x)


def _gat_full_graph_host(model: nn.Module, graph: CSRGraph, h: np.ndarray) -> np.ndarray:
    """Exact full-neighborhood GAT in numpy, as the JAX package's: per
    destination a softmax over all its in-edges and the self edge; the
    residual form adds each layer's bias and skip before the ELU."""
    n = graph.num_nodes
    indptr, indices = graph.indptr, graph.indices
    dst_e = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    last = len(model.layers) - 1
    for li, layer in enumerate(model.layers):
        w, a_s, a_n = (t.detach().cpu().numpy() for t in (layer.w, layer.a_self,
                                                            layer.a_neigh))
        k = a_s.shape[0]
        z = (h @ w).reshape(n, k, -1)                        # [N, K, H]
        att_s = np.einsum("nkh,kh->nk", z, a_s)
        att_n = np.einsum("nkh,kh->nk", z, a_n)
        e = _leaky(att_s[dst_e] + att_n[indices])            # [E, K]
        e_self = _leaky(att_s + att_n)                       # [N, K]
        m = e_self.copy()
        np.maximum.at(m, dst_e, e)
        w_e = np.exp(e - m[dst_e])
        w_s = np.exp(e_self - m)
        den = w_s.copy()
        np.add.at(den, dst_e, w_e)
        out = (w_s / den)[:, :, None] * z
        np.add.at(out, dst_e, (w_e / den[dst_e])[:, :, None] * z[indices])
        o = out.mean(axis=1) if li == last else out.reshape(n, -1)
        if hasattr(layer, "skip"):          # the residual form
            b, sw, sb = (t.detach().cpu().numpy() for t in (layer.b, layer.skip.w,
                                                             layer.skip.b))
            o = o + b + h @ sw + sb
        h = o if li == last else np.where(o > 0, o, np.expm1(np.minimum(o, 0.0)))   # elu
    return h


class _DeviceEdges:
    """The edge list on a device, ``(src, dst)`` int64, read in chunks of
    ``edge_chunk`` edges (GAT's device inference: its per-edge softmax needs
    the edges themselves)."""

    def __init__(self, graph: CSRGraph, device, edge_chunk: int = 1 << 20):
        self.num_nodes = graph.num_nodes
        self.edge_chunk = edge_chunk
        self.src = torch.from_numpy(graph.indices.astype(np.int64)).to(device)
        self.dst = torch.from_numpy(np.repeat(np.arange(graph.num_nodes, dtype=np.int64),
                                              np.diff(graph.indptr))).to(device)

    def chunks(self):
        for i in range(0, self.src.shape[0], self.edge_chunk):
            yield self.src[i:i + self.edge_chunk], self.dst[i:i + self.edge_chunk]


def _gat_device_layer(layer: nn.Module, h: torch.Tensor, edges: _DeviceEdges) -> torch.Tensor:
    """One exact full-neighborhood GAT layer, ``[N, K, H]``, by three scans
    of the edge chunks: the per-destination max of the edge logits
    (``scatter_reduce_`` amax), the softmax denominator and the weighted
    messages (``index_add_``), as the JAX package's XLA scatters compute
    them.  An edge's logit is recomputed in each scan from two gathers."""
    k = layer.a_self.shape[0]
    z = (h @ layer.w).unflatten(1, (k, -1))                  # [N, K, H]
    att_s = torch.einsum("nkh,kh->nk", z, layer.a_self)
    att_n = torch.einsum("nkh,kh->nk", z, layer.a_neigh)

    def logits(s, d):
        return F.leaky_relu(att_s[d] + att_n[s], 0.2)

    e_self = F.leaky_relu(att_s + att_n, 0.2)                # [N, K]
    m = e_self.clone()
    for s, d in edges.chunks():
        m.scatter_reduce_(0, d[:, None].expand(-1, k), logits(s, d), "amax")
    w_self = torch.exp(e_self - m)
    den = w_self.clone()
    for s, d in edges.chunks():
        den.index_add_(0, d, torch.exp(logits(s, d) - m[d]))
    out = (w_self / den)[:, :, None] * z
    for s, d in edges.chunks():
        w = torch.exp(logits(s, d) - m[d]) / den[d]
        out.index_add_(0, d, w[:, :, None] * z[s])
    return out


def _gat_full_graph_device(model: nn.Module, graph: CSRGraph, features: np.ndarray,
                           device: torch.device) -> torch.Tensor:
    edges = _DeviceEdges(graph, device)
    h = torch.from_numpy(np.asarray(features, dtype=np.float32)).to(device)
    last = len(model.layers) - 1
    for li, layer in enumerate(model.layers):
        out = _gat_device_layer(layer, h, edges)
        out = out.mean(dim=1) if li == last else out.flatten(1)
        if hasattr(layer, "skip"):          # the residual form
            out = out + layer.b + layer.skip(h)
        h = out if li == last else F.elu(out)
    return h


def full_graph_logits(model: nn.Module, cfg: ModelConfig, graph: CSRGraph,
                      features: np.ndarray, *, batch_rows: int = 65536,
                      backend: str = "host") -> np.ndarray:
    """Logits of every vertex, f32 ``[N, n_classes]``, from ``model`` on its
    device (GraphSAGE, GCN, CV-GCN, GIN or GAT).  ``backend``: ``"host"``
    (aggregation on the host), ``"device"`` (all of it on the model's
    device: the window reductions on the block kernel; GAT's edge scans on
    library scatters) or ``"auto"`` (device from :data:`AUTO_DEVICE_EDGES`
    edges up)."""
    if cfg.arch not in ("graphsage", "gcn", "gcn_cv", "gin", "gat"):
        raise ValueError(f"unknown arch {cfg.arch!r}")
    if backend == "auto":
        backend = "device" if graph.num_edges >= AUTO_DEVICE_EDGES else "host"
    if backend not in ("host", "device"):
        raise ValueError(f"unknown inference backend {backend!r}")
    dev = next(model.parameters()).device
    with torch.no_grad():
        if cfg.arch == "gat":
            if backend == "host":
                return _gat_full_graph_host(model, graph, np.asarray(features, np.float32))
            return _gat_full_graph_device(model, graph, features, dev).cpu().numpy()
        be = _Host(graph, dev, batch_rows) if backend == "host" else _Device(graph, dev)
        nl = cfg.n_layers
        off = 1 if cfg.preprocess else 0
        skip = cfg.skip_connection or cfg.arch == "gcn_cv"

        def finish(out, gi):
            if gi == nl - 1 and skip:
                return torch.cat([out, torch.relu(out)], dim=1)
            return torch.relu(out) if gi < nl else out

        h = be.tensor(features)
        if cfg.arch in ("gcn", "gcn_cv"):
            # training's mean over the sample; here the sum times the
            # destination's norm, the exact mean (the store's preprocess
            # field is this mean of the features)
            if cfg.preprocess:
                h = finish(be.lin(model.dense, be.aggregate(h, "mean")), 0)
            for li, upd in enumerate(model.updates):
                h = finish(be.lin(upd, be.aggregate(h, "mean")), li + off)
        elif cfg.arch == "gin":
            # training sums over the sampled fan-out; here over every in-neighbor
            for li, upd in enumerate(model.updates):
                pre = (1.0 + upd.eps.to(h.device)) * h + be.aggregate(h, "sum")
                h = finish(be.lin(lambda x, u=upd: u.w2(torch.relu(u.w1(x))), pre), li)
        else:
            if cfg.preprocess:
                # training's neigh field is the full-graph mean aggregate
                h = finish(be.lin(model.pre["self"], h)
                           + be.lin(model.pre["neigh"], be.aggregate(h, "mean")), 0)
            kind = AGG_KIND.get(cfg.aggregator)
            for li, upd in enumerate(model.updates):
                h_agg = (be.lstm(h, model.lstm[li].params()) if cfg.aggregator == "lstm"
                         else be.aggregate(h, kind))
                h = finish(be.lin(upd["self"], h) + be.lin(upd["neigh"], h_agg), li + off)
    return h.cpu().numpy()


def evaluate(model: nn.Module, cfg: ModelConfig, graph: CSRGraph, features: np.ndarray,
             labels: np.ndarray, mask: np.ndarray, *, backend: str = "host") -> float:
    """Accuracy of :func:`full_graph_logits` over the masked vertices."""
    logits = full_graph_logits(model, cfg, graph, features, backend=backend)
    pred = logits.argmax(axis=1)
    sel = np.asarray(mask, dtype=bool)
    return float((pred[sel] == labels[sel]).mean())
