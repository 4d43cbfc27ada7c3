"""Control-variate (VR-GCN style) GCN (the port of
``pagraph_tpu/models/gcn_cv.py``).

Per block, the model aggregates the *delta* between the current activations
and a per-vertex history, then adds the full-graph aggregation of that
history: an unbiased, low-variance estimate at small fan-outs.  The history
is explicit state outside the model: the trainer gathers each block's
history slices for the batch, the forward returns the fresh activations
(detached), and the trainer scatters them back and refreshes the aggregated
histories with an exact full-graph mean.  On the host path that state is
:class:`CVHistory` (numpy arrays, refreshed by the host library's SpMM);
on the device path it is device tensors (``train/device_epoch.py``).

Layer 0 consumes the store's *pre-aggregated* features (``preprocess=True``
is required) through the ``dense`` linear, so the sampler expands
``n_layers`` hops.  The block aggregation of ``delta`` is
``ops.aggregate.block_aggregate(..., "mean")``: on host-sampled blocks one
``gather_reduce`` launch forward and one ``gather_reduce_bwd`` backward a
block (every block's source needs a gradient: block 0's through
``dense``).  The output layer always consumes the concat-skip's doubled
width, whatever ``skip_connection`` says, as in the JAX package.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..config import ModelConfig
from ..graph import CSRGraph
from ..ops.aggregate import block_aggregate
from ..sampling.block import MiniBatch
from ..utils.device import resolve_device
from .common import Linear, concat_skip, dropout


def layer_widths(cfg: ModelConfig) -> List[int]:
    """Activation width entering each block b = 0..n_layers-1."""
    nl, h = cfg.n_layers, cfg.hidden
    return [(2 * h if i == nl - 1 else h) for i in range(nl)]


class GCNCV(nn.Module):
    """``dense``: the preprocess input linear; ``updates[i]``: block i's
    linear (the last one from the doubled width to the classes)."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not cfg.preprocess:
            raise ValueError("gcn_cv requires preprocess=True (reference contract)")
        self.cfg = cfg
        nl, hid = cfg.n_layers, cfg.hidden
        self.dense = Linear(cfg.feat_dim, hid, generator=generator)
        self.updates = nn.ModuleList([Linear(hid, hid, generator=generator)
                                      for _ in range(1, nl)])
        self.updates.append(Linear(2 * hid, cfg.n_classes, generator=generator))

    def forward(self, mb: MiniBatch, feats: torch.Tensor, *,
                generator: Optional[torch.Generator] = None,
                h_hist: Sequence[torch.Tensor] = (),
                agg_hist: Sequence[torch.Tensor] = (),
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """``(logits, new_hists)`` from the pre-aggregated layer-0 features
        ``[cap_0, feat_dim]``, each block's history at its source layer
        ``h_hist[b] [cap_b, w_b]`` and its aggregated history at its
        destination layer ``agg_hist[b] [cap_{b+1}, w_b]``.
        ``new_hists[b]`` is the fresh activation at layer b, detached."""
        nl = self.cfg.n_layers
        if not len(mb.blocks) == len(self.updates) == nl:
            raise ValueError(f"minibatch has {len(mb.blocks)} blocks but the "
                             f"model expects {nl}")
        rate, train = self.cfg.dropout, self.training
        h = dropout(feats, rate, generator, train)
        h = self.dense(h)
        h = concat_skip(h, torch.relu) if nl == 1 else torch.relu(h)
        new_hists: List[torch.Tensor] = []
        for b, (block, upd) in enumerate(zip(mb.blocks, self.updates)):
            new_hists.append(h.detach())
            h_agg = block_aggregate(h - h_hist[b], block, "mean") + agg_hist[b]
            h = upd(dropout(h_agg, rate, generator, train))
            if b + 1 == nl - 1:                 # the reference's layer id
                h = concat_skip(h, torch.relu)
            elif b + 1 < nl:
                h = torch.relu(h)
        return h, new_hists


class CVHistory:
    """The host path's per-block history store and its exact aggregates.

    ``hist[b]``: ``[N, w_b]`` f32, the activations last seen at layer b;
    ``agg[b]``: ``[N, w_b]``, the full-graph mean aggregation of
    ``hist[b]``, refreshed by :meth:`refresh_agg` (once an epoch)."""

    def __init__(self, cfg: ModelConfig, graph: CSRGraph, num_nodes: int):
        self.cfg = cfg
        self.graph = graph
        self.widths = layer_widths(cfg)
        self.hist = [np.zeros((num_nodes, w), dtype=np.float32) for w in self.widths]
        self.agg = [np.zeros((num_nodes, w), dtype=np.float32) for w in self.widths]

    def gather(self, mb: MiniBatch, device=None):
        """``(h_hist, agg_hist)``, the batch's slices for the forward, as
        tensors on ``device`` (``None``: the GPU, ``RuntimeError`` without
        one)."""
        device = resolve_device(device)

        def put(x: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(x).to(device)

        ids = [np.asarray(x) for x in mb.layer_nids]
        return ([put(self.hist[b][ids[b]]) for b in range(len(self.hist))],
                [put(self.agg[b][ids[b + 1]]) for b in range(len(self.agg))])

    def scatter(self, mb: MiniBatch, new_hists: Sequence[torch.Tensor]) -> None:
        """Write each valid row's fresh activation; the last occurrence of
        a repeated id wins."""
        for b, nh in enumerate(new_hists):
            ids = np.asarray(mb.layer_nids[b])
            mask = np.asarray(mb.layer_mask[b])
            self.hist[b][ids[mask]] = nh.detach().cpu().numpy()[mask]

    def refresh_agg(self) -> None:
        from ..storage.feature_store import full_graph_mean_aggregate

        for b in range(len(self.hist)):
            self.agg[b] = full_graph_mean_aggregate(self.graph, self.hist[b])
