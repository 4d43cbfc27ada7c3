"""GraphSAGE for neighbor-sampled minibatch training (the port of
``pagraph_tpu/models/sage.py``).

Per layer: ``fc_self(h_dst) + fc_neigh(agg(h_neighbors))`` with
Xavier-uniform (relu gain) weights; the last hidden layer applies the
width-doubling ``cat((h, relu(h)))`` skip.  Layer i+1 of a minibatch is
reachable from layer i through ``self_pos``, so each model layer costs one
block: one fused forward launch for its self rows and its aggregation, and
(where the block's source needs a gradient) one fused backward launch for
both (``ops.aggregate.block_gather``).

Aggregators: ``mean`` and ``gcn`` (sum).  ``pool``, ``lstm`` and
``preprocess`` are not ported yet (ROADMAP queue 1).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import ModelConfig
from ..ops.aggregate import block_gather
from ..sampling.block import MiniBatch
from .common import Linear, concat_skip, dropout

_RELU_GAIN = 1.4142135623730951  # sqrt(2), torch's calculate_gain('relu')

_AGG_KIND = {"mean": "mean", "gcn": "sum"}


class GraphSAGE(nn.Module):
    """``updates[i]`` holds the ``self`` and ``neigh`` linears of block i."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.preprocess:
            raise NotImplementedError(
                "GraphSAGE preprocess mode is not ported yet (ROADMAP queue 1)")
        if cfg.aggregator not in _AGG_KIND:
            raise NotImplementedError(
                f"GraphSAGE aggregator {cfg.aggregator!r} is not ported yet "
                "(ROADMAP queue 1); the port has 'mean' and 'gcn'")
        self.cfg = cfg
        nl, hid = cfg.n_layers, cfg.hidden
        # input dim of each block; the output layer consumes the
        # concat-widened reps unless the skip is disabled
        dims = [cfg.feat_dim] + [hid] * (nl - 1)
        dims.append(2 * hid if cfg.skip_connection else hid)
        out_dims = [hid] * (len(dims) - 1) + [cfg.n_classes]
        self.updates = nn.ModuleList(
            nn.ModuleDict({
                "self": Linear(d_in, d_out, generator=generator,
                               xavier_gain=_RELU_GAIN),
                "neigh": Linear(d_in, d_out, generator=generator,
                                xavier_gain=_RELU_GAIN),
            })
            for d_in, d_out in zip(dims, out_dims)
        )

    def forward(self, mb: MiniBatch, feats: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits [cap_seed, n_classes] from layer-0 features [cap0, feat_dim].
        Dropout runs in training mode when a ``generator`` is given."""
        cfg = self.cfg
        if len(mb.blocks) != len(self.updates):
            raise ValueError(f"minibatch has {len(mb.blocks)} blocks but the "
                             f"model expects {len(self.updates)}")
        kind = _AGG_KIND[cfg.aggregator]
        h = feats
        for bi, (block, upd) in enumerate(zip(mb.blocks, self.updates)):
            h = dropout(h, cfg.dropout, generator, self.training)
            h_self, h_neigh = block_gather(h, block, kind)
            out = upd["self"](h_self) + upd["neigh"](h_neigh)
            if bi == cfg.n_layers - 1 and cfg.skip_connection:
                h = concat_skip(out, torch.relu)
            elif bi == cfg.n_layers:
                h = out                       # output layer: raw logits
            else:
                h = torch.relu(out)
        return h
