"""GraphSAGE for neighbor-sampled minibatch training (the port of
``pagraph_tpu/models/sage.py``).

Per layer: ``fc_self(h_dst) + fc_neigh(agg(h_neighbors))`` with
Xavier-uniform (relu gain) weights; the last hidden layer applies the
width-doubling ``cat((h, relu(h)))`` skip.  Layer i+1 of a minibatch is
reachable from layer i through ``self_pos``, so each model layer costs one
block: one fused forward launch for its self rows and its aggregation, and
(where the block's source needs a gradient) one fused backward launch for
both (``ops.aggregate.block_gather``); on the on-device sampler's
prefix-layout blocks the layer's dropout joins both launches
(``models.common.dropout_gather``), its keep-mask drawn by one more; under
``preprocess`` by ``torch.randint``, as layer 0's dropout is.

Aggregators: ``mean``, ``gcn`` (sum), ``pool`` (max, the same fused
launches) and ``lstm`` (one LSTM a block, ``ops.aggregate.lstm_reduce``,
over messages from one row-gather launch).  ``preprocess=True`` consumes
the store's pre-aggregated ``neigh`` field at layer 0 through the ``pre``
update (``self(h) + neigh(neigh_feats)``) and samples one hop less.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import ModelConfig
from ..ops.aggregate import block_gather_msgs, init_lstm_params, lstm_reduce
from ..sampling.block import MiniBatch
from .common import Linear, concat_skip, dropout, dropout_gather

_RELU_GAIN = 1.4142135623730951  # sqrt(2), torch's calculate_gain('relu')

AGG_KIND = {"mean": "mean", "gcn": "sum", "pool": "max"}


def _update(d_in: int, d_out: int, generator) -> nn.ModuleDict:
    return nn.ModuleDict({
        "self": Linear(d_in, d_out, generator=generator, xavier_gain=_RELU_GAIN),
        "neigh": Linear(d_in, d_out, generator=generator, xavier_gain=_RELU_GAIN),
    })


class LSTMParams(nn.Module):
    """One block's LSTM aggregator: ``w_ih [in, 4H]``, ``w_hh [H, 4H]`` and
    ``b [4H]``, the JAX package's layout (``init_lstm_params``)."""

    def __init__(self, in_dim: int, hidden: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        for name, t in init_lstm_params(in_dim, hidden, generator=generator).items():
            setattr(self, name, nn.Parameter(t))

    def params(self):
        return {"w_ih": self.w_ih, "w_hh": self.w_hh, "b": self.b}


class GraphSAGE(nn.Module):
    """``updates[i]`` holds the ``self`` and ``neigh`` linears of block i;
    ``pre`` the preprocess update, ``lstm[i]`` block i's LSTM."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.aggregator not in (*AGG_KIND, "lstm"):
            raise ValueError(f"unknown GraphSAGE aggregator {cfg.aggregator!r}")
        self.cfg = cfg
        # preprocess draws layer 0's dropout through torch: a CUDA graph must
        # not mix that with the blocks' keep-mask kernel (ops.aggregate)
        self.kernel_draws = not cfg.preprocess
        nl, hid = cfg.n_layers, cfg.hidden
        # input dim of each block, as the JAX package's init_params lays
        # them out; the output layer consumes the concat-widened reps unless
        # the skip is disabled
        if cfg.preprocess:
            self.pre = _update(cfg.feat_dim, hid, generator)
            dims = [hid] * (nl - 1)
        else:
            dims = [cfg.feat_dim] + [hid] * (nl - 1)
        dims.append(2 * hid if cfg.skip_connection else hid)
        out_dims = [hid] * (len(dims) - 1) + [cfg.n_classes]
        self.updates = nn.ModuleList()
        self.lstm = nn.ModuleList()
        for d_in, d_out in zip(dims, out_dims):
            self.updates.append(_update(d_in, d_out, generator))
            if cfg.aggregator == "lstm":
                self.lstm.append(LSTMParams(d_in, d_in, generator=generator))

    def forward(self, mb: MiniBatch, feats: torch.Tensor, *,
                generator: Optional[torch.Generator] = None,
                neigh_feats: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits [cap_seed, n_classes] from layer-0 features [cap0, feat_dim]
        (and, under preprocess, the pre-aggregated ``neigh_feats`` of the
        same rows).  Dropout runs in training mode when a ``generator`` is
        given."""
        cfg = self.cfg
        nl = cfg.n_layers
        if len(mb.blocks) != len(self.updates):
            raise ValueError(f"minibatch has {len(mb.blocks)} blocks but the "
                             f"model expects {len(self.updates)}")
        h = feats
        if cfg.preprocess:
            if neigh_feats is None:
                raise ValueError("preprocess mode requires neigh_feats")
            h = dropout(h, cfg.dropout, generator, self.training)
            h = self.pre["self"](h) + self.pre["neigh"](neigh_feats)
            h = concat_skip(h, torch.relu) if nl == 1 and cfg.skip_connection else torch.relu(h)
        off = 1 if cfg.preprocess else 0
        for bi, (block, upd) in enumerate(zip(mb.blocks, self.updates)):
            if cfg.aggregator == "lstm":
                h = dropout(h, cfg.dropout, generator, self.training)
                h_self, msgs = block_gather_msgs(h, block)
                h_neigh = lstm_reduce(msgs, block.neigh_mask, self.lstm[bi].params())
            else:
                h_self, h_neigh = dropout_gather(h, block, AGG_KIND[cfg.aggregator],
                                                 cfg.dropout, generator, self.training,
                                                 kernel_draw=self.kernel_draws)
            out = upd["self"](h_self) + upd["neigh"](h_neigh)
            gi = bi + off
            if gi == nl - 1 and cfg.skip_connection:
                h = concat_skip(out, torch.relu)
            elif gi == nl:
                h = out                       # output layer: raw logits
            else:
                h = torch.relu(out)
        return h
