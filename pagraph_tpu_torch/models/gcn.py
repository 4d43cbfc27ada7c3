"""GCN for neighbor-sampled minibatch training (the port of
``pagraph_tpu/models/gcn.py``).

Training aggregates the sampled in-neighbors with ``mean``: the neighbor
half of the block kernels alone (``ops.aggregate.block_aggregate``, one
``gather_reduce`` launch a block forward and one ``gather_reduce_bwd``
backward where the block's source needs a gradient; on the on-device
sampler's prefix-layout blocks one fused launch of the block's dropout and
mean each way, ``models.common.dropout_gather``, and one that draws its
keep-mask; under ``preprocess`` ``torch.randint`` draws it, as it draws the
dense layer's dropout).  Inference
(``norm_layers`` given) aggregates with ``sum`` and scales by the
destination's ``norm`` (1/in-degree), the reference's ``GCNInfer`` split.
The last hidden update applies the width-doubling ``cat((h, relu(h)))``
skip unless ``skip_connection=False``; under ``preprocess`` the ``dense``
linear consumes the store's pre-aggregated layer 0 and the sampler expands
one hop less.  Linears have the Kaiming fan-in init (``init_linear``
without ``xavier_gain``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..config import ModelConfig
from ..sampling.block import MiniBatch
from .common import Linear, concat_skip, dropout, dropout_gather


class GCN(nn.Module):
    """``updates[i]``: block i's linear; ``dense``: the preprocess input
    linear."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        # preprocess draws layer 0's dropout through torch: a CUDA graph must
        # not mix that with the blocks' keep-mask kernel (ops.aggregate)
        self.kernel_draws = not cfg.preprocess
        nl, hid = cfg.n_layers, cfg.hidden
        # the JAX package's layout: the linear from the features (``dense``
        # under preprocess, else block 0's), the hidden ones, the output
        # one, whose input the skip doubles
        first = Linear(cfg.feat_dim, hid, generator=generator)
        if cfg.preprocess:
            self.dense = first
        self.updates = nn.ModuleList([] if cfg.preprocess else [first])
        for _ in range(nl - 1):
            self.updates.append(Linear(hid, hid, generator=generator))
        self.updates.append(Linear(2 * hid if cfg.skip_connection else hid, cfg.n_classes,
                                   generator=generator))

    def forward(self, mb: MiniBatch, feats: torch.Tensor, *,
                generator: Optional[torch.Generator] = None,
                norm_layers: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """Logits [cap_seed, n_classes] from layer-0 features [cap0,
        feat_dim].  ``norm_layers`` (each layer's ``[cap_i]`` norms) selects
        the inference form: ``sum`` times the destination's norm, no
        dropout."""
        cfg = self.cfg
        nl = cfg.n_layers
        if len(mb.blocks) != len(self.updates):
            raise ValueError(f"minibatch has {len(mb.blocks)} blocks but the "
                             f"model expects {len(self.updates)}")
        infer = norm_layers is not None
        h = feats
        if cfg.preprocess:
            h = dropout(h, cfg.dropout, generator, self.training)
            h = self.dense(h)
            h = concat_skip(h, torch.relu) if nl == 1 and cfg.skip_connection else torch.relu(h)
        off = 1 if cfg.preprocess else 0
        for bi, (block, upd) in enumerate(zip(mb.blocks, self.updates)):
            _, h_agg = dropout_gather(h, block, "sum" if infer else "mean",
                                      0.0 if infer else cfg.dropout, generator,
                                      self.training, with_self=False,
                                      kernel_draw=self.kernel_draws)
            if infer:
                h_agg = h_agg * norm_layers[bi + 1][:, None]
            out = upd(h_agg)
            gi = bi + off
            if gi == nl - 1 and cfg.skip_connection:
                h = concat_skip(out, torch.relu)
            elif gi == nl:
                h = out                       # output layer: raw logits
            else:
                h = torch.relu(out)
        return h
