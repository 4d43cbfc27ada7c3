"""Graph Isomorphism Network for neighbor-sampled minibatch training (the
port of ``pagraph_tpu/models/gin.py``).

Each update is ``w2(relu(w1((1 + eps) * h_self + sum_neighbors(h))))``
with ``eps`` a learnable 0-d parameter (initialized 0, the GIN-eps
variant).  ``n_layers`` hidden updates of width ``hidden``, the
width-doubling ``cat((h, relu(h)))`` skip on the last hidden one unless
``skip_connection=False``, raw logits from the output update.  Training
sums over the sampled fan-out, full-graph inference over every in-neighbor
(``models/inference.py``).  On host-sampled blocks both halves come from
one ``ops.aggregate.block_gather(h, block, "sum")``: one forward launch a
block and one backward launch where the block's source needs a gradient
(the JAX package calls ``block_aggregate`` and ``block_self`` apart; the
arithmetic is the same); on the on-device sampler's prefix-layout blocks
the block's dropout joins both launches (``models.common.dropout_gather``).
``preprocess`` is refused by the config: the store's mean pre-aggregation
has no ``(1 + eps)`` self term.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import ModelConfig
from ..sampling.block import MiniBatch
from .common import Linear, concat_skip, dropout_gather


class GINUpdate(nn.Module):
    """``eps`` (0-d), ``w1`` [in -> hidden] and ``w2`` [hidden -> out]."""

    def __init__(self, d_in: int, hidden: int, d_out: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.eps = nn.Parameter(torch.zeros(()))
        self.w1 = Linear(d_in, hidden, generator=generator)
        self.w2 = Linear(hidden, d_out, generator=generator)

    def forward(self, h_self: torch.Tensor, h_sum: torch.Tensor) -> torch.Tensor:
        return self.w2(torch.relu(self.w1((1.0 + self.eps) * h_self + h_sum)))


class GIN(nn.Module):
    """``updates[i]``: block i's :class:`GINUpdate`."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        nl, hid = cfg.n_layers, cfg.hidden
        dims = [cfg.feat_dim] + [hid] * (nl - 1)
        if nl >= 1:
            dims.append(2 * hid if cfg.skip_connection else hid)
        out_dims = [hid] * nl + [cfg.n_classes]
        self.updates = nn.ModuleList([GINUpdate(d_in, hid, d_out, generator=generator)
                                      for d_in, d_out in zip(dims, out_dims)])

    def forward(self, mb: MiniBatch, feats: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits [cap_seed, n_classes] from layer-0 features [cap0,
        feat_dim]; dropout in training mode when a ``generator`` is given."""
        nl = self.cfg.n_layers
        if len(mb.blocks) != len(self.updates):
            raise ValueError(f"minibatch has {len(mb.blocks)} blocks but the "
                             f"model expects {len(self.updates)}")
        h = feats
        for bi, (block, upd) in enumerate(zip(mb.blocks, self.updates)):
            out = upd(*dropout_gather(h, block, "sum", self.cfg.dropout, generator,
                                      self.training))
            if bi == nl - 1 and self.cfg.skip_connection:
                h = concat_skip(out, torch.relu)
            elif bi == nl:
                h = out                       # output update: raw logits
            else:
                h = torch.relu(out)
        return h
