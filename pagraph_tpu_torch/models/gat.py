"""Graph Attention Network for neighbor-sampled minibatch training (the port
of ``pagraph_tpu/models/gat.py``).

Per block and head (Velickovic et al., ICLR'18)::

    e_ij    = LeakyReLU(a_self . z_i + a_neigh . z_j),   z = h @ w
    alpha_i = softmax over j in N(i) + {i}   (masked slots excluded)
    h_i'    = sum_j alpha_ij z_j             (the self edge included)

The softmax over the sampled neighbors and the self edge is the JAX
package's two-part stable form: the self edge stays out of the
``[cap_dst, F, K]`` neighbor tensors, masked slots hold ``-1e30``, so their
``exp`` is exactly 0 in f32 and in bf16.  Hidden layers concatenate the
``num_heads`` heads through an ELU; the output layer averages them into
logits.

On host-sampled blocks a block's rows come from one row-gather launch
(``ops.aggregate.block_gather_msgs``) of the table ``[z | att_s | att_n]``
(``K*H + 2K`` columns: 264 at 4 heads of 64), flattened to 2-D, whose
backward is one ``scatter_add_rows`` launch; block 0 needs it too, since
``z`` depends on ``w``.  On prefix-layout blocks (the on-device path) the
self rows and the messages are slices.  ``preprocess`` is refused by the
config: attention needs each neighbor's own features.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..config import ModelConfig
from ..ops.aggregate import block_gather_msgs
from ..sampling.block import Block, MiniBatch
from .common import _uniform, dropout

_NEG = -1e30


class GATLayer(nn.Module):
    """``w [in, K*H]``, ``a_self`` and ``a_neigh [K, H]``, with the JAX
    package's uniform init."""

    def __init__(self, in_dim: int, heads: int, head_dim: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        bound = math.sqrt(6.0 / (in_dim + heads * head_dim))
        ab = math.sqrt(6.0 / (head_dim + 1))
        self.w = nn.Parameter(_uniform((in_dim, heads * head_dim), bound, generator))
        self.a_self = nn.Parameter(_uniform((heads, head_dim), ab, generator))
        self.a_neigh = nn.Parameter(_uniform((heads, head_dim), ab, generator))

    def forward(self, h_src: torch.Tensor, block: Block) -> torch.Tensor:
        """One attention block: ``[cap_src, in] -> [cap_dst, K, H]``."""
        heads, hd = self.a_self.shape
        kh = heads * hd
        n, f = block.cap_dst, block.fanout
        z = h_src @ self.w                                   # [S, K*H]
        z3 = z.unflatten(1, (heads, hd))
        att_s = torch.einsum("nkh,kh->nk", z3, self.a_self)  # [S, K]
        att_n = torch.einsum("nkh,kh->nk", z3, self.a_neigh)
        if block.prefix_layout:          # slices, no gather
            z_self, as_dst, an_dst = z3[:n], att_s[:n], att_n[:n]
            z_neigh = z3[n:n + n * f].unflatten(0, (n, f))
            an_nbr = att_n[n:n + n * f].unflatten(0, (n, f))
        else:
            rows, msgs = block_gather_msgs(torch.cat([z, att_s, att_n], dim=1), block)
            z_self = rows[:, :kh].unflatten(1, (heads, hd))
            as_dst, an_dst = rows[:, kh:kh + heads], rows[:, kh + heads:]
            z_neigh = msgs[..., :kh].unflatten(-1, (heads, hd))   # [n, F, K, H]
            an_nbr = msgs[..., kh + heads:]                      # [n, F, K]
        e_n = F.leaky_relu(as_dst[:, None, :] + an_nbr, 0.2)
        e_s = F.leaky_relu(as_dst + an_dst, 0.2)
        e_n = torch.where(block.neigh_mask[..., None], e_n, _NEG)
        m = torch.maximum(e_n.amax(dim=1), e_s)              # [n, K]
        w_n = torch.exp(e_n - m[:, None, :])
        w_s = torch.exp(e_s - m)
        denom = w_n.sum(dim=1) + w_s
        alpha_n = w_n / denom[:, None, :]
        alpha_s = w_s / denom
        return torch.einsum("nfk,nfkh->nkh", alpha_n, z_neigh) + alpha_s[..., None] * z_self


class GAT(nn.Module):
    """``layers[i]``: block i's :class:`GATLayer`; ``n_layers`` hidden
    layers of ``num_heads`` heads of width ``hidden``, then the output
    layer's heads of width ``n_classes``."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        heads = cfg.num_heads
        dims = [cfg.feat_dim] + [heads * cfg.hidden] * cfg.n_layers
        widths = [cfg.hidden] * cfg.n_layers + [cfg.n_classes]
        self.layers = nn.ModuleList([GATLayer(d, heads, w, generator=generator)
                                     for d, w in zip(dims, widths)])

    def forward(self, mb: MiniBatch, feats: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits [cap_seed, n_classes] from layer-0 features [cap0,
        feat_dim]; dropout in training mode when a ``generator`` is given."""
        if len(mb.blocks) != len(self.layers):
            raise ValueError(f"minibatch has {len(mb.blocks)} blocks but the "
                             f"model expects {len(self.layers)}")
        h = feats
        last = len(self.layers) - 1
        for bi, (block, layer) in enumerate(zip(mb.blocks, self.layers)):
            h = dropout(h, self.cfg.dropout, generator, self.training)
            out = layer(h, block)                            # [cap_dst, K, dim]
            h = out.mean(dim=1) if bi == last else F.elu(out.flatten(1))
        return h
