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
logits.  Dropout falls on every layer's input.

``model.residual`` gives the layer form of PyG's
``examples/ogbn_products_gat.py`` (``GATConv`` with a bias, plus a
``Linear`` skip of the destination rows, before the ELU)::

    h_i' = ELU(concat_k(sum_j alpha_ij z_j) + b + h_i @ skip.w + skip.b)

(the output layer: the heads' mean, then the same sums, no ELU), and
``model.feature_dropout=False`` leaves layer 0's input, the features,
undropped; the hidden layers' inputs are still dropped after the ELU.

On host-sampled blocks a block's rows come from one row-gather launch
(``ops.aggregate.block_gather_msgs``) of the table ``[z | att_s | att_n]``
(``K*H + 2K`` columns: 264 at 4 heads of 64), flattened to 2-D, whose
backward is one ``scatter_add_rows`` launch; block 0 needs it too, since
``z`` depends on ``w`` (the residual form's skip gathers the destination
rows of ``h`` once more).  On prefix-layout blocks (the on-device path)
the self rows and the messages are slices, and at f32 the attention is
one kernel forward and one backward (``ops.aggregate.gat_attention``: both
scores, the softmax and the weighted sum from one read of ``z``; on the
card it raises for heads wider than the kernels take); at bf16 compute
those blocks keep the plain chain.  ``preprocess`` is refused by
the config: attention needs each neighbor's own features.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..config import ModelConfig
from ..ops.aggregate import block_gather_msgs, block_self, gat_attention
from ..ops.gather_kernels import gat_attention_fwd_plain, gat_softmax_plain
from ..sampling.block import Block, MiniBatch
from .common import Linear, _uniform, dropout


class GATLayer(nn.Module):
    """``w [in, K*H]``, ``a_self`` and ``a_neigh [K, H]``, with the JAX
    package's uniform init; with ``out_dim`` (the residual form) also ``b
    [out_dim]`` (zeros, as ``GATConv``'s) and ``skip`` (``Linear(in,
    out_dim)``: ``skip.w``, ``skip.b``), which :class:`GAT` adds."""

    def __init__(self, in_dim: int, heads: int, head_dim: int, *,
                 generator: Optional[torch.Generator] = None, out_dim: Optional[int] = None):
        super().__init__()
        bound = math.sqrt(6.0 / (in_dim + heads * head_dim))
        ab = math.sqrt(6.0 / (head_dim + 1))
        self.w = nn.Parameter(_uniform((in_dim, heads * head_dim), bound, generator))
        self.a_self = nn.Parameter(_uniform((heads, head_dim), ab, generator))
        self.a_neigh = nn.Parameter(_uniform((heads, head_dim), ab, generator))
        if out_dim is not None:
            self.b = nn.Parameter(torch.zeros(out_dim))
            self.skip = Linear(in_dim, out_dim, generator=generator)

    def forward(self, h_src: torch.Tensor, block: Block) -> torch.Tensor:
        """One attention block: ``[cap_src, in] -> [cap_dst, K, H]``."""
        heads, hd = self.a_self.shape
        kh = heads * hd
        z = h_src @ self.w                                   # [S, K*H]
        if block.prefix_layout:          # slices, no gather
            if z.dtype == torch.float32:
                return gat_attention(z, self.a_self, self.a_neigh, block)
            return gat_attention_fwd_plain(z, self.a_self, self.a_neigh, block.neigh_mask)[0]
        z3 = z.unflatten(1, (heads, hd))
        att_s = torch.einsum("nkh,kh->nk", z3, self.a_self)  # [S, K]
        att_n = torch.einsum("nkh,kh->nk", z3, self.a_neigh)
        rows, msgs = block_gather_msgs(torch.cat([z, att_s, att_n], dim=1), block)
        z_self = rows[:, :kh].unflatten(1, (heads, hd))
        as_dst, an_dst = rows[:, kh:kh + heads], rows[:, kh + heads:]
        z_neigh = msgs[..., :kh].unflatten(-1, (heads, hd))   # [n, F, K, H]
        an_nbr = msgs[..., kh + heads:]                      # [n, F, K]
        return gat_softmax_plain(z_self, z_neigh, as_dst, an_dst, an_nbr,
                                 block.neigh_mask)[0]


class GAT(nn.Module):
    """``layers[i]``: block i's :class:`GATLayer`; ``n_layers`` hidden
    layers of ``num_heads`` heads of width ``hidden``, then the output
    layer's heads of width ``n_classes``; with ``cfg.residual`` each with
    its bias and skip (``layers.<i>.b``, ``layers.<i>.skip.w``,
    ``layers.<i>.skip.b``)."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        heads = cfg.num_heads
        dims = [cfg.feat_dim] + [heads * cfg.hidden] * cfg.n_layers
        widths = [cfg.hidden] * cfg.n_layers + [cfg.n_classes]
        outs = [heads * cfg.hidden] * cfg.n_layers + [cfg.n_classes]
        self.layers = nn.ModuleList([
            GATLayer(d, heads, w, generator=generator, out_dim=o if cfg.residual else None)
            for d, w, o in zip(dims, widths, outs)])

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
            if bi > 0 or self.cfg.feature_dropout:
                h = dropout(h, self.cfg.dropout, generator, self.training)
            out = layer(h, block)                            # [cap_dst, K, dim]
            out = out.mean(dim=1) if bi == last else out.flatten(1)
            if self.cfg.residual:
                out = out + layer.b + layer.skip(block_self(h, block))
            h = out if bi == last else F.elu(out)
        return h
