"""GAT as PyG's ``examples/ogbn_products_gat.py`` builds it: each layer a
``GATConv`` (one projection ``lin`` without bias shared by sources and
destinations, ``att_src`` and ``att_dst`` of ``[heads, out]``, LeakyReLU at
0.2 on the edge logits, a softmax over each destination's sampled in-edges
and its self loop, no attention dropout, the heads concatenated or, at the
last layer, averaged, then a bias) plus a ``Linear`` skip of the
destination rows; ELU and then dropout after every layer but the last;
raw logits out (the loss takes their ``log_softmax``).  Per layer and
head, with ``z = h @ w``::

    e_ij = LeakyReLU(a_self . z_i + a_neigh . z_j),   j in N(i) + {i}
    out_i = sum_j softmax_j(e_ij) z_j  (+ b + h_i @ skip.w + skip.b)

Without ``residual`` (the JAX package's GAT) there is no bias and no skip;
``feature_dropout`` (default true) also drops layer 0's input, which PyG's
example does not.

Departures from PyG, each the program's: a layer's destinations are the
first rows of its input and every sampled slot is a row of its own (no
deduplication: PyG projects each distinct node once), so a sampled
self-loop edge stays a neighbor slot beside the self loop; neighbors are
drawn with replacement where the in-degree passes the fan-out
(``reference/sampler.py``); the initial leaves are uniform in the bounds of
:func:`param_specs`, not PyG's glorot and zeros.

Leaves: ``layers.<i>.w [in, K*H]``, ``layers.<i>.a_self`` (``att_dst``)
and ``layers.<i>.a_neigh`` (``att_src``) ``[K, H]``; with ``residual``
``layers.<i>.b [out]``, ``layers.<i>.skip.w [in, out]``,
``layers.<i>.skip.b [out]``."""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.nn import functional as F

from .train import dropout

SLOPE = 0.2


def _dims(m: dict) -> List[Tuple[int, int, int]]:
    """``(in, head width, out)`` of each layer."""
    nl, hid, heads = m["n_layers"], m["hidden"], m["num_heads"]
    ins = [m["feat_dim"]] + [heads * hid] * nl
    widths = [hid] * nl + [m["n_classes"]]
    outs = [heads * hid] * nl + [m["n_classes"]]
    return list(zip(ins, widths, outs))


def param_specs(m: dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    heads = m["num_heads"]
    out = []
    for i, (d_in, w, d_out) in enumerate(_dims(m)):
        out.append((f"layers.{i}.w", (d_in, heads * w), math.sqrt(6.0 / (d_in + heads * w))))
        for a in ("a_self", "a_neigh"):
            out.append((f"layers.{i}.{a}", (heads, w), math.sqrt(6.0 / (w + 1))))
        if m.get("residual", False):
            bound = 1.0 / math.sqrt(d_in)
            out += [(f"layers.{i}.b", (d_out,), bound),
                    (f"layers.{i}.skip.w", (d_in, d_out), bound),
                    (f"layers.{i}.skip.b", (d_out,), bound)]
    return out


def attention(z: torch.Tensor, n: int, slots: torch.Tensor, a_dst: torch.Tensor,
              a_src: torch.Tensor) -> torch.Tensor:
    """``[n, K, H]``: each destination's softmax over its self loop and its
    valid slots (``slots`` bool ``[n, F]``, the rows ``n + r * F + k`` of
    ``z [S, K, H]``), the weighted sum of their ``z``."""
    f = slots.shape[1]
    z_dst, z_nbr = z[:n], z[n:n + n * f].reshape(n, f, *z.shape[1:])
    dst = (z_dst * a_dst).sum(-1)                                     # [n, K]
    src = torch.cat([(z_dst * a_src).sum(-1)[:, None], (z_nbr * a_src).sum(-1)], 1)
    e = F.leaky_relu(dst[:, None] + src, SLOPE)                       # [n, 1 + F, K]
    valid = torch.cat([torch.ones_like(slots[:, :1]), slots], 1)
    alpha = torch.softmax(e.masked_fill(~valid[..., None], float("-inf")), dim=1)
    return alpha[:, 0, :, None] * z_dst + (alpha[:, 1:, :, None] * z_nbr).sum(1)


def forward(p: Dict[str, torch.Tensor], layers, x0: torch.Tensor, m: dict,
            block_fanouts: Sequence[int], gen: Optional[torch.Generator]) -> torch.Tensor:
    """Logits of the seeds from layer 0's rows ``x0``; ``layers`` outermost
    first, ``block_fanouts[i]`` the fan-out of layer ``i``'s neighbors."""
    nl, heads = m["n_layers"], m["num_heads"]
    h = x0
    for i, f in enumerate(block_fanouts):
        if i > 0 or m.get("feature_dropout", True):
            h = dropout(h, m["dropout"], gen)
        n_dst = layers[i + 1][0].shape[0]
        slots = layers[i][1][n_dst:n_dst + n_dst * f].reshape(n_dst, f)
        z = (h @ p[f"layers.{i}.w"]).unflatten(1, (heads, -1))
        att = attention(z, n_dst, slots, p[f"layers.{i}.a_self"], p[f"layers.{i}.a_neigh"])
        out = att.mean(1) if i == nl else att.flatten(1)
        if m.get("residual", False):
            out = (out + p[f"layers.{i}.b"] + h[:n_dst] @ p[f"layers.{i}.skip.w"]
                   + p[f"layers.{i}.skip.b"])
        h = out if i == nl else F.elu(out)
    return h
