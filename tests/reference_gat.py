"""A plain-PyTorch reference of the port's GAT (``models/gat.py``) for the
CPU tests: it imports torch alone (no JAX, no ``pagraph_tpu``, no kernel or
module of the port) and computes at its inputs' dtype, float32 or float64,
with TF32 off.

Per layer and head, with ``z = h @ w``::

    e_ij  = LeakyReLU_0.2(a_self . z_i + a_neigh . z_j),  j in N(i) + {i}
    out_i = sum_j softmax_j(e_ij) z_j

the heads concatenated through an ELU, or at the last layer averaged into
the logits.  ``residual`` (PyG's ``examples/ogbn_products_gat.py``) adds a
bias and a linear skip of the destination rows before the ELU.  Dropout
(rate ``dropout``, with a generator) falls on every layer's input, layer
0's only with ``feature_dropout``.

A block is ``(self_idx [n], nbr_idx [n, F], mask [n, F])``: indices into
the block's input rows, of each destination and of its slots, and the
slots' validity.  The softmax is ``torch.softmax`` over the self loop and
the valid slots (``-inf`` elsewhere), not the program's two-part form.
Dropout is the program's draw, in the program's order: a unit is kept iff
one ``torch.randint(0, 65536)`` int32 draw of the input's shape from the
generator is below ``round((1 - rate) * 65536)``, kept units scaled by
``1 / (1 - rate)``.  Leaves: ``layers.<i>.w [in, K*H]``, ``a_self``,
``a_neigh [K, H]``; with ``residual`` ``b [out]``, ``skip.w [in, out]``,
``skip.b [out]``."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.nn import functional as F


def dims(model: dict) -> List[Tuple[int, int, int]]:
    """``(in, head width, out)`` of each layer."""
    nl, hid, heads = model["n_layers"], model["hidden"], model["num_heads"]
    return list(zip([model["feat_dim"]] + [heads * hid] * nl,
                    [hid] * nl + [model["n_classes"]],
                    [heads * hid] * nl + [model["n_classes"]]))


def init_params(model: dict, gen: torch.Generator,
                dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Every leaf uniform in ``(-0.5, 0.5)`` (biases nonzero, so their
    gradients and the skip's are exercised)."""
    heads, out = model["num_heads"], {}
    for i, (d_in, w, d_out) in enumerate(dims(model)):
        shapes = {"w": (d_in, heads * w), "a_self": (heads, w), "a_neigh": (heads, w)}
        if model.get("residual", False):
            shapes.update({"b": (d_out,), "skip.w": (d_in, d_out), "skip.b": (d_out,)})
        for k, shape in shapes.items():
            out[f"layers.{i}.{k}"] = (torch.rand(shape, generator=gen) - 0.5).to(dtype)
    return out


def dropout(x: torch.Tensor, rate: float, gen: Optional[torch.Generator]) -> torch.Tensor:
    if rate == 0.0 or gen is None:
        return x
    keep = 1.0 - rate
    bits = torch.randint(0, 1 << 16, x.shape, generator=gen, dtype=torch.int32)
    return torch.where(bits < min(int(round(keep * 65536.0)), 65535), x * (1.0 / keep),
                       torch.zeros((), dtype=x.dtype))


def attention(z: torch.Tensor, self_idx, nbr_idx, mask, a_self, a_neigh) -> torch.Tensor:
    """``[n, K, H]`` from ``z [S, K, H]``: each destination's softmax over its
    self loop and its valid slots, the weighted sum of their rows."""
    cand = torch.cat([z[self_idx][:, None], z[nbr_idx]], 1)            # [n, 1 + F, K, H]
    e = F.leaky_relu((z[self_idx] * a_self).sum(-1)[:, None] + (cand * a_neigh).sum(-1), 0.2)
    valid = torch.cat([torch.ones_like(mask[:, :1]), mask], 1)
    alpha = torch.softmax(e.masked_fill(~valid[..., None], float("-inf")), dim=1)
    return (alpha[..., None] * cand).sum(1)


def forward(p: Dict[str, torch.Tensor], blocks: Sequence[tuple], x0: torch.Tensor,
            model: dict, gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Logits ``[n of the last block, n_classes]`` from layer 0's rows
    ``x0``; dropout only with ``gen``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    heads, last = model["num_heads"], len(blocks) - 1
    h = x0
    for i, (self_idx, nbr_idx, mask) in enumerate(blocks):
        if i > 0 or model.get("feature_dropout", True):
            h = dropout(h, model["dropout"], gen)
        self_idx, nbr_idx = self_idx.long(), nbr_idx.long()
        z = (h @ p[f"layers.{i}.w"]).unflatten(1, (heads, -1))
        att = attention(z, self_idx, nbr_idx, mask.bool(), p[f"layers.{i}.a_self"],
                        p[f"layers.{i}.a_neigh"])
        out = att.mean(1) if i == last else att.flatten(1)
        if model.get("residual", False):
            out = (out + p[f"layers.{i}.b"] + h[self_idx] @ p[f"layers.{i}.skip.w"]
                   + p[f"layers.{i}.skip.b"])
        h = out if i == last else F.elu(out)
    return h


def full_graph_blocks(indptr, indices, layers: int) -> List[tuple]:
    """``layers`` blocks of every vertex over all its in-neighbors (full-
    graph inference): the slots padded to the largest in-degree."""
    n = len(indptr) - 1
    deg = [int(indptr[v + 1] - indptr[v]) for v in range(n)]
    f = max(max(deg), 1)
    nbr = torch.zeros((n, f), dtype=torch.long)
    mask = torch.zeros((n, f), dtype=torch.bool)
    for v in range(n):
        nbr[v, :deg[v]] = torch.as_tensor(indices[indptr[v]:indptr[v + 1]], dtype=torch.long)
        mask[v, :deg[v]] = True
    return [(torch.arange(n), nbr, mask)] * layers
