"""PaGraph's sampled GCN (``examples/profile/pa_gcn.py``, after Kipf and
Welling, ICLR'17): each layer is ``W mean(h_u, u sampled) + b`` over the
sampled in-neighbors, dropout on every layer's input, ReLU between layers,
``cat(h, relu(h))`` on the last hidden layer when ``skip_connection``
(PaGraph's ``NodeUpdate(concat=True)``), raw logits out.  Weights ``[in,
out]`` and biases uniform in ``1/sqrt(in)``; leaves ``updates.<layer>.w``
and ``.b``."""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .train import dropout, neighbor_mean


def _dims(m: dict) -> List[Tuple[int, int]]:
    nl, hid = m["n_layers"], m["hidden"]
    ins = [m["feat_dim"]] + [hid] * (nl - 1) + [2 * hid if m["skip_connection"] else hid]
    outs = [hid] * nl + [m["n_classes"]]
    return list(zip(ins, outs))


def param_specs(m: dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    out = []
    for i, (d_in, d_out) in enumerate(_dims(m)):
        out.append((f"updates.{i}.w", (d_in, d_out), 1.0 / math.sqrt(d_in)))
        out.append((f"updates.{i}.b", (d_out,), 1.0 / math.sqrt(d_in)))
    return out


def forward(p: Dict[str, torch.Tensor], layers, x0: torch.Tensor, m: dict,
            block_fanouts: Sequence[int], gen: Optional[torch.Generator]) -> torch.Tensor:
    nl = m["n_layers"]
    h = x0
    for i, f in enumerate(block_fanouts):
        h = dropout(h, m["dropout"], gen)
        n_dst = layers[i + 1][0].shape[0]
        out = neighbor_mean(h, layers[i][1], n_dst, f) @ p[f"updates.{i}.w"] + p[f"updates.{i}.b"]
        if i == nl - 1 and m["skip_connection"]:
            h = torch.cat([out, torch.relu(out)], dim=1)
        elif i == nl:
            h = out
        else:
            h = torch.relu(out)
    return h
