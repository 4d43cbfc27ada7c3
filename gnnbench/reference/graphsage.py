"""GraphSAGE (Hamilton et al., NeurIPS'17) with the mean aggregator, as a
layer of PyG's ``SAGEConv`` computes it: ``h_v' = W_self h_v + b_self +
W_neigh mean(h_u, u sampled) + b_neigh``, ReLU between layers, dropout on
every layer's input, raw logits out.  ``skip_connection`` adds PaGraph's
``cat(h, relu(h))`` on the last hidden layer.  Weights are ``[in, out]``
with Xavier-uniform bounds at ReLU gain, biases uniform in ``1/sqrt(in)``;
leaves are named ``updates.<layer>.self.w`` and so on."""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .train import dropout, neighbor_mean

_RELU_GAIN = math.sqrt(2.0)


def _dims(m: dict) -> List[Tuple[int, int]]:
    nl, hid = m["n_layers"], m["hidden"]
    ins = [m["feat_dim"]] + [hid] * (nl - 1) + [2 * hid if m["skip_connection"] else hid]
    outs = [hid] * nl + [m["n_classes"]]
    return list(zip(ins, outs))


def param_specs(m: dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    out = []
    for i, (d_in, d_out) in enumerate(_dims(m)):
        for half in ("self", "neigh"):
            out.append((f"updates.{i}.{half}.w", (d_in, d_out),
                        _RELU_GAIN * math.sqrt(6.0 / (d_in + d_out))))
            out.append((f"updates.{i}.{half}.b", (d_out,), 1.0 / math.sqrt(d_in)))
    return out


def forward(p: Dict[str, torch.Tensor], layers, x0: torch.Tensor, m: dict,
            block_fanouts: Sequence[int], gen: Optional[torch.Generator]) -> torch.Tensor:
    """Logits of the seeds from layer 0's rows ``x0``; ``layers`` outermost
    first, ``block_fanouts[i]`` the fan-out of layer ``i``'s neighbors."""
    nl = m["n_layers"]
    h = x0
    for i, f in enumerate(block_fanouts):
        h = dropout(h, m["dropout"], gen)
        n_dst = layers[i + 1][0].shape[0]
        agg = neighbor_mean(h, layers[i][1], n_dst, f)
        out = (h[:n_dst] @ p[f"updates.{i}.self.w"] + p[f"updates.{i}.self.b"]
               + agg @ p[f"updates.{i}.neigh.w"] + p[f"updates.{i}.neigh.b"])
        if i == nl - 1 and m["skip_connection"]:
            h = torch.cat([out, torch.relu(out)], dim=1)
        elif i == nl:
            h = out
        else:
            h = torch.relu(out)
    return h
