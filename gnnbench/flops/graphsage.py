"""GraphSAGE: two linears a layer (self and neighbor), over the layer's
destination rows."""
from __future__ import annotations

from typing import Sequence


def step_flops(model: dict, layer_rows: Sequence[int]) -> int:
    """FLOPs of one step; ``layer_rows`` the rows of each sampled layer,
    outermost first (``B * prod(f + 1)``, ..., ``B``)."""
    nl, hid = model["n_layers"], model["hidden"]
    ins = [model["feat_dim"]] + [hid] * (nl - 1) + [2 * hid if model["skip_connection"] else hid]
    outs = [hid] * nl + [model["n_classes"]]
    total = 0
    for i, (d_in, d_out) in enumerate(zip(ins, outs)):
        fwd = 2 * 2 * layer_rows[i + 1] * d_in * d_out
        total += fwd * (2 if i == 0 else 3)
    return total
