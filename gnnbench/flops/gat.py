"""GAT (PyG's ``ogbn_products_gat.py``): two linears a layer, the shared
projection over the layer's source rows (every sampled slot a row: no
deduplication) and, with ``residual``, the skip over its destination rows.
The attention's scores and weighted sums are left out, as aggregation is
(a few FLOPs an element beside the matmuls): :func:`attention_bytes`
counts what bounds them instead."""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple


def _layers(model: dict) -> List[Tuple[int, int, int]]:
    """``(in, head width, out)`` of each layer."""
    nl, hid, heads = model["n_layers"], model["hidden"], model["num_heads"]
    ins = [model["feat_dim"]] + [heads * hid] * nl
    return list(zip(ins, [hid] * nl + [model["n_classes"]],
                    [heads * hid] * nl + [model["n_classes"]]))


def step_flops(model: dict, layer_rows: Sequence[int]) -> int:
    """FLOPs of one step; ``layer_rows`` the rows of each sampled layer,
    outermost first (``B * prod(f + 1)``, ..., ``B``)."""
    heads = model["num_heads"]
    total = 0
    for i, (d_in, w, d_out) in enumerate(_layers(model)):
        fwd = 2 * layer_rows[i] * d_in * heads * w
        if model.get("residual", False):
            fwd += 2 * layer_rows[i + 1] * d_in * d_out
        total += fwd * (2 if i == 0 else 3)
    return total


def attention_bytes(model: dict, layer_rows: Sequence[int],
                    valid_slots: Optional[Sequence[int]] = None) -> int:
    """Least bytes of one step's attention kernels (``gat_attention_fwd``
    and ``gat_attention_bwd``, a block each).  A block of ``S`` source
    rows, ``n`` destinations, ``S - n`` neighbor slots of which
    ``valid_slots[i]`` are valid (all of them without ``valid_slots``) and
    ``K`` heads of ``H``: the forward reads the rows of ``z`` (``K*H``
    f32) of the destinations and of the valid slots, the mask (a byte a
    slot) and the attention vectors, and writes its output (``n x K*H``)
    and each row and head's max and denominator; the backward reads the
    same rows of ``z``, the incoming gradient, the forward's output, the
    stats, the mask and the attention vectors, and writes ``z``'s whole
    gradient (``S x K*H``) and the vectors' gradients.  Each once."""
    heads = model["num_heads"]
    total = 0
    for i, (_, w, _) in enumerate(_layers(model)):
        s, n = layer_rows[i], layer_rows[i + 1]
        kh, slots = heads * w, s - n
        read_z = 4 * (n + (slots if valid_slots is None else valid_slots[i])) * kh
        vectors, stats = 4 * 2 * kh, 4 * 2 * n * heads
        fwd = read_z + slots + vectors + 4 * n * kh + stats
        bwd = read_z + 2 * 4 * n * kh + stats + slots + vectors + 4 * s * kh + vectors
        total += fwd + bwd
    return total
