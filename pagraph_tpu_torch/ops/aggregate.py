"""Block aggregation ops (the port of ``pagraph_tpu/ops/aggregate.py``).

Blocks are fixed-shape ``(cap_dst, fanout)`` index matrices, so
"copy_src + segment-reduce" is a gather followed by a masked reduction over
the fan-out axis.  On host-sampled blocks both run fused in one CUDA kernel
(``gather_kernels.GatherReduce``), and the destination's own row is a CUDA
row gather (``gather_kernels.GatherRows``); both train through their
scatter-add backward kernels.  Prefix-layout blocks need no gather: their
neighbor messages are a contiguous slice.
"""
from __future__ import annotations

import torch

from ..sampling.block import Block
from .gather_kernels import GatherReduce, GatherRows, reduce_msgs_plain


def block_self(h_src: torch.Tensor, block: Block) -> torch.Tensor:
    """Representation of each dst vertex itself: [cap_dst, D]."""
    if block.prefix_layout:
        return h_src[:block.cap_dst]
    return GatherRows.apply(h_src.contiguous(), block.self_pos)


def _neigh_msgs(h_src: torch.Tensor, block: Block) -> torch.Tensor:
    """Prefix layout only: neighbor messages [cap_dst, fanout, D] are the
    contiguous slice after the dst prefix (no gather; backward is a pad)."""
    n, f = block.cap_dst, block.fanout
    return h_src[n:n + n * f].reshape(n, f, *h_src.shape[1:])


def block_aggregate(h_src: torch.Tensor, block: Block,
                    kind: str = "mean") -> torch.Tensor:
    """Masked neighbor aggregation: [cap_src, D] -> [cap_dst, D].

    kind: 'mean' | 'sum'.  Vertices with zero valid neighbors get a zero
    vector (DGL's empty-mailbox default).  'max' waits for the pool
    aggregator's kernel.
    """
    if kind == "max":
        raise NotImplementedError(
            "the 'max' kind (pool aggregator) is not ported yet: it needs "
            "K2's max kind with an argmax backward (ROADMAP queue 1)")
    if kind not in ("mean", "sum"):
        raise ValueError(f"unknown aggregation kind {kind!r}")
    if block.prefix_layout:
        return reduce_msgs_plain(_neigh_msgs(h_src, block), block.neigh_mask, kind)
    return GatherReduce.apply(h_src.contiguous(), block.neigh_pos,
                              block.neigh_mask, kind)
