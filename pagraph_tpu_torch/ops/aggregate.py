"""Block aggregation ops (the port of ``pagraph_tpu/ops/aggregate.py``).

Blocks are fixed-shape ``(cap_dst, fanout)`` index matrices, so
"copy_src + segment-reduce" is a gather followed by a masked reduction over
the fan-out axis.  On host-sampled blocks :func:`block_gather` gathers a
block's self rows and reduces its neighbor rows in one CUDA launch, and its
backward adds both gradients into the source table in one more
(``gather_kernels.BlockGather``); :func:`block_self` and
:func:`block_aggregate`, the counterparts of the JAX functions, do one half
each (the same forward kernel with the other half absent).
Prefix-layout blocks, which the on-device sampler
(``sampling/device_sampler.py``) produces, need no gather: a block's self
rows and its neighbor messages are contiguous slices, reduced in plain torch
(the JAX package reduces them with XLA, not Pallas).  Every function here
computes at its input's dtype: f32, or bf16 under ``train.dtype="bfloat16"``
(the kernels take both).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..sampling.block import Block
from .gather_kernels import (BlockGather, GatherReduce, GatherRows,
                             reduce_msgs_plain)


def _check_kind(kind: str) -> None:
    if kind == "max":
        raise NotImplementedError(
            "the 'max' kind (pool aggregator) is not ported yet: it needs "
            "K2's max kind with an argmax backward (ROADMAP queue 1)")
    if kind not in ("mean", "sum"):
        raise ValueError(f"unknown aggregation kind {kind!r}")


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
    _check_kind(kind)
    if block.prefix_layout:
        return reduce_msgs_plain(_neigh_msgs(h_src, block), block.neigh_mask, kind)
    return GatherReduce.apply(h_src.contiguous(), block.neigh_pos,
                              block.neigh_mask, kind)


def block_gather(h_src: torch.Tensor, block: Block,
                 kind: str = "mean") -> Tuple[torch.Tensor, torch.Tensor]:
    """``(block_self(h_src, block), block_aggregate(h_src, block, kind))``,
    with one fused backward on host-sampled blocks."""
    _check_kind(kind)
    if block.prefix_layout:          # slices, no gather: nothing to fuse
        return block_self(h_src, block), block_aggregate(h_src, block, kind)
    return BlockGather.apply(h_src.contiguous(), block.self_pos, block.neigh_pos,
                             block.neigh_mask, kind)
