"""Block aggregation ops (the port of ``pagraph_tpu/ops/aggregate.py``).

Blocks are fixed-shape ``(cap_dst, fanout)`` index matrices, so
"copy_src + segment-reduce" is a gather followed by a masked reduction over
the fan-out axis.  On host-sampled blocks :func:`block_gather` gathers a
block's self rows and reduces its neighbor rows in one CUDA launch, and its
backward adds both gradients into the source table in one more
(``gather_kernels.BlockGather``); :func:`block_self` and
:func:`block_aggregate`, the counterparts of the JAX functions, do one half
each (the same forward kernel with the other half absent).  The kinds are
``mean``, ``sum`` and ``max`` (the pool aggregator's; its backward splits
each gradient equally among tied maxima, as ``jnp.max``'s does).
Prefix-layout blocks, which the on-device sampler
(``sampling/device_sampler.py``) produces, need no gather: a block's self
rows and its neighbor messages are contiguous slices (the JAX package
reduces them with XLA, not Pallas).  There :func:`dropout_block_gather`
draws the model's dropout as a keep-mask of a bit an element in one CUDA
launch, takes it and both halves of a ``mean`` or ``sum`` block in one
more, and their gradient in one more (``gather_kernels.dropout_bits``,
``DropoutBlock``), and :func:`gat_attention` takes GAT's
attention in one more pair (``gather_kernels.GatAttention``); the other
functions reduce the slices in plain torch.  Every function here
computes at its input's dtype: f32, or bf16 under ``train.dtype="bfloat16"``
(the kernels take both).

The LSTM aggregator (:func:`block_aggregate_lstm`) runs an LSTM over each
destination's neighbor sequence in plain torch matmuls, as the JAX package
runs it in XLA (``nn.LSTM`` and cuDNN cannot carry the state through masked
steps); on host-sampled blocks its messages, and the block's self rows,
come from one row-gather launch (:func:`block_gather_msgs`).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..sampling.block import Block
from .gather_kernels import (DROPOUT_BLOCK_KINDS, KINDS, BlockGather, DropoutBlock,
                             GatAttention, GatherReduce, GatherRows, dropout_bits,
                             dropout_bits_plain, reduce_msgs_plain)


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"unknown aggregation kind {kind!r}")


def block_self(h_src: torch.Tensor, block: Block) -> torch.Tensor:
    """Representation of each dst vertex itself: [cap_dst, D]."""
    if block.prefix_layout:
        return h_src[:block.cap_dst]
    return GatherRows.apply(h_src.contiguous(), block.self_pos)


def _neigh_msgs(h_src: torch.Tensor, block: Block) -> torch.Tensor:
    """Neighbor messages [cap_dst, fanout, D]: a contiguous slice after the
    dst prefix in prefix layout (no gather; backward is a pad), else one row
    gather of ``neigh_pos``."""
    n, f = block.cap_dst, block.fanout
    if block.prefix_layout:
        return h_src[n:n + n * f].reshape(n, f, *h_src.shape[1:])
    return GatherRows.apply(h_src.contiguous(), block.neigh_pos.reshape(-1)).reshape(
        n, f, *h_src.shape[1:])


def block_aggregate(h_src: torch.Tensor, block: Block,
                    kind: str = "mean") -> torch.Tensor:
    """Masked neighbor aggregation: [cap_src, D] -> [cap_dst, D].

    kind: 'mean' | 'sum' | 'max'.  Vertices with zero valid neighbors get a
    zero vector (DGL's empty-mailbox default).
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


def dropout_threshold(rate: float) -> Tuple[int, float]:
    """``(thresh, 1 / keep)`` of inverted dropout at ``rate`` < 1: a unit is
    kept iff a uniform 16-bit draw is below ``thresh = round(keep * 65536)``
    (at most 65535), the JAX package's uint16-threshold mask."""
    keep = 1.0 - rate
    return min(int(round(keep * 65536.0)), 65535), 1.0 / keep


def dropout_block_gather(h_src: torch.Tensor, block: Block, kind: str, rate: float,
                         generator: Optional[torch.Generator], *, with_self: bool = True,
                         kernel_draw: bool = True):
    """``(block_self(d, block), block_aggregate(d, block, kind))`` of ``d =
    dropout(h_src, rate, generator)`` on a prefix-layout block, ``kind``
    ``mean`` or ``sum``; the first is ``None`` unless ``with_self``.  Rate 0
    or no generator: no dropout.  The units are those of one
    ``torch.randint`` of ``h_src``'s shape from ``generator``, int16 in
    [-32768, 32768): the draw of ``models.common.dropout`` (int32 in [0,
    65536)) moved down by 32768, which keeps the same units and advances the
    generator as far; they reach the block as a keep-mask of a bit an
    element.  On the card one launch draws it (``gather_kernels.
    dropout_bits``), one more forward and one backward
    (``gather_kernels.DropoutBlock``); on the CPU the same arithmetic in
    torch.  ``kernel_draw`` False draws the units with ``torch.randint``
    on the card too (``gather_kernels.dropout_bits_plain``), for a model
    whose CUDA graph also holds torch's own draws from ``generator``."""
    if not block.prefix_layout:
        raise ValueError("dropout_block_gather takes prefix-layout blocks only")
    if kind not in DROPOUT_BLOCK_KINDS:
        raise ValueError(f"dropout_block_gather kind must be one of {DROPOUT_BLOCK_KINDS}, "
                         f"got {kind!r}")
    keep, inv_keep = None, 1.0
    if rate > 0.0 and generator is not None:
        if rate >= 1.0:
            raise ValueError(f"dropout rate {rate} keeps nothing")
        thresh, inv_keep = dropout_threshold(rate)
        draw = dropout_bits if kernel_draw else dropout_bits_plain
        keep = draw(h_src.shape, thresh, generator, h_src.device)
    out = DropoutBlock.apply(h_src.contiguous(), keep, block.neigh_mask, inv_keep, kind,
                             with_self)
    return out if with_self else (None, out)


def gat_attention(z: torch.Tensor, a_self: torch.Tensor, a_neigh: torch.Tensor,
                  block: Block) -> torch.Tensor:
    """GAT's attention over a prefix-layout block, ``[cap_dst, K, H]``, from
    ``z [cap_src, K*H]`` and the attention vectors ``[K, H]``: the masked
    softmax of each destination's self edge and valid slots, and the
    weighted sum of their ``z`` rows (``models/gat.py``).  On the card, at
    f32, one launch forward and one C call backward
    (``gather_kernels.GatAttention``); on the CPU the plain chain."""
    if not block.prefix_layout:
        raise ValueError("gat_attention takes prefix-layout blocks only")
    return GatAttention.apply(z.contiguous(), a_self.contiguous(), a_neigh.contiguous(),
                              block.neigh_mask)


def block_gather_msgs(h_src: torch.Tensor,
                      block: Block) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(block_self(h_src, block), neighbor messages [cap_dst, fanout,
    D])``: on host-sampled blocks one row gather of ``self_pos`` followed by
    ``neigh_pos`` (one forward launch, one backward launch), sliced apart."""
    if block.prefix_layout:
        return block_self(h_src, block), _neigh_msgs(h_src, block)
    n, f = block.cap_dst, block.fanout
    ids = torch.cat([block.self_pos, block.neigh_pos.reshape(-1)])
    rows = GatherRows.apply(h_src.contiguous(), ids)
    return rows[:n], rows[n:].reshape(n, f, *h_src.shape[1:])


def lstm_reduce(msgs: torch.Tensor, mask: torch.Tensor,
                params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The final hidden state of an LSTM run over ``msgs [N, F, D]`` along
    the fan-out axis; a masked step carries ``h`` and ``c`` through
    unchanged.  ``params``: ``w_ih [D, 4H]``, ``w_hh [H, 4H]``, ``b [4H]``,
    the gates split i, f, g, o (the JAX package's layout and single bias)."""
    n, fanout = msgs.shape[0], msgs.shape[1]
    w_ih, w_hh, b = params["w_ih"], params["w_hh"], params["b"]
    hidden = w_hh.shape[0]
    h = msgs.new_zeros((n, hidden))
    c = msgs.new_zeros((n, hidden))
    for k in range(fanout):
        gates = msgs[:, k] @ w_ih + h @ w_hh + b
        i, f, g, o = gates.chunk(4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        c_new = f * c + i * torch.tanh(g)
        h_new = o * torch.tanh(c_new)
        keep = mask[:, k, None]
        h = torch.where(keep, h_new, h)
        c = torch.where(keep, c_new, c)
    return h


def block_aggregate_lstm(h_src: torch.Tensor, block: Block,
                         params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """LSTM aggregator: :func:`lstm_reduce` over each destination's (padded)
    neighbor sequence, [cap_src, D] -> [cap_dst, H]."""
    return lstm_reduce(_neigh_msgs(h_src, block), block.neigh_mask, params)


def init_lstm_params(in_dim: int, hidden: int, *,
                     generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """``w_ih [in, 4H]`` and ``w_hh [H, 4H]`` uniform in +-1/sqrt(H), ``b``
    zeros ``[4H]``, on the CPU."""
    bound = 1.0 / math.sqrt(hidden)

    def uniform(shape):
        return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound

    return {"w_ih": uniform((in_dim, 4 * hidden)), "w_hh": uniform((hidden, 4 * hidden)),
            "b": torch.zeros(4 * hidden)}
