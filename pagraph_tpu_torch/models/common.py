"""Shared model building blocks (the port of ``pagraph_tpu/models/common.py``).

Linear weights keep the JAX package's ``[in, out]`` layout
(``y = x @ w + b``), so parameters convert between the packages without a
transpose (``convert.py``).
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
from torch import nn

from ..ops.aggregate import (DROPOUT_BLOCK_KINDS, block_aggregate, block_gather,
                             dropout_block_gather, dropout_threshold)
from ..sampling.block import Block


def _uniform(shape, bound: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


def init_linear(in_dim: int, out_dim: int, *,
                generator: Optional[torch.Generator] = None,
                xavier_gain: Optional[float] = None) -> tuple:
    """``(w [in, out], b [out])`` on the CPU.  Default torch-style fan-in
    uniform init; ``xavier_gain`` gives the reference GraphSAGE's
    Xavier-uniform init.  Bias: uniform(+-1/sqrt(in))."""
    if xavier_gain is not None:
        bound = xavier_gain * math.sqrt(6.0 / (in_dim + out_dim))
    else:
        bound = 1.0 / math.sqrt(in_dim)
    w = _uniform((in_dim, out_dim), bound, generator)
    b = _uniform((out_dim,), 1.0 / math.sqrt(in_dim), generator)
    return w, b


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.addmm(b, x, w)


class Linear(nn.Module):
    """``x @ w + b`` with ``w`` stored ``[in, out]``."""

    def __init__(self, in_dim: int, out_dim: int, *,
                 generator: Optional[torch.Generator] = None,
                 xavier_gain: Optional[float] = None):
        super().__init__()
        w, b = init_linear(in_dim, out_dim, generator=generator,
                           xavier_gain=xavier_gain)
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.w, self.b)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            train: bool) -> torch.Tensor:
    """Inverted dropout with the JAX package's uint16-threshold mask: keep a
    unit iff a uniform 16-bit draw is below ``round(keep * 65536)``.  No-op
    outside training, at rate 0 or without a generator.  (torch and
    ``jax.random`` streams differ, so masks never match across packages.)"""
    if not train or rate == 0.0 or generator is None:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    thresh, inv_keep = dropout_threshold(rate)
    bits = torch.randint(0, 1 << 16, x.shape, generator=generator,
                         device=x.device, dtype=torch.int32)
    return torch.where(bits < thresh, x * inv_keep, 0.0)


def dropout_gather(h: torch.Tensor, block: Block, kind: str, rate: float,
                   generator: Optional[torch.Generator], train: bool, *,
                   with_self: bool = True,
                   kernel_draw: bool = True) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """``(block_self(d), block_aggregate(d, kind))`` of ``d = dropout(h, rate,
    generator, train)`` (the first ``None`` unless ``with_self``).  A
    prefix-layout block of kind ``mean`` or ``sum`` takes the fused op
    (``ops.aggregate.dropout_block_gather``: the same units dropped, the
    generator advanced as far; ``kernel_draw`` False for a model that also
    draws through :func:`dropout` from the same generator); any other block,
    kind or a rate of 1 :func:`dropout` and then the block's gathers."""
    if block.prefix_layout and kind in DROPOUT_BLOCK_KINDS and rate < 1.0:
        on = train and rate > 0.0 and generator is not None
        return dropout_block_gather(h, block, kind, rate if on else 0.0,
                                    generator if on else None, with_self=with_self,
                                    kernel_draw=kernel_draw)
    h = dropout(h, rate, generator, train)
    if with_self:
        return block_gather(h, block, kind)
    return None, block_aggregate(h, block, kind)


def concat_skip(h: torch.Tensor, activation: Callable) -> torch.Tensor:
    """The reference's skip connection on the last hidden layer:
    ``cat((h, act(h)))`` doubling the width."""
    return torch.cat([h, activation(h)], dim=-1)
