"""Shared model building blocks (the port of ``pagraph_tpu/models/common.py``).

Linear weights keep the JAX package's ``[in, out]`` layout
(``y = x @ w + b``), so parameters convert between the packages without a
transpose (``convert.py``).
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn


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
    keep = 1.0 - rate
    thresh = min(int(round(keep * 65536.0)), 65535)
    bits = torch.randint(0, 1 << 16, x.shape, generator=generator,
                         device=x.device, dtype=torch.int32)
    return torch.where(bits < thresh, x * (1.0 / keep), 0.0)


def concat_skip(h: torch.Tensor, activation: Callable) -> torch.Tensor:
    """The reference's skip connection on the last hidden layer:
    ``cat((h, act(h)))`` doubling the width."""
    return torch.cat([h, activation(h)], dim=-1)
