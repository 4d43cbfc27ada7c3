"""Model family.  The port has GraphSAGE; GCN, GIN, GAT and CV-GCN are
ROADMAP queue 1."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import ModelConfig
from .sage import GraphSAGE


def get_model(cfg: ModelConfig, *,
              generator: Optional[torch.Generator] = None) -> nn.Module:
    """The configured architecture, initialized on the CPU from
    ``generator``."""
    if cfg.arch == "graphsage":
        return GraphSAGE(cfg, generator=generator)
    if cfg.arch in ("gcn", "gcn_cv", "gat", "gin"):
        raise NotImplementedError(
            f"arch {cfg.arch!r} is not ported yet (ROADMAP queue 1)")
    raise ValueError(f"unknown arch {cfg.arch!r}")
