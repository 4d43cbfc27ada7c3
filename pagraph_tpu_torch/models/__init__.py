"""Model family: GraphSAGE, GCN, GIN and GAT.  CV-GCN is ROADMAP queue 1."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import ModelConfig
from .gat import GAT
from .gcn import GCN
from .gin import GIN
from .sage import GraphSAGE

MODELS = {"graphsage": GraphSAGE, "gcn": GCN, "gin": GIN, "gat": GAT}


def get_model(cfg: ModelConfig, *,
              generator: Optional[torch.Generator] = None) -> nn.Module:
    """The configured architecture, initialized on the CPU from
    ``generator``."""
    if cfg.arch in MODELS:
        return MODELS[cfg.arch](cfg, generator=generator)
    if cfg.arch == "gcn_cv":
        raise NotImplementedError(
            f"arch {cfg.arch!r} is not ported yet (ROADMAP queue 1)")
    raise ValueError(f"unknown arch {cfg.arch!r}")
