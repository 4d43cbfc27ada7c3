"""Model family: GraphSAGE, GCN, CV-GCN (``gcn_cv``), GIN and GAT."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import ModelConfig
from .gat import GAT
from .gcn import GCN
from .gcn_cv import GCNCV
from .gin import GIN
from .sage import GraphSAGE

MODELS = {"graphsage": GraphSAGE, "gcn": GCN, "gcn_cv": GCNCV, "gin": GIN, "gat": GAT}


def get_model(cfg: ModelConfig, *,
              generator: Optional[torch.Generator] = None) -> nn.Module:
    """The configured architecture, initialized on the CPU from
    ``generator``."""
    if cfg.arch in MODELS:
        return MODELS[cfg.arch](cfg, generator=generator)
    raise ValueError(f"unknown arch {cfg.arch!r}")
