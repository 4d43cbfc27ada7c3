"""Loss and metrics over padded seed vertices (the port of
``pagraph_tpu/train/objective.py``).  Every reduction masks out the padded
batch tail."""
from __future__ import annotations

import torch


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over valid seeds."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = logp.gather(1, labels.long()[:, None])[:, 0]
    n = mask.sum().clamp(min=1).to(logits.dtype)
    return -torch.where(mask, ll, 0.0).sum() / n


def masked_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    pred = logits.argmax(dim=-1)
    correct = (pred == labels.long()) & mask
    return correct.sum().to(torch.float32) / mask.sum().clamp(min=1).to(torch.float32)
