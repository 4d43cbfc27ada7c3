"""The training step's arithmetic in plain torch: inverted dropout, the
masked mean over sampled neighbors, the masked cross-entropy over the
seeds, and Adam with PyTorch's and optax's defaults (betas 0.9, 0.999, eps
1e-8)."""
from __future__ import annotations

from typing import Dict, Optional

import torch

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def dropout(x: torch.Tensor, rate: float, gen: Optional[torch.Generator]) -> torch.Tensor:
    """Keep a unit iff a uniform 16-bit draw is below ``round((1 - rate) *
    65536)``, scaled by ``1 / (1 - rate)``; the draw is one ``torch.randint``
    of ``x``'s shape from ``gen``.  No-op at rate 0 or without ``gen``."""
    if rate == 0.0 or gen is None:
        return x
    keep = 1.0 - rate
    thresh = min(int(round(keep * 65536.0)), 65535)
    bits = torch.randint(0, 1 << 16, x.shape, generator=gen, device=x.device, dtype=torch.int32)
    return torch.where(bits < thresh, x * (1.0 / keep), torch.zeros((), device=x.device))


def neighbor_mean(h: torch.Tensor, mask: torch.Tensor, n_dst: int, fanout: int) -> torch.Tensor:
    """Mean of the valid neighbor rows of each of the ``n_dst`` destinations,
    which follow the destinations in ``h`` (``fanout`` a destination); zero
    where there is none."""
    msgs = h[n_dst:n_dst + n_dst * fanout].reshape(n_dst, fanout, h.shape[1])
    m = mask[n_dst:n_dst + n_dst * fanout].reshape(n_dst, fanout, 1).to(h.dtype)
    return (msgs * m).sum(dim=1) / m.sum(dim=1).clamp(min=1.0)


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the valid seeds."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = logp.gather(1, labels.long()[:, None])[:, 0]
    return -(ll * mask.to(ll.dtype)).sum() / mask.sum().clamp(min=1).to(ll.dtype)


class Adam:
    """Adam over a dict of leaves, updated in place; from zero moments at
    step 0, or from ``m``, ``v`` after ``t`` steps."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, *,
                 m: Optional[Dict[str, torch.Tensor]] = None,
                 v: Optional[Dict[str, torch.Tensor]] = None, t: int = 0):
        self.lr = lr
        self.t = t
        self.m = {k: torch.zeros_like(p) if m is None else m[k].to(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) if v is None else v[k].to(p) for k, p in params.items()}

    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        bc1, bc2 = 1.0 - BETA1 ** self.t, 1.0 - BETA2 ** self.t
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k]
                self.m[k].mul_(BETA1).add_(g, alpha=1.0 - BETA1)
                self.v[k].mul_(BETA2).addcmul_(g, g, value=1.0 - BETA2)
                p.sub_(self.lr * (self.m[k] / bc1) / ((self.v[k] / bc2).sqrt() + EPS))
