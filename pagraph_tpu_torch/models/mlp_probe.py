"""Structure-blind MLP baseline, the control arm of the accuracy ablation
(the port of ``pagraph_tpu/models/mlp_probe.py``).

A 2-layer MLP trained on each vertex's own features, full-batch, measures
how much of a task is solvable without the graph.  On structure-dependent
labels (``data.synthetic.neighborhood_labels``) its validation accuracy is
the floor a GNN must clear by a wide margin.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch.nn import functional as F

from ..utils.device import resolve_device


def mlp_val_acc(
    features: np.ndarray,
    labels: np.ndarray,
    train_mask: np.ndarray,
    val_mask: np.ndarray,
    *,
    hidden: int = 64,
    steps: int = 400,
    lr: float = 1e-2,
    seed: int = 0,
    weight_decay: float = 0.0,
    max_train: Optional[int] = 200_000,
    init: Optional[Dict[str, np.ndarray]] = None,
    device=None,
) -> float:
    """Best validation accuracy of a 2-layer MLP on (features -> labels).

    Full-batch AdamW (optax's defaults: betas 0.9 and 0.999, eps 1e-8) for
    ``steps`` steps; the best validation accuracy over the trajectory,
    evaluated every ``steps // 20`` steps and after the last: the honest
    ceiling of a structure-blind model.  ``max_train`` subsamples the train
    and validation vertices (numpy's generator from ``seed``, as the JAX
    package draws them).  The weights are drawn from a torch generator
    seeded by ``seed`` (``w0`` and ``w1`` normal over ``sqrt(fan_in)``,
    zero biases), or given as numpy arrays by ``init`` (``w0 [D, hidden]``,
    ``b0``, ``w1 [hidden, C]``, ``b1``).  ``device=None`` is the GPU."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    tr_idx = np.nonzero(np.asarray(train_mask))[0]
    va_idx = np.nonzero(np.asarray(val_mask))[0]
    if max_train is not None and len(tr_idx) > max_train:
        tr_idx = rng.choice(tr_idx, size=max_train, replace=False)
    if max_train is not None and len(va_idx) > max_train:
        va_idx = rng.choice(va_idx, size=max_train, replace=False)

    def on_device(x, dtype):
        return torch.from_numpy(np.asarray(x)).to(device=device, dtype=dtype)

    x_tr, y_tr = on_device(features[tr_idx], torch.float32), on_device(labels[tr_idx], torch.int64)
    x_va, y_va = on_device(features[va_idx], torch.float32), on_device(labels[va_idx], torch.int64)
    d = x_tr.shape[1]
    c = int(np.asarray(labels).max()) + 1
    if init is None:
        gen = torch.Generator().manual_seed(seed)
        init = {"w0": torch.randn(d, hidden, generator=gen) / np.sqrt(d),
                "b0": torch.zeros(hidden),
                "w1": torch.randn(hidden, c, generator=gen) / np.sqrt(hidden),
                "b1": torch.zeros(c)}
    params = {k: torch.tensor(np.asarray(v, dtype=np.float32), device=device,
                              requires_grad=True) for k, v in init.items()}
    opt = torch.optim.AdamW(list(params.values()), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)

    def logits(x):
        h = torch.relu(x @ params["w0"] + params["b0"])
        return h @ params["w1"] + params["b1"]

    best = 0.0
    eval_every = max(1, steps // 20)
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        F.cross_entropy(logits(x_tr), y_tr).backward()
        opt.step()
        if (i + 1) % eval_every == 0 or i == steps - 1:
            with torch.no_grad():
                acc = (logits(x_va).argmax(dim=1) == y_va).float().mean().item()
            best = max(best, acc)
    return best
