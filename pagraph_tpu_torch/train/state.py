"""Train state and the single-device train step (the port of
``pagraph_tpu/train/state.py``).

One step: assemble the layer-0 features from the device cache and the
shipped miss rows (one launch, which widens the bf16 and int8 cache tiers
to f32), run GraphSAGE forward (one fused gather
launch per block), the masked cross-entropy, backward (one fused scatter-add
launch for each block whose source needs a gradient) and Adam: 4 kernel
launches for the 2-layer model.  Nothing in a
step waits for the device: loss and accuracy come back as device tensors.
The on-device epoch (``train/device_epoch.py``) fetches its features
otherwise and shares the rest, :func:`train_on_features`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from ..config import Config
from ..models import get_model
from ..sampling.block import MiniBatch
from ..storage.cache import assemble_features
from ..utils.device import resolve_device
from .objective import masked_accuracy, masked_cross_entropy


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator      # dropout stream, on the model's device
    step: int = 0


def make_optimizer(cfg: Config, params) -> torch.optim.Optimizer:
    """Adam with optax.adam's defaults: betas (0.9, 0.999), eps 1e-8."""
    t = cfg.train
    if t.lr_schedule != "none":
        raise NotImplementedError(
            f"lr_schedule {t.lr_schedule!r} is not ported yet (ROADMAP queue 1)")
    return torch.optim.Adam(params, lr=t.lr, betas=(0.9, 0.999), eps=1e-8)


def create_state(cfg: Config, seed: int = 0, device=None) -> TrainState:
    """Parameters are drawn on the CPU from ``seed`` and then moved, so a
    seed gives the same initial model on every device.  ``device=None`` is
    the GPU (``RuntimeError`` without one)."""
    if cfg.train.dtype != "float32":
        raise NotImplementedError(
            f"train.dtype {cfg.train.dtype!r} is not ported yet (ROADMAP queue 1)")
    device = resolve_device(device)
    model = get_model(cfg.model, generator=torch.Generator().manual_seed(seed))
    model.to(device).train()
    gen = torch.Generator(device=device).manual_seed(seed ^ 0x5EED)
    return TrainState(model=model, optimizer=make_optimizer(cfg, model.parameters()),
                      generator=gen)


def train_step(state: TrainState, mb: MiniBatch, miss_feats: torch.Tensor,
               src_row: torch.Tensor, cache_values: torch.Tensor,
               dequant_scale: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """One optimizer step on a device minibatch, its plan's miss rows and
    ``src_row`` (:class:`FetchPlan`), the cache rows and, for the int8
    tier, the cache's dequant scale; returns ``{"loss", "acc"}`` as device
    scalars (no host sync)."""
    feats = assemble_features(cache_values, src_row, miss_feats, dequant_scale)
    return train_on_features(state, mb, feats)


def train_on_features(state: TrainState, mb: MiniBatch,
                      feats: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The step after the layer-0 fetch: forward, masked cross-entropy,
    backward and Adam on f32 features ``feats``; ``{"loss", "acc"}`` as
    device scalars (no host sync)."""
    logits = state.model(mb, feats, generator=state.generator)
    loss = masked_cross_entropy(logits, mb.labels, mb.seed_mask)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    with torch.no_grad():
        acc = masked_accuracy(logits, mb.labels, mb.seed_mask)
    return {"loss": loss.detach(), "acc": acc}
