"""Train state and the single-device train step (the port of
``pagraph_tpu/train/state.py``).

One step: assemble the layer-0 features from the device cache and the
shipped miss rows (one K1 launch), run GraphSAGE forward (K2 + K1 per
block), the masked cross-entropy, backward (the K2 and K1 scatter-add
kernels for the block whose source needs a gradient) and Adam.  Nothing in a
step waits for the device: loss and accuracy come back as device tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch import nn

from ..config import Config
from ..models import get_model
from ..sampling.block import MiniBatch
from ..storage.cache import assemble_features_from_map
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


def create_state(cfg: Config, seed: int = 0, device="cpu") -> TrainState:
    """Parameters are drawn on the CPU from ``seed`` and then moved, so a
    seed gives the same initial model on every device."""
    if cfg.train.dtype != "float32":
        raise NotImplementedError(
            f"train.dtype {cfg.train.dtype!r} is not ported yet (ROADMAP queue 1)")
    device = torch.device(device)
    model = get_model(cfg.model, generator=torch.Generator().manual_seed(seed))
    model.to(device).train()
    gen = torch.Generator(device=device).manual_seed(seed ^ 0x5EED)
    return TrainState(model=model, optimizer=make_optimizer(cfg, model.parameters()),
                      generator=gen)


def train_step(state: TrainState, mb: MiniBatch, miss_feats: torch.Tensor,
               miss_slot: torch.Tensor, cache_values: torch.Tensor,
               cache_map: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One optimizer step on a device minibatch; returns ``{"loss", "acc"}``
    as device scalars (no host sync)."""
    feats = assemble_features_from_map(cache_values, cache_map, mb.input_nids,
                                       miss_slot, miss_feats)
    logits = state.model(mb, feats, generator=state.generator)
    loss = masked_cross_entropy(logits, mb.labels, mb.seed_mask)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    with torch.no_grad():
        acc = masked_accuracy(logits, mb.labels, mb.seed_mask)
    return {"loss": loss.detach(), "acc": acc}
