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

``train.dtype="bfloat16"`` is the JAX package's mixed precision
(``cast_apply``): the forward, and so the backward, run on bf16 copies of
the parameters and bf16 features, while the master parameters, the Adam
state, the logits and the loss stay f32.  The assembly then writes its
features as bf16 (the same launch), and the block kernels run on bf16 rows;
the backward adds into an f32 table and rounds it in a second launch, so a
bf16 step launches 5 kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

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
    dtype: torch.dtype = torch.float32   # compute dtype (compute_dtype)


def compute_dtype(cfg: Config) -> torch.dtype:
    """Activation/matmul dtype from ``TrainConfig.dtype``."""
    return torch.bfloat16 if cfg.train.dtype == "bfloat16" else torch.float32


def cast_apply(model: nn.Module, dtype: torch.dtype) -> Callable:
    """Mixed precision as the JAX package's ``cast_apply``: the forward
    (and so the backward) on parameters and features cast to ``dtype``,
    f32 logits.  The casts are explicit, parameter by parameter, not
    ``torch.autocast`` (which picks a dtype op by op); they are
    differentiable, so the gradients reach the f32 master parameters as
    f32.  The model itself for f32."""
    if dtype == torch.float32:
        return model

    def apply(mb: MiniBatch, feats: torch.Tensor, **kw) -> torch.Tensor:
        params = {name: p.to(dtype) for name, p in model.named_parameters()}
        return torch.func.functional_call(model, params, (mb, feats.to(dtype)), kw).float()

    return apply


def make_optimizer(cfg: Config, params) -> torch.optim.Optimizer:
    """Adam with optax.adam's defaults: betas (0.9, 0.999), eps 1e-8."""
    t = cfg.train
    if t.lr_schedule != "none":
        raise NotImplementedError(
            f"lr_schedule {t.lr_schedule!r} is not ported yet (ROADMAP queue 1)")
    return torch.optim.Adam(params, lr=t.lr, betas=(0.9, 0.999), eps=1e-8)


def create_state(cfg: Config, seed: int = 0, device=None) -> TrainState:
    """Parameters are drawn on the CPU from ``seed`` and then moved, so a
    seed gives the same initial model on every device; they stay f32 at
    every ``train.dtype``.  ``device=None`` is the GPU (``RuntimeError``
    without one)."""
    device = resolve_device(device)
    model = get_model(cfg.model, generator=torch.Generator().manual_seed(seed))
    model.to(device).train()
    gen = torch.Generator(device=device).manual_seed(seed ^ 0x5EED)
    return TrainState(model=model, optimizer=make_optimizer(cfg, model.parameters()),
                      generator=gen, dtype=compute_dtype(cfg))


def train_step(state: TrainState, mb: MiniBatch, miss_feats: torch.Tensor,
               src_row: torch.Tensor, cache_values: torch.Tensor,
               dequant_scale: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """One optimizer step on a device minibatch, its plan's miss rows and
    ``src_row`` (:class:`FetchPlan`), the cache rows and, for the int8
    tier, the cache's dequant scale; returns ``{"loss", "acc"}`` as device
    scalars (no host sync).  The features are assembled in the compute
    dtype."""
    feats = assemble_features(cache_values, src_row, miss_feats, dequant_scale,
                              out_dtype=state.dtype)
    return train_on_features(state, mb, feats)


def train_on_features(state: TrainState, mb: MiniBatch,
                      feats: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The step after the layer-0 fetch: forward, masked cross-entropy,
    backward and Adam on features ``feats`` (f32, or bf16 at bf16 compute),
    through :func:`cast_apply`; ``{"loss", "acc"}`` as device scalars (no
    host sync)."""
    logits = cast_apply(state.model, state.dtype)(mb, feats, generator=state.generator)
    loss = masked_cross_entropy(logits, mb.labels, mb.seed_mask)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    with torch.no_grad():
        acc = masked_accuracy(logits, mb.labels, mb.seed_mask)
    return {"loss": loss.detach(), "acc": acc}
