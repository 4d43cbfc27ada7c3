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

The optimizer is Adam with its learning rate a 0-d f32 tensor on the
parameters' device, under ``train.lr_schedule``: ``"none"`` keeps it
fixed, ``"cosine"`` (the JAX package's ``optax.cosine_decay_schedule(lr,
lr_decay_steps, alpha=0.05)``) sets it on the device before each update
from ``TrainState.step_t``, the device count of updates applied.  Nothing
is read back, so a step captured in a CUDA graph replays the schedule.
On CUDA the optimizer is ``capturable`` (its step counts on the device too),
eager and replayed alike; on the CPU it is not (PyTorch refuses it there),
with the same tensor learning rate.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch
from torch import nn

from ..config import Config
from ..models import get_model
from ..sampling.block import MiniBatch
from ..storage.cache import assemble_features
from ..utils.device import resolve_device
from .objective import masked_accuracy, masked_cross_entropy


# optax.cosine_decay_schedule's alpha in the JAX package's make_optimizer
COSINE_ALPHA = 0.05


@dataclasses.dataclass
class TrainState:
    """``step`` counts updates on the host, ``step_t`` (int64, 0-d, on the
    model's device) on the device; a replayed CUDA graph advances
    ``step_t`` itself and its caller ``step``."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator      # dropout stream, on the model's device
    step: int = 0
    dtype: torch.dtype = torch.float32   # compute dtype (compute_dtype)
    lr_schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None   # make_lr_schedule
    step_t: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.step_t is None:
            self.step_t = torch.zeros((), dtype=torch.int64,
                                      device=next(self.model.parameters()).device)


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


def cosine_decay(count: torch.Tensor, lr: float, decay_steps: int,
                 alpha: float = COSINE_ALPHA) -> torch.Tensor:
    """``optax.cosine_decay_schedule(lr, decay_steps, alpha)`` at ``count``
    updates applied: ``lr * ((1 - alpha) * (1 + cos(pi * min(count, T) / T))
    / 2 + alpha)``, f32 on ``count``'s device, in optax's order."""
    t = count.clamp(max=decay_steps).to(torch.float32)
    return lr * ((1 - alpha) * (0.5 * (1 + torch.cos(math.pi * t / decay_steps))) + alpha)


def make_lr_schedule(cfg: Config) -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
    """The learning rate at an update count (a device tensor) under
    ``train.lr_schedule``, or ``None`` for the fixed ``train.lr``.  The
    horizon is ``max(lr_decay_steps, 1)``, as in the JAX package."""
    t = cfg.train
    if t.lr_schedule == "none":
        return None
    if t.lr_schedule == "cosine":
        lr, steps = t.lr, max(int(t.lr_decay_steps), 1)
        return lambda count: cosine_decay(count, lr, steps)
    raise ValueError(f"unknown lr_schedule {t.lr_schedule!r}")


def make_optimizer(cfg: Config, params) -> torch.optim.Optimizer:
    """Adam with optax.adam's defaults: betas (0.9, 0.999), eps 1e-8, and
    the learning rate ``train.lr`` as a 0-d f32 tensor on the parameters'
    device (``param_groups[0]["lr"]``, which a schedule sets in place).
    ``capturable`` (and ``foreach``) on CUDA; on the CPU neither."""
    params = list(params)
    device = params[0].device
    on_cuda = device.type == "cuda"
    lr = torch.tensor(cfg.train.lr, dtype=torch.float32, device=device)
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            capturable=on_cuda, foreach=on_cuda)


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
                      generator=gen, dtype=compute_dtype(cfg),
                      lr_schedule=make_lr_schedule(cfg))


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
    if state.lr_schedule is not None:
        state.optimizer.param_groups[0]["lr"].copy_(state.lr_schedule(state.step_t))
    state.optimizer.step()
    state.step_t.add_(1)
    state.step += 1
    with torch.no_grad():
        acc = masked_accuracy(logits, mb.labels, mb.seed_mask)
    return {"loss": loss.detach(), "acc": acc}
