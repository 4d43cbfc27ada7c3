"""The data-parallel train step: each rank's step with its gradients
averaged over the process group (the port of
``pagraph_tpu/parallel/train_step.py`` ``make_dp_train_step``).

The JAX package ``pmean``s the gradients inside its ``shard_map`` step; the
port's ranks are processes, and :class:`GradSync` averages their gradients
with one ``all_reduce`` a step, between ``loss.backward()`` and the
learning-rate schedule and Adam (``train/state.py`` ``train_on_features``
calls it through ``TrainState.grad_sync``).  Every parameter's ``.grad`` is
a view into one flat f32 buffer, allocated once: at bf16 compute the master
gradients are f32 too (``cast_apply``), so the buffer is f32 at both
compute dtypes.  The one collective a step reads and writes that buffer at
a fixed address, so a step with it can be captured in a CUDA graph under
``nccl`` (the collective then is inside the graph).  The views must stay:
the step zeroes them in place (``GradSync.zero_``), never
``zero_grad(set_to_none=True)``.

The host path's dispatch is the single-device one
(``make_multistep_train_step``, K steps a group) over a state that carries
the sync; K only changes dispatch, not numbers.

:func:`make_dp_halo_train_step` is the ``ici`` feature source's step (the
JAX package's ``make_dp_halo_train_step``): its layer-0 rows come from the
halo exchange (``parallel/halo.py``) over the plan that travels in the
packed batch, in place of the cache assembly; the rest is the same body.
Under ``nccl`` a group's CUDA graph holds K x (2 ``all_to_all_single`` + 1
``all_reduce``).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..sampling.pack import PackedGroup, halo_req, unpack
from ..train.state import (GroupGraphs, TrainState, make_multistep_train_step, mark_phase,
                           train_on_features)


class GradSync:
    """The mean of every parameter's gradient over the process group, in
    place: ``zero_()`` before ``backward()``, ``sync()`` after it (one
    ``all_reduce(SUM)`` on the flat buffer, then ``div_(world_size)``; a
    SUM over one rank divided by 1 is exact).  ``calls`` counts the
    collectives enqueued (under capture: once, into the graph)."""

    def __init__(self, model: torch.nn.Module):
        self.world_size = dist.get_world_size()
        params = [p for p in model.parameters() if p.requires_grad]
        if any(p.dtype != torch.float32 for p in params):
            raise ValueError("GradSync keeps f32 master gradients: every parameter must be f32")
        total = sum(p.numel() for p in params)
        self.flat = torch.zeros(total, dtype=torch.float32, device=params[0].device)
        off = 0
        for p in params:
            p.grad = self.flat[off:off + p.numel()].view_as(p)
            off += p.numel()
        self._views = [(p, p.grad.data_ptr()) for p in params]
        self.calls = 0

    def zero_(self) -> None:
        self.flat.zero_()

    def sync(self) -> None:
        if any(p.grad is None or p.grad.data_ptr() != ptr for p, ptr in self._views):
            raise RuntimeError("a parameter's .grad is no longer a view of the flat "
                               "gradient buffer (zero_grad(set_to_none=True)?)")
        dist.all_reduce(self.flat, op=dist.ReduceOp.SUM)
        self.calls += 1
        if self.world_size != 1:
            self.flat.div_(self.world_size)


def attach_grad_sync(state: TrainState) -> GradSync:
    """Give ``state`` a :class:`GradSync` (once; returns it)."""
    if state.grad_sync is None:
        state.grad_sync = GradSync(state.model)
    return state.grad_sync


def make_dp_train_step(state: TrainState, cache_values: torch.Tensor,
                       dequant_scale: Optional[torch.Tensor] = None, *,
                       graph: bool = False,
                       stream: Optional[torch.cuda.Stream] = None) -> Callable:
    """``steps(group, acc)``: ``make_multistep_train_step`` over ``state``
    with its gradients averaged over the process group each step
    (:func:`attach_grad_sync`).  ``graph=True`` captures the K-step body
    with its K all-reduces (``nccl`` only: gloo is not stream-ordered)."""
    attach_grad_sync(state)
    return make_multistep_train_step(state, cache_values, dequant_scale, graph=graph,
                                     stream=stream)


def make_dp_halo_train_step(state: TrainState, exchange, *, graph: bool = False,
                            stream: Optional[torch.cuda.Stream] = None) -> Callable:
    """``steps(group, acc)`` of the ``ici`` feature source: per packed batch
    of ``group`` (its layout's ``halo`` requests last), unpack it, fetch its
    layer-0 rows through ``exchange`` (a ``parallel.halo.HaloExchange``) in
    the compute dtype, and train on them with the gradients averaged over
    the process group; loss and accuracy are added into ``acc``.  Both
    forms copy the group to the shard's device first; ``graph=True`` is a
    ``GroupGraphs`` (``nccl`` only), its K-step body captured with its
    collectives."""
    attach_grad_sync(state)

    def step(layout, acc: torch.Tensor, i32: torch.Tensor, u8: torch.Tensor) -> None:
        mb, src_row, _ = unpack(layout, i32, u8)
        mark_phase(state, "fetch")
        feats = exchange(halo_req(layout, i32), src_row, state.dtype)
        m = train_on_features(state, mb, feats)
        acc.add_(torch.stack([m["loss"], m["acc"]]))

    def on_device(group: PackedGroup, acc: torch.Tensor) -> None:
        for k in range(group.k):
            step(group.layout, acc, group.i32[k], group.u8[k])

    if graph:
        return GroupGraphs(on_device, state, exchange.shard, stream=stream)

    def steps(group: PackedGroup, acc: torch.Tensor) -> None:
        on_device(group.to(exchange.shard.device, non_blocking=True), acc)

    return steps
