"""Train state and the single-device train step (the port of
``pagraph_tpu/train/state.py``).

One step: assemble the layer-0 features from the device cache and the
shipped miss rows (one launch, which widens the bf16 and int8 cache tiers
to f32), run the model's forward (one gather launch per block), the masked
cross-entropy, backward (one scatter-add launch for each block whose source
needs a gradient) and Adam.  For the architectures of ``models.get_model``
(GraphSAGE, GCN, GIN, GAT) that is 1 + blocks + the blocks that need a
gradient: 4 for GraphSAGE with 2 blocks, 6 for GCN and GIN with 3 (layer 0
needs none), 7 for GAT with 3 (its block 0 does: its messages are
``h @ w``), and 1 + 2 x blocks for CV-GCN (every block's source needs a
gradient, block 0's through ``dense``): 5 with 2 blocks, 7 at bf16 compute.
Nothing in a step waits for the device: loss and accuracy come back as
device tensors (CV-GCN's step also returns its fresh histories).  The on-device epoch (``train/device_epoch.py``)
fetches its features otherwise and shares the rest,
:func:`train_on_features`.  Under GraphSAGE preprocess the layer-0 table
holds two store fields side by side, ``features`` and ``neigh``
(:func:`layer0_fields`, fetched in the same launch, ``model.feat_dim``
columns each), which the step slices apart as the JAX package's steps slice
``fused[:, offsets[...]]``; under GCN preprocess it holds ``features``
alone, which the store built as their full-graph mean.

``train.dtype="bfloat16"`` is the JAX package's mixed precision
(``cast_apply``): the forward, and so the backward, run on bf16 copies of
the parameters and bf16 features, while the master parameters, the Adam
state, the logits and the loss stay f32.  The assembly then writes its
features as bf16 (the same launch), and the block kernels run on bf16 rows;
the block backward adds into an f32 table and rounds it in a second
launch, so a bf16 GraphSAGE step launches 5 kernels (GCN and GIN 8; GAT
7, since ``scatter_add_rows`` rounds inside its one launch).

The optimizer is Adam with its learning rate a 0-d f32 tensor on the
parameters' device, under ``train.lr_schedule``: ``"none"`` keeps it
fixed, ``"cosine"`` (the JAX package's ``optax.cosine_decay_schedule(lr,
lr_decay_steps, alpha=0.05)``) sets it on the device before each update
from ``TrainState.step_t``, the device count of updates applied.  Nothing
is read back, so a step captured in a CUDA graph replays the schedule.
On CUDA the optimizer is ``capturable`` (its step counts on the device too),
eager and replayed alike; on the CPU it is not (PyTorch refuses it there),
with the same tensor learning rate.

The host path's dispatch (the JAX package's ``make_packed_train_step`` and
``make_multistep_train_step``): a step reads one packed batch
(``sampling/pack.py``) and adds its loss and accuracy into a device
accumulator; K steps run over a group of K batches stacked ``[K, ...]``.
The eager form is K calls of :func:`train_step`, the same arithmetic; the
graph form (:class:`GroupGraphs`) captures the K-step body as one CUDA
graph (:class:`CapturedGraph`) a ``(k, layout)`` key over static device
buffers, at the key's first group, and replays it for every later group
with that key, the group copied into its buffers first.

Phase marks (:func:`mark_phase`, ``ops.gather_kernels.mark``): a step
marks where its phases start, ``fetch`` (the assembly), ``forward`` (with
the loss), ``backward``, ``sync`` (under a ``grad_sync``), ``optimizer``
and ``accumulate``; the on-device epoch adds ``epoch``, ``sample`` and
``epoch_end``.  ``TrainState.trace_marks`` is the switch (the Trainer's
``PhaseTimers.use_scopes``): eager steps launch the markers only when it is
on; a captured graph holds them always and enables them for its replays
only while it is on (``CapturedGraph.marks``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..config import Config
from ..models import get_model
from ..ops import gather_kernels
from ..sampling.block import MiniBatch
from ..sampling.pack import BatchLayout, PackedGroup, unpack
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
    # data-parallel training: the gradients' mean over the process group
    # (parallel/train_step.py GradSync), whose flat buffer the .grad views
    # keep: zeroed in place, never set to None
    grad_sync: Optional[object] = None
    # the phase marks' switch (mark_phase), set from the Trainer's
    # PhaseTimers.use_scopes at each epoch's enqueue
    trace_marks: bool = False

    def __post_init__(self):
        if self.step_t is None:
            self.step_t = torch.zeros((), dtype=torch.int64,
                                      device=next(self.model.parameters()).device)


def layer0_fields(cfg: Config) -> List[str]:
    """The store fields the layer-0 table holds, in the cache's order:
    ``features``, and ``neigh`` under GraphSAGE preprocess."""
    m = cfg.model
    return ["features", "neigh"] if m.arch == "graphsage" and m.preprocess else ["features"]


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
        if kw.get("neigh_feats") is not None:
            kw["neigh_feats"] = kw["neigh_feats"].to(dtype)
        return torch.func.functional_call(model, params, (mb, feats.to(dtype)), kw).float()

    return apply


def cast_cv_apply(model: nn.Module, dtype: torch.dtype) -> Callable:
    """:func:`cast_apply` for CV-GCN's ``(logits, new_hists)`` forward (the
    JAX package's ``cast_cv_apply``): the history slices are cast to
    ``dtype`` too, and the logits and the fresh histories come back f32
    (they are scattered into f32 history state).  The model itself for
    f32."""
    if dtype == torch.float32:
        return model

    def apply(mb: MiniBatch, feats: torch.Tensor, *, h_hist, agg_hist, **kw):
        params = {name: p.to(dtype) for name, p in model.named_parameters()}
        kw.update(h_hist=[h.to(dtype) for h in h_hist],
                  agg_hist=[a.to(dtype) for a in agg_hist])
        logits, new_hists = torch.func.functional_call(model, params, (mb, feats.to(dtype)),
                                                       kw)
        return logits.float(), [h.float() for h in new_hists]

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


def mark_phase(state: Optional[TrainState], phase: str) -> None:
    """Mark where ``phase`` of a step starts on the state's device
    (``gather_kernels.mark``): eagerly when ``state.trace_marks``, always
    under capture; nothing without a state."""
    if state is not None:
        gather_kernels.mark(phase, state.step_t.device, state.trace_marks)


def train_step(state: TrainState, mb: MiniBatch, miss_feats: torch.Tensor,
               src_row: torch.Tensor, cache_values: torch.Tensor,
               dequant_scale: Optional[torch.Tensor] = None,
               hists: Optional[Tuple[List[torch.Tensor], List[torch.Tensor]]] = None,
               ) -> Dict[str, torch.Tensor]:
    """One optimizer step on a device minibatch, its plan's miss rows and
    ``src_row`` (:class:`FetchPlan`), the cache rows and, for the int8
    tier, the cache's dequant scale; returns ``{"loss", "acc"}`` as device
    scalars (no host sync).  The features are assembled in the compute
    dtype.  CV-GCN's step (the JAX package's ``make_cv_train_step``, one
    eager dispatch a batch) also takes the batch's history slices,
    ``hists``, and returns the fresh histories (:func:`train_on_features`)."""
    mark_phase(state, "fetch")
    feats = assemble_features(cache_values, src_row, miss_feats, dequant_scale,
                              out_dtype=state.dtype)
    return train_on_features(state, mb, feats, hists)


def train_on_features(state: TrainState, mb: MiniBatch, feats: torch.Tensor,
                      hists: Optional[Tuple[List[torch.Tensor], List[torch.Tensor]]] = None,
                      ) -> Dict[str, torch.Tensor]:
    """The step after the layer-0 fetch: forward, masked cross-entropy,
    backward and Adam on the layer-0 table ``feats`` (f32, or bf16 at bf16
    compute; under GraphSAGE preprocess ``[features | neigh]``,
    :func:`layer0_fields`),
    through :func:`cast_apply`; ``{"loss", "acc"}`` as device scalars (no
    host sync).  CV-GCN takes ``hists``, its ``(h_hist, agg_hist)`` slices,
    runs through :func:`cast_cv_apply` and adds ``"new_hists"``, the fresh
    f32 activations a block (the JAX package's ``make_cv_train_step``).
    Marks the phases ``forward`` (with the loss), ``backward``, ``sync``
    (under a ``grad_sync``), ``optimizer`` and ``accumulate`` (the
    accuracy, and what the caller adds up after it)."""
    m = state.model.cfg
    mark_phase(state, "forward")
    kw = {}
    if m.arch == "graphsage" and m.preprocess:
        feats, kw["neigh_feats"] = feats[:, :m.feat_dim], feats[:, m.feat_dim:]
    new_hists = None
    if hists is not None:
        logits, new_hists = cast_cv_apply(state.model, state.dtype)(
            mb, feats, generator=state.generator, h_hist=hists[0], agg_hist=hists[1])
    else:
        logits = cast_apply(state.model, state.dtype)(mb, feats, generator=state.generator,
                                                      **kw)
    loss = masked_cross_entropy(logits, mb.labels, mb.seed_mask)
    mark_phase(state, "backward")
    _zero_grads(state)
    loss.backward()
    if state.grad_sync is not None:
        mark_phase(state, "sync")
        state.grad_sync.sync()          # the mean over the ranks, before Adam
    mark_phase(state, "optimizer")
    if state.lr_schedule is not None:
        state.optimizer.param_groups[0]["lr"].copy_(state.lr_schedule(state.step_t))
    state.optimizer.step()
    state.step_t.add_(1)
    state.step += 1
    mark_phase(state, "accumulate")
    with torch.no_grad():
        acc = masked_accuracy(logits, mb.labels, mb.seed_mask)
    out = {"loss": loss.detach(), "acc": acc}
    if new_hists is not None:
        out["new_hists"] = new_hists
    return out


def _zero_grads(state: TrainState) -> None:
    """Gradients freed before a backward, or zeroed in place under a
    ``grad_sync`` (its views must stay)."""
    if state.grad_sync is None:
        state.optimizer.zero_grad(set_to_none=True)
    else:
        state.grad_sync.zero_()


# -- CUDA graphs ---------------------------------------------------------------

class CapturedGraph:
    """``fn`` captured as a CUDA graph; calling it replays the graph and
    returns what ``fn`` returned at capture (its static outputs).

    ``launches``: the gather-kernel launches one replay makes.  A wrapper
    counts a launch (``gather_kernels.LAUNCHES``) when it enqueues it, which
    under capture is once, into the graph; a replay runs the kernels again
    and counts nothing, so a run's launches are those counted eagerly plus
    ``launches`` times ``replays`` for each graph; ``units`` likewise the
    units a replay draws (``gather_kernels.DRAWN_UNITS``).  ``generator``, a
    CUDA generator that ``fn`` draws from, is registered with the graph:
    each replay draws what ``fn`` would draw eagerly from the generator's
    state then, and advances it as far.  That holds for torch's draws and
    for the keep-mask kernel's (``gather_kernels.dropout_bits``), which read
    the generator's seed and offset from ``draws.state``: written on the
    current stream before each replay, the generator advanced after it
    (:class:`gather_kernels.GraphDraws`; one graph holds one kind of draw).
    ``after`` runs on the host after each replay (the host step count).
    The capture checks only its own thread's CUDA calls
    (``capture_error_mode="thread_local"``), so other threads (the loader's
    producers) run on meanwhile.

    ``marks``: the phase marks ``fn`` captured (``gather_kernels.mark``
    launches them under capture whatever the switch), found once in the
    graph (:class:`gather_kernels.GraphMarks`), disabled until its owner
    enables them for traced replays."""

    def __init__(self, fn: Callable, *, generator: Optional[torch.Generator] = None,
                 stream: Optional[torch.cuda.Stream] = None, pool=None,
                 after: Optional[Callable[[], None]] = None):
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        self.draws = None
        if generator is not None:
            self.graph.register_generator_state(generator)
            self.draws = gather_kernels.GraphDraws(generator)
        before = gather_kernels.launch_counts()
        with torch.cuda.graph(self.graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"), \
                gather_kernels.capturing_draws(self.draws):
            self.out = fn()
        after_capture = gather_kernels.launch_counts()
        self.launches = {k: v - before[k] for k, v in after_capture.items() if v != before[k]}
        self.units = 0 if self.draws is None else self.draws.units
        self.graph.instantiate()
        self.marks = gather_kernels.GraphMarks(self.graph)
        self.marks.set(False)
        self.replays = 0
        self._after = after

    def __call__(self):
        offset = None if self.draws is None else self.draws.before_replay()
        self.graph.replay()
        if self.draws is not None:
            self.draws.after_replay(offset)
        self.replays += 1
        if self._after is not None:
            self._after()
        return self.out


def capture_train(state: TrainState, fn: Callable, steps: int, **kw) -> CapturedGraph:
    """Capture ``fn``, which makes ``steps`` optimizer steps: gradients
    freed first (the graph allocates its own; under a ``grad_sync`` they
    stay its buffer's views, outside the graph's pool), the dropout
    generator registered, and the host step count left as it was (the
    capture ran the Python, not the kernels) and advanced by ``steps`` at
    each replay."""
    _zero_grads(state)
    step = state.step
    try:
        g = CapturedGraph(fn, generator=state.generator, after=lambda: _advance(state, steps),
                          **kw)
    finally:
        state.step = step
    return g


def _advance(state: TrainState, steps: int) -> None:
    state.step += steps


# -- the host path's dispatch --------------------------------------------------

def make_packed_train_step(state: TrainState, cache_values: torch.Tensor,
                           dequant_scale: Optional[torch.Tensor] = None) -> Callable:
    """``step(layout, acc, i32, u8, miss)``: one optimizer step on one packed
    batch on the device (unpacked with static views, :func:`pack.unpack`),
    its loss and accuracy added into ``acc`` (f32 ``[2]``); nothing waits
    for the device."""

    def step(layout: BatchLayout, acc: torch.Tensor, i32: torch.Tensor, u8: torch.Tensor,
             miss: torch.Tensor) -> None:
        mb, src_row, miss = unpack(layout, i32, u8, miss)
        m = train_step(state, mb, miss, src_row, cache_values, dequant_scale)
        acc.add_(torch.stack([m["loss"], m["acc"]]))

    return step


def make_multistep_train_step(state: TrainState, cache_values: torch.Tensor,
                              dequant_scale: Optional[torch.Tensor] = None, *,
                              graph: bool = False,
                              stream: Optional[torch.cuda.Stream] = None):
    """``steps(group, acc)``: ``group.k`` optimizer steps over a host
    :class:`PackedGroup` (pinned for the card), each batch's miss rows its
    first rows of ``group.miss[k]``.  Both forms copy the group to
    ``cache_values``' device on the current stream first.  The eager form
    (``graph=False``) then runs the steps one after the other; the graph
    form is a :class:`GroupGraphs` (captured on ``stream``)."""
    step = make_packed_train_step(state, cache_values, dequant_scale)

    def on_device(group: PackedGroup, acc: torch.Tensor) -> None:
        for k in range(group.k):
            step(group.layout, acc, group.i32[k], group.u8[k], group.miss[k])

    if graph:
        return GroupGraphs(on_device, state, cache_values, stream=stream)

    def steps(group: PackedGroup, acc: torch.Tensor) -> None:
        on_device(group.to(cache_values.device, non_blocking=True), acc)

    return steps


class GroupGraphs:
    """The graph form of :func:`make_multistep_train_step`: one
    :class:`CapturedGraph` of the K-step body a ``(k, layout)`` key (the
    layout holds the group's miss bucket), over static device buffers of
    the key's shapes, as the JAX package compiles one executable a layout.

    ``capture(group, acc)`` allocates the key's buffers and captures the
    body over them on ``stream``; it neither copies the group in nor runs
    the steps.
    ``graphs(group, acc)`` copies a host group (pinned) into its key's
    buffers on the current stream and replays the graph on the same stream,
    so the copy of the next group is ordered after this replay.  Every
    graph accumulates into the one ``acc`` given at the first capture, and
    reads ``cache_values`` at the address it had then.  All graphs share one
    memory pool: they never run at once, and none reads another's output
    (what passes between steps, the parameters, Adam's state and ``acc``,
    lives outside the pool).  A capture runs while the loader's producer
    threads work (:class:`CapturedGraph` checks only its own thread)."""

    def __init__(self, steps: Callable, state: TrainState, cache_values: torch.Tensor, *,
                 stream: Optional[torch.cuda.Stream] = None):
        self._steps, self.state, self.cache_values = steps, state, cache_values
        self.stream = stream
        self.pool = torch.cuda.graph_pool_handle()
        self._entries: Dict[Tuple[int, BatchLayout], Tuple[CapturedGraph, PackedGroup]] = {}
        self._acc: Optional[torch.Tensor] = None

    @staticmethod
    def key(group: PackedGroup) -> Tuple[int, BatchLayout]:
        return group.k, group.layout

    def needs_capture(self, group: PackedGroup) -> bool:
        return self.key(group) not in self._entries

    def capture(self, group: PackedGroup, acc: torch.Tensor) -> None:
        if self._acc is None:
            self._acc = acc
        self._check_acc(acc)
        dev = self.cache_values.device
        static = PackedGroup(group.layout, *(torch.empty(t.shape, dtype=t.dtype, device=dev)
                                             for t in (group.i32, group.u8, group.miss)))
        g = capture_train(self.state, lambda: self._steps(static, acc), group.k,
                          stream=self.stream, pool=self.pool)
        self._entries[self.key(group)] = (g, static)

    def __call__(self, group: PackedGroup, acc: torch.Tensor) -> None:
        self._check_acc(acc)
        self.load(group)()

    def load(self, group: PackedGroup) -> CapturedGraph:
        """Copy a host group into its key's buffers on the current stream
        and return the key's graph, each call of which replays the group's
        steps from those buffers (captured now, into the accumulator of the
        first capture, if the key is new), its phase marks switched to
        ``state.trace_marks``."""
        if self.needs_capture(group):
            if self._acc is None:
                raise RuntimeError("no host-step graph was captured yet")
            self.capture(group, self._acc)
        g, static = self._entries[self.key(group)]
        for dst, src in ((static.i32, group.i32), (static.u8, group.u8),
                         (static.miss, group.miss)):
            dst.copy_(src, non_blocking=True)
        g.marks.set(self.state.trace_marks)
        return g

    def _check_acc(self, acc: torch.Tensor) -> None:
        if acc is not self._acc:
            raise ValueError("the host-step graphs accumulate into the tensor given at "
                             "their first capture")

    @property
    def graphs(self) -> List[CapturedGraph]:
        return [g for g, _ in self._entries.values()]

    @property
    def keys(self) -> List[Tuple[int, BatchLayout]]:
        return list(self._entries)


    def replayed_launches(self) -> Dict[str, int]:
        """Gather-kernel launches made by the replays so far."""
        out: Dict[str, int] = {}
        for g in self.graphs:
            for k, v in g.launches.items():
                out[k] = out.get(k, 0) + v * g.replays
        return out
