#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pagraph_tpu_torch``) on one GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, each printed as one JSON line:

* ``device``: ``torch.cuda.get_device_name()`` and nvidia-smi's name and
  power limit (the raw nvidia-smi line is printed too);
* ``build``: nvcc builds the kernels from ``pagraph_tpu_torch/csrc``;
* ``train``: the main path — cache-backed GraphSAGE at the ``bench.py``
  width (2 layers, hidden 16, 100-dim features, 47 classes, batch 6000,
  fan-out 2, Adam lr 1e-2) on an RMAT scale-20 graph (1,048,576 vertices,
  ~16.08M edges) with the cache at 40% capacity, 2 epochs through
  ``Trainer.from_dataset`` at the JAX package's defaults (the native
  sampler, ``backend="auto"``; ``steps_per_dispatch=8``: epoch 0 eager,
  epoch 1 replayed from the host-step CUDA graphs), with each kernel's
  launches run (those counted eagerly plus each graph's captured launches
  times its replays); then one epoch with the ``gcn`` aggregator, the path
  of the ``sum`` kind;
* ``tiers``: one epoch of the same configuration at each cache tier
  (``cache.dtype`` float32, bfloat16, int8), each a fresh ``Trainer``
  (seed 0) at 40% capacity: epoch time, edges/s, miss rate (equal to the
  f32 run's epoch 0: the same batches), bytes shipped host -> device, the
  cache's device bytes and each kernel's launches (4 a step);
* ``bf16_train``: the host path at bf16 compute (``train.dtype="bfloat16"``)
  with the bf16 cache tier at 40% capacity, 2 epochs (epoch 1 replayed; the
  loss must fall,
  the miss rate equal the f32 run's), then one ``gcn`` epoch over the f32
  tier: epoch time, edges/s, miss rate, bytes shipped, and 5 launches a
  step, all bf16 (``assemble_<tier>_to_bf16``, two
  ``block_gather_fwd_<kind>_bf16``, one ``block_gather_bwd_<kind>_bf16``
  and the ``grad_to_bf16`` that rounds its f32 table, in the same C call);
* ``store_int8``: ``quantize_store`` of the f32 store, then a ``Trainer``
  over it at the int8 tier (one epoch at bf16 compute): its setup (no scale
  pass) beside the f32 store's int8 setup in ``tiers``, its miss rate and
  bytes shipped (equal to that run's), its scale and cache rows (equal),
  and the loader alone over both stores, in turns;
* ``host_dispatch``: the host path at the JAX package's defaults.  The
  loader alone (sampling, plan, miss gather, pack, groups stacked in pinned
  memory) for an epoch with the numpy and with the native sampler, in
  turns, and the OpenMP setting; then fresh Trainers (seed 0) of the chip
  configuration: ``steps_per_dispatch`` 8 replayed from CUDA graphs (3
  epochs, epoch 0 eager), twice the eager form of K=8 (the eager spread),
  the eager and the graph form of K=1, at bf16 compute over the bf16
  tier K=8 replayed and twice eager, and with ``cache.rank_by=
  "access_freq"`` (the cache refilled after epoch 0) K=8 replayed and
  eager.  For each: epoch time, edges/s, host enqueue ms a step, device ms
  a step (one more group behind a device sleep) and the busy share,
  capture seconds, graphs and their ``(k, bucket)`` keys, miss rate and
  bytes shipped, peak device bytes and launches; and the first and the
  last (partial) group of a further epoch, each dispatched three times
  from the same state (replayed, then twice eager).  It fails unless every
  sampler is native, every run launches 4 kernels a step (5 at bf16
  compute) and a replay those 4 (5), the runs' batches, edges and miss
  rates equal their graph run's (and bytes shipped at the same K), the
  access-frequency graphs read the refilled cache, each replayed group's
  loss is within 1e-6 relative of the eager form's (or the eager spread,
  if larger) and every parameter within 1e-5 of its norm (or the spread),
  the bf16 replayed run's losses and parameters equal the eager run's to
  the bit, and the loss falls.  At f32 the whole runs' losses and
  parameters are reported, not held: their eager epoch 0 may already
  differ (the block backward's atomics add in their own order);
* ``device_epoch``: the whole-epoch on-device path (``train.on_device_sampling``)
  of the same configuration with the full cache and the CSR on the card,
  each run a fresh ``Trainer`` (seed 0) for 2 epochs, the first eager and
  the second replayed from the CUDA graphs of its ``epoch_dispatch``: f32
  with generic draws (``scan``), f32 with paired draws (``steps``), bf16
  (``pipelined``) and int8 (``steps``) with paired draws, and bf16 with
  paired draws at bf16 compute (``pipelined``); the loss must fall.  Setup,
  capture and epoch time, edges/s (every valid slot of the undeduplicated
  layers: not the host path's count), batches, loss, cache and CSR bytes,
  peak device memory, and the launches run (those counted eagerly plus
  each graph's captured launches times its replays): one
  ``assemble_<tier>`` (at bf16 compute ``assemble_<tier>_to_bf16``) a step
  and no other gather kernel;
* ``dispatch``: every ``epoch_dispatch`` mode (``scan``, ``steps``,
  ``pipelined``) on six runs (f32 generic, f32 paired, the bf16 and int8
  tiers paired, bf16 compute on the bf16 tier, and f32 with the cosine
  schedule over 150 of its 228 updates), each 2 epochs through the
  ``Trainer`` (epoch 1 replayed) against a fresh Trainer's 2 epochs through
  the same function's eager form from the same seed, and a second eager run
  for the eager spread: capture time, epoch time and host enqueue replayed
  (the first replay, which also uploads the graphs, and a third epoch) and
  eager, device time a step (CUDA events behind a device sleep: a fourth,
  replayed, epoch; the eager step's alone), the device's busy share (that
  device time over the third epoch's, or the eager epoch's, wall time),
  replayed gather launches a step, peak device bytes, and the loss and
  parameter differences replay against eager and eager against eager.  It
  fails unless steps, edges and vertices are equal, each epoch's loss is
  within 1e-4 relative (or the eager spread, if larger), every parameter
  within 1e-3 of its norm, one ``assemble_<tier>`` replays a step, and the
  loss falls;
* ``kernels``: every kernel on a batch of that run at its main-path shapes,
  against its plain PyTorch version on the card (gathered rows exact,
  reductions within 1e-6 of the output's scale, the atomic backwards within
  1e-5), timed with CUDA events (L2 flushed between launches) beside its
  plain version, one PyTorch library call where one computes the same
  function, and its device-memory bound.  The fused block forward
  (``block_gather_fwd``, both outputs) and its single-half uses
  (``gather_rows``, ``gather_reduce``) are one kernel, as are the fused
  block backward (``block_gather_bwd``) and its single-half uses
  (``scatter_add_rows``, ``gather_reduce_bwd``).  The assembly
  (``assemble``) is one kernel for the three cache tiers, each timed on
  that tier's cache and plan of the batch; ``assemble_full[tier]`` is the
  on-device path's layer-0 fetch (``ops.gather.take_rows``: the assembly
  with no miss rows) from the full cache at a device-sampled batch's 54,000
  rows, its ``library_ms`` ``index_select`` at f32.  No one PyTorch call
  computes a fused case: its ``library_ms`` times the calls that compute
  each output from pre-flattened inputs (for the forward ``index_select`` +
  ``embedding_bag``; for the backwards the ``index_add_`` calls into a
  buffer that is never zeroed, with the division and expansion done outside
  the timed call).  The fused cases, the single-half backwards and the
  assembly (``library_ms`` null) also get ``library_same_fn_ms``: the same
  function in PyTorch calls from the kernel's own inputs.  A bound counts
  each index and each output once and each distinct source row a launch
  reads once (a row that repeats, or is both a self and a neighbor row, is
  one read), at the rows' own width.  The bf16 entries
  (``block_gather_fwd_<kind>_bf16[block0|1]``,
  ``block_gather_bwd_<kind>_bf16[block1]``, ``assemble[<tier>->bf16]``,
  ``assemble_full[bf16->bf16]``) run the same batch at bf16 compute: the
  forward's neighbor half and the backward within 1e-2 of each element
  plus 1e-2 of max|plain|, rows and the assembly exact;
* ``fwd_branches``: the block forward and backward on the card, on f32 and
  on bf16 rows, at the branches the main path does not take -- D = 30
  (scalar rows), a table one element off its unit's alignment, fan-out 7
  (no unrolled instantiation), each half absent -- against their plain
  versions;
* ``assemble_branches``: the assembly at each tier, to f32 and to bf16,
  where the main path does not go -- D = 30 (scalar units), a table one
  element off its unit's alignment, D = 600 (several units a lane), no
  miss rows, every row a miss, every row a hit -- exact against its plain
  version;
* ``graph_block_kernels``: the host path's block forward and backward
  (``ops.aggregate.block_gather``, the backward launched from autograd's
  thread) captured in a CUDA graph and replayed, against the eager call;
* ``timing_floor``: the same timing around no work, around the block
  backward's memset alone, and around a contiguous device copy that moves
  the block-0 forward's bound bytes (half read, half written): what the
  card streams for those bytes with no gather;
* ``step_parity``: one train step from the same parameters and batch at
  each cache tier, through the kernels and through the plain versions:
  loss and every gradient within 1e-5 relative (atomic summation order),
  4 kernel launches (the assembly, two fused block forwards, one fused
  block backward);
* ``bf16_step_parity``: one bf16-compute step at each cache tier through
  the kernels and through the plain versions: loss within 1e-2 relative,
  each gradient within ``||g - g_plain|| <= 2e-2 ||g_plain||``, 5 bf16
  launches, the assembly to bf16 bit-equal;
* ``breakdown``: where the epoch's time goes — an epoch of the loader alone
  (host sampling, miss gather, pinned H2D), and one train step alone on a
  shipped batch (host enqueue time, wall time, device time), at f32 and at
  bf16 compute;
* ``device_sampler_parity``: one batch sampled on the card and the same
  draws through the same function on CPU copies, generic and paired: equal
  ids, masks, labels and blocks;
* ``device_step_parity``: one device-sampled step at each tier through the
  kernel and under ``gather_kernels.plain_versions()`` from the same
  parameters: loss and every gradient within 1e-5 relative, one assembly
  launch through the kernel and none under the plain versions;
* ``device_breakdown``: one on-device step alone and its parts (sample,
  fetch, train), and one replay of the ``steps`` mode's step graph:
  host enqueue, wall and device time (CUDA events), CUDA kernels and memory
  operations counted with ``torch.profiler``, and that a step never
  synchronizes with the host (``torch.cuda.set_sync_debug_mode``).

Any failed check exits non-zero without the final line.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import contextlib
import copy
import gc
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# bytes per second of device memory, by card
HBM_BYTES_PER_S = {"sxm": 3.35e12, "pcie": 2.0e12}
PALLAS = "pagraph_tpu/ops/pallas_gather.py"
SOURCE = "pagraph_tpu_torch/csrc/gather_kernels.cu"
# the cache tiers (cache.dtype) and their tags in the kernel names and counters
TIERS = {"float32": "f32", "bfloat16": "bf16", "int8": "int8"}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(key: str, value) -> None:
    print(json.dumps({key: value}), flush=True)


def time_ms(torch, fn, flush_buf, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` per call: CUDA events around each call,
    the L2 cache flushed (a write of > 50 MB) before each one.  A ~0.5 ms
    device sleep ahead of each start event keeps the stream busy while the
    host enqueues the call, so the wrapper's host overhead is not timed."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush_buf.zero_()
        torch.cuda._sleep(1_000_000)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


TOLERANCES = {"exact": 0.0, "reduce": 1e-6, "atomic": 1e-5, "bf16": 1e-2}


def compare(torch, out_k, out_p, tol):
    """(max abs error, within tolerance, text) of a kernel's output(s)
    against the plain version's; ``tol`` names a TOLERANCES entry, or one
    per output when the outputs are a tuple.  Each output is held to its
    tolerance times its own scale, max|plain|; ``bf16`` (a reduction or a
    gradient table in bf16) element by element to 1e-2 of the element plus
    1e-2 of that scale."""
    torch.cuda.synchronize()
    if not isinstance(out_k, tuple):
        out_k, out_p, tol = (out_k,), (out_p,), (tol,)
    err, ok, text = 0.0, True, []
    for k, p, t in zip(out_k, out_p, tol):
        if k.dtype != p.dtype:
            return float("inf"), False, f"dtype {k.dtype} != plain {p.dtype}"
        diff = (k.float() - p.float()).abs()
        e = diff.max().item() if p.numel() else 0.0
        scale = max(p.float().abs().max().item() if p.numel() else 0.0, 1e-30)
        r = TOLERANCES[t]
        if t == "bf16":
            good = bool((diff <= r * p.float().abs() + r * scale).all()) if p.numel() else True
            text.append(f"bf16: |err| <= {r} * |plain| + {r} * max|plain| ({scale:.6g})")
        else:
            good = e <= r * scale
            text.append(f"{t}: |err| <= {r} * max|plain| ({scale:.6g})")
        err, ok = max(err, e), ok and good
    return err, ok, "; ".join(text)


def fwd_branches(torch, gk, dev):
    """The block forward and backward against their plain versions where the
    main path does not go, on f32 and on bf16 rows: D = 30 (scalar rows), a
    source table and incoming gradients one element off their unit's
    alignment (scalar rows at D = 32), fan-out 7 (the runtime-fan-out
    instantiation), each with both halves, the self half alone and the
    neighbor half alone, both kinds.  Positions repeat and overlap; 10 rows
    have no valid slot."""
    gen = torch.Generator(device=dev).manual_seed(5)
    n_src, n = 3000, 2000
    out = []
    for (label, d, f, off), dtype in ((c, t) for t in (torch.float32, torch.bfloat16)
                                      for c in (("D=30", 30, 2, 0), ("offset table", 32, 2, 1),
                                                ("fan-out 7", 32, 7, 0),
                                                ("D=30 fan-out 7", 30, 7, 0))):
        tag = "" if dtype == torch.float32 else " bf16"
        red_tol, bwd_tol = ("reduce", "atomic") if dtype == torch.float32 else ("bf16", "bf16")

        def table(rows):
            flat = torch.randn(rows * d + off, generator=gen, device=dev).to(dtype)
            return flat[off:].view(rows, d)
        src, g_self, g_neigh = table(n_src), table(n), table(n)
        self_pos = torch.randint(0, n_src, (n,), generator=gen, device=dev,
                                 dtype=torch.int32)
        pos = torch.randint(0, n_src, (n, f), generator=gen, device=dev,
                            dtype=torch.int32)
        pos[::2, 0] = self_pos[::2]
        mask = torch.rand(n, f, generator=gen, device=dev) > 0.3
        mask[:10] = False
        for kind in gk.KINDS:
            for halves in ("both", "self", "neigh"):
                sp = self_pos if halves != "neigh" else None
                p, m = (pos, mask) if halves != "self" else (None, None)
                gs = g_self if sp is not None else None
                gn = g_neigh if p is not None else None
                fwd_k = gk.block_gather_fwd(src, sp, p, m, kind)
                fwd_p = gk.block_gather_fwd_plain(src, sp, p, m, kind)
                tols = tuple(t for t, h in zip(("exact", red_tol), fwd_k) if h is not None)
                fwd_k = tuple(h for h in fwd_k if h is not None)
                fwd_p = tuple(h for h in fwd_p if h is not None)
                for what, got, want, tol in (
                        ("fwd", fwd_k, fwd_p, tols),
                        ("bwd", gk.block_gather_bwd(gs, sp, gn, p, m, n_src, kind),
                         gk.block_gather_bwd_plain(gs, sp, gn, p, m, n_src, kind), bwd_tol)):
                    err, ok, text = compare(torch, got, want, tol)
                    out.append({"case": f"{what} {kind} {label} {halves}{tag}",
                                "max_abs_err": err, "ok": ok, "tolerance": text})
    return out


def assemble_branches(torch, gk, dev):
    """The assembly against its plain version, exact, at each tier and with
    an f32 and a bf16 output, where the main path does not go: D = 30
    (scalar units), tables one element off their unit's alignment (scalar
    units at D = 100), D = 600 (several units a lane), no miss rows, every
    row a miss, every row a hit."""
    gen = torch.Generator(device=dev).manual_seed(6)
    n, cap = 2000, 3000
    out = []
    for label, d, off, n_miss in (("D=30", 30, 0, 1024), ("offset tables", 100, 1, 1024),
                                  ("D=600", 600, 0, 1024), ("no miss rows", 100, 0, 0),
                                  ("all misses", 100, 0, 2048), ("all hits", 100, 0, 1024)):
        for dtype, tag in TIERS.items():
            row_dtype = getattr(torch, dtype)

            def table(rows):
                if row_dtype == torch.int8:
                    flat = torch.randint(-127, 128, (rows * d + off,), generator=gen,
                                         device=dev, dtype=torch.int32).to(torch.int8)
                else:
                    flat = torch.randn(rows * d + off, generator=gen, device=dev).to(row_dtype)
                return flat[off:].view(rows, d)
            cv, mf = table(cap), table(n_miss)
            hit = torch.rand(n, generator=gen, device=dev) < 0.6
            if label == "all misses":
                hit[:] = False
            elif label in ("all hits", "no miss rows"):
                hit[:] = True
            src_row = torch.where(
                hit, torch.randint(0, cap, (n,), generator=gen, device=dev),
                -1 - torch.randint(0, max(n_miss, 1), (n,), generator=gen, device=dev)
            ).to(torch.int32)
            scale = (torch.rand(d, generator=gen, device=dev) / 127 + 1e-3
                     if row_dtype == torch.int8 else None)
            for out_dtype, out_tag in ((torch.float32, ""), (torch.bfloat16, "->bf16")):
                err, ok, text = compare(
                    torch, gk.assemble(cv, src_row, mf, scale, out_dtype=out_dtype),
                    gk.assemble_plain(cv, src_row, mf, scale, out_dtype=out_dtype), "exact")
                out.append({"case": f"assemble[{tag}{out_tag}] {label}", "max_abs_err": err,
                            "ok": ok, "tolerance": text})
    return out


def build_dataset(np, synthetic, Dataset, CSRGraph):
    """The bench.py graph: RMAT scale 20, edge factor 16, seed 42; 100-dim
    uniform features and 47-class labels argmax(feats @ proj) (seed 7);
    random 65/10/25 split (seed 11)."""
    graph = CSRGraph.from_coo(synthetic.rmat_coo(20, 16, seed=42))
    rng = np.random.default_rng(7)
    feats = rng.random((graph.num_nodes, 100), dtype=np.float32)
    proj = rng.normal(size=(100, 47)).astype(np.float32)
    labels = np.argmax(feats @ proj, axis=1).astype(np.int64)
    train, val, test = synthetic.random_split_masks(graph.num_nodes, seed=11)
    return Dataset(graph, feats, labels, train, val, test)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    try:
        import numpy as np

        import pagraph_tpu_torch as pt
        from pagraph_tpu_torch.data import synthetic
        from pagraph_tpu_torch.data.formats import Dataset
        from pagraph_tpu_torch.graph import CSRGraph
        from pagraph_tpu_torch.ops import _build
        from pagraph_tpu_torch.ops import gather_kernels as gk
        from pagraph_tpu_torch.ops.gather import take_rows
        from pagraph_tpu_torch.sampling.device_sampler import (DeviceCSR, hop_draws,
                                                               hop_sizes,
                                                               sample_minibatch_device)
        from pagraph_tpu_torch.storage.feature_store import FeatureStore, quantize_store
        from pagraph_tpu_torch.ops.aggregate import block_gather
        from pagraph_tpu_torch.sampling.block import Block
        from pagraph_tpu_torch.sampling.pack import PackedGroup
        from pagraph_tpu_torch.train.device_epoch import (DeviceEpochRunner,
                                                          EpochAccumulator,
                                                          device_batch_step,
                                                          epoch_schedule, fetch_batch,
                                                          make_device_step_fns,
                                                          train_batch)
        from pagraph_tpu_torch.train.loop import Trainer
        from pagraph_tpu_torch.train.state import (TrainState, make_multistep_train_step,
                                                   make_optimizer, train_step)
    except ImportError as e:
        fail(f"cannot import the port ({e}); run from the repository root")
    if os.path.dirname(os.path.abspath(pt.__file__)) != os.path.join(HERE, "pagraph_tpu_torch"):
        fail(f"imported {pt.__file__}, not the package beside this script")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # -- device -------------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    smi_name, smi_power = (s.strip() for s in smi.split(",", 1))
    bw = HBM_BYTES_PER_S["pcie" if "pcie" in kind.lower() else "sxm"]
    emit("device", {"torch_name": kind, "nvidia_smi_name": smi_name,
                    "power_limit": smi_power, "count": torch.cuda.device_count(),
                    "hbm_bytes_per_s_for_bound": bw})

    # -- build --------------------------------------------------------------
    t0 = time.perf_counter()
    _build.load("gather_kernels")
    emit("build", {"seconds": time.perf_counter() - t0,
                   "flags": " ".join(_build.NVCC_FLAGS)})

    # -- train: the main path -----------------------------------------------
    t0 = time.perf_counter()
    ds = build_dataset(np, synthetic, Dataset, CSRGraph)
    data_s = time.perf_counter() - t0

    def config(aggregator: str, cache_dtype: str = "float32", *, on_device: bool = False,
               paired: bool = False, compute: str = "float32", dispatch: str = "scan",
               cosine_steps: int = 0):
        """The main path's configuration; ``on_device`` is the whole-epoch
        device path (full cache, ``paired`` draws, ``dispatch`` its
        ``train.epoch_dispatch``); ``compute`` is ``train.dtype``;
        ``cosine_steps`` > 0 the cosine schedule over that many updates."""
        return pt.Config(
            model=pt.ModelConfig(arch="graphsage", n_layers=1, hidden=16,
                                 feat_dim=100, n_classes=47,
                                 aggregator=aggregator, dropout=0.2),
            sampler=pt.SamplerConfig(batch_size=6000, fanout=2, num_hops=2,
                                     seed=0, prefetch=3, paired_draws=paired),
            cache=pt.CacheConfig(enabled=True,
                                 capacity=None if on_device else int(ds.num_nodes * 0.4),
                                 dtype=cache_dtype),
            train=pt.TrainConfig(lr=1e-2, warmup_epochs=1, on_device_sampling=on_device,
                                 dtype=compute, epoch_dispatch=dispatch,
                                 lr_schedule="cosine" if cosine_steps else "none",
                                 lr_decay_steps=cosine_steps),
        )

    def executed_launches(counted, runner):
        """The launches run since the counters' reset: ``counted`` (which
        counts a launch captured into a graph once, at capture) with each of
        ``runner``'s graphs' captured launches times its replays in place of
        that once (its graphs captured since the reset).  ``runner``: a
        ``DeviceEpochRunner``, a host Trainer's ``group_graphs``, or None."""
        out = dict(counted)
        for g in (runner.graphs if runner is not None else ()):
            for k, v in g.launches.items():
                out[k] += v * (g.replays - 1)
        return out

    def free_memory():
        gc.collect()
        torch.cuda.empty_cache()

    def host_step_ms(t_, runs):
        """Host enqueue ms a step of a host Trainer (its ``"step"`` timer
        over the steps of ``runs``: the dispatch of a group, its H2D copy
        included; a capture is timed apart)."""
        return t_.timers.total["step"] * 1e3 / sum(m.num_batches for m in runs)

    cfg = config("mean")
    t0 = time.perf_counter()
    tr = Trainer.from_dataset(cfg, ds, seed=0)
    tr._maybe_fill_cache()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    gk.reset_launch_counts()
    epochs = [tr.run_epoch(e) for e in range(2)]
    torch.cuda.synchronize()
    launches = executed_launches(gk.launch_counts(), tr.group_graphs)
    main_keys = ("assemble_f32", "block_gather_fwd_mean", "block_gather_bwd_mean")
    train_out = {
        "graph": {"vertices": ds.num_nodes, "edges": ds.graph.num_edges},
        "caps": list(tr.sampler.caps), "cache_capacity": tr.cache.capacity,
        "sampler_backend": tr.sampler.backend_name,
        "steps_per_dispatch": tr.steps_per_dispatch,
        "graphs": len(tr.group_graphs.graphs), "capture_s": tr.timers.total["capture"],
        "dataset_s": data_s, "setup_s": setup_s,
        "epochs": [{"epoch": m.epoch, "time_s": m.time_s,
                    "edges": m.edges, "edges_per_s": m.edges / m.time_s,
                    "miss_rate": m.miss_rate, "mean_loss": m.mean_loss,
                    "mean_acc": m.mean_acc, "batches": m.num_batches,
                    "h2d_bytes": m.h2d_bytes} for m in epochs],
        "step_host_ms": host_step_ms(tr, epochs),
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches,
    }
    gk.reset_launch_counts()
    tr_gcn = Trainer.from_dataset(config("gcn"), ds, seed=0)
    gcn_epoch = tr_gcn.run_epoch(0)
    torch.cuda.synchronize()
    gcn_launches = gk.launch_counts()
    del tr_gcn
    train_out["gcn_epoch"] = {"time_s": gcn_epoch.time_s,
                              "mean_loss": gcn_epoch.mean_loss,
                              "miss_rate": gcn_epoch.miss_rate,
                              "launches": gcn_launches}
    emit("train", train_out)
    for k in main_keys:
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched on the main path")
    for k in ("block_gather_fwd_sum", "block_gather_bwd_sum"):
        if gcn_launches[k] <= 0:
            fail(f"kernel {k} was not launched by the gcn-aggregator run")
    losses = [m.mean_loss for m in epochs] + [gcn_epoch.mean_loss]
    if not all(math.isfinite(v) for v in losses):
        fail(f"non-finite loss {losses}")
    if not epochs[1].mean_loss < epochs[0].mean_loss:
        fail(f"loss did not fall: {epochs[0].mean_loss} -> {epochs[1].mean_loss}")

    # -- tiers: one epoch at each cache tier, each a fresh Trainer -------------
    tier_tr, tier_launches, tiers_out = {}, {}, {}
    for dtype, tag in TIERS.items():
        t0 = time.perf_counter()
        t_tr = Trainer.from_dataset(config("mean", dtype), ds, seed=0)
        t_tr._maybe_fill_cache()
        torch.cuda.synchronize()
        t_setup = time.perf_counter() - t0
        gk.reset_launch_counts()
        m = t_tr.run_epoch(0)
        torch.cuda.synchronize()
        counts = gk.launch_counts()
        cv_t = t_tr.cache.cache_values
        tier_tr[dtype], tier_launches[dtype] = t_tr, counts
        tiers_out[dtype] = {
            "setup_s": t_setup, "time_s": m.time_s, "edges": m.edges,
            "edges_per_s": m.edges / m.time_s,
            "miss_rate": m.miss_rate, "mean_loss": m.mean_loss, "batches": m.num_batches,
            "h2d_bytes": m.h2d_bytes, "cache_dtype": str(cv_t.dtype),
            "cache_bytes": cv_t.numel() * cv_t.element_size(),
            "launches": {k: v for k, v in counts.items() if v},
            "launches_per_step": sum(counts.values()) / max(m.num_batches, 1)}
    emit("tiers", tiers_out)
    for dtype, tag in TIERS.items():
        t, counts = tiers_out[dtype], tier_launches[dtype]
        if t["miss_rate"] != epochs[0].miss_rate:
            fail(f"{dtype} tier: miss rate {t['miss_rate']} != the f32 run's "
                 f"{epochs[0].miss_rate} on the same batches")
        if not math.isfinite(t["mean_loss"]):
            fail(f"{dtype} tier: non-finite loss {t['mean_loss']}")
        if sum(counts.values()) != 4 * t["batches"] or counts[f"assemble_{tag}"] != t["batches"]:
            fail(f"{dtype} tier: launches {t['launches']} over {t['batches']} steps, "
                 "expected 4 a step with one assemble_" + tag)

    # -- bf16_train: the host path at bf16 compute -------------------------------
    # train.dtype="bfloat16" with the bf16 cache tier at 40%: 2 epochs of the
    # mean aggregator, then one epoch of gcn (the sum kind) over the f32 tier
    # (the assembly from f32 rows to bf16); 5 launches a step, all bf16 (the
    # backward's C call adds in an f32 table and rounds it: grad_to_bf16)
    bf_cfg = config("mean", "bfloat16", compute="bfloat16")
    t0 = time.perf_counter()
    bf_tr = Trainer.from_dataset(bf_cfg, ds, seed=0)
    bf_tr._maybe_fill_cache()
    torch.cuda.synchronize()
    bf_setup = time.perf_counter() - t0
    gk.reset_launch_counts()
    bf_epochs = [bf_tr.run_epoch(e) for e in range(2)]
    torch.cuda.synchronize()
    bf_launches = executed_launches(gk.launch_counts(), bf_tr.group_graphs)
    gk.reset_launch_counts()
    bf_gcn_tr = Trainer.from_dataset(config("gcn", "float32", compute="bfloat16"), ds, seed=0)
    bf_gcn_epoch = bf_gcn_tr.run_epoch(0)
    torch.cuda.synchronize()
    bf_gcn_launches = gk.launch_counts()
    del bf_gcn_tr
    bf_out = {
        "compute": "bfloat16", "cache_dtype": "bfloat16", "setup_s": bf_setup,
        "epochs": [{"epoch": m.epoch, "time_s": m.time_s, "edges": m.edges,
                    "edges_per_s": m.edges / m.time_s, "miss_rate": m.miss_rate,
                    "mean_loss": m.mean_loss, "mean_acc": m.mean_acc,
                    "batches": m.num_batches, "h2d_bytes": m.h2d_bytes} for m in bf_epochs],
        "step_host_ms": host_step_ms(bf_tr, bf_epochs),
        "launches": {k: v for k, v in bf_launches.items() if v},
        "launches_per_step": sum(bf_launches.values()) / sum(m.num_batches for m in bf_epochs),
        "gcn_epoch_f32_cache": {"time_s": bf_gcn_epoch.time_s,
                                "mean_loss": bf_gcn_epoch.mean_loss,
                                "miss_rate": bf_gcn_epoch.miss_rate,
                                "launches": {k: v for k, v in bf_gcn_launches.items() if v}},
        "nvidia_smi": smi}
    emit("bf16_train", bf_out)
    for label, counts, runs, want in (
            ("mean, bf16 cache", bf_launches, bf_epochs,
             {"assemble_bf16_to_bf16": 1, "block_gather_fwd_mean_bf16": 2,
              "block_gather_bwd_mean_bf16": 1, "grad_to_bf16": 1}),
            ("gcn, f32 cache", bf_gcn_launches, [bf_gcn_epoch],
             {"assemble_f32_to_bf16": 1, "block_gather_fwd_sum_bf16": 2,
              "block_gather_bwd_sum_bf16": 1, "grad_to_bf16": 1})):
        steps = sum(m.num_batches for m in runs)
        if {k: v for k, v in counts.items() if v} != {k: v * steps for k, v in want.items()}:
            fail(f"bf16 compute ({label}): launches {counts} over {steps} steps, expected "
                 f"{want} a step")
    bf_losses = [m.mean_loss for m in bf_epochs] + [bf_gcn_epoch.mean_loss]
    if not all(math.isfinite(v) for v in bf_losses):
        fail(f"bf16 compute: non-finite loss {bf_losses}")
    if not bf_epochs[1].mean_loss < bf_epochs[0].mean_loss:
        fail(f"bf16 compute: loss did not fall: {bf_epochs[0].mean_loss} -> "
             f"{bf_epochs[1].mean_loss}")
    if bf_epochs[0].miss_rate != epochs[0].miss_rate:
        fail(f"bf16 compute: miss rate {bf_epochs[0].miss_rate} != the f32 run's "
             f"{epochs[0].miss_rate} on the same batches")

    # -- store_int8: the pre-quantized store tier ----------------------------------
    # quantize_store(store) once (what a user's preprocessing does), then a
    # Trainer over it at the int8 cache tier: no scale pass at setup, miss
    # rows gathered as stored.  One epoch at bf16 compute (the assembly from
    # int8 rows to bf16); the loader alone, in turns with the f32 store's
    # int8 trainer from `tiers`
    t0 = time.perf_counter()
    qstore = quantize_store(FeatureStore.build(ds.graph, ds.features))
    quantize_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    q_tr = Trainer(config("mean", "int8", compute="bfloat16"), qstore, ds.graph,
                   ds.train_nids, ds.labels, seed=0)
    q_tr._maybe_fill_cache()
    torch.cuda.synchronize()
    q_setup = time.perf_counter() - t0
    gk.reset_launch_counts()
    q_epoch = q_tr.run_epoch(0)
    torch.cuda.synchronize()
    q_launches = gk.launch_counts()
    q_loader_s = {"f32_store": [], "int8_store": []}
    for label, t_ in (("f32_store", tier_tr["int8"]), ("int8_store", q_tr),
                      ("int8_store", q_tr), ("f32_store", tier_tr["int8"])):
        t0 = time.perf_counter()
        sum(1 for _ in t_.loader.epoch())
        torch.cuda.synchronize()
        q_loader_s[label].append(time.perf_counter() - t0)
    q_out = {
        "quantize_store_s": quantize_s, "setup_s": q_setup,
        "f32_store_int8_setup_s": tiers_out["int8"]["setup_s"],
        "epoch": {"compute": "bfloat16", "time_s": q_epoch.time_s, "edges": q_epoch.edges,
                  "edges_per_s": q_epoch.edges / q_epoch.time_s,
                  "miss_rate": q_epoch.miss_rate, "h2d_bytes": q_epoch.h2d_bytes,
                  "mean_loss": q_epoch.mean_loss, "batches": q_epoch.num_batches},
        "f32_store_int8_epoch": {k: tiers_out["int8"][k]
                                 for k in ("time_s", "miss_rate", "h2d_bytes", "mean_loss")},
        "loader_only_epoch_s": q_loader_s,
        "scale_equal": bool((q_tr.cache.dequant_scale
                             == tier_tr["int8"].cache.dequant_scale).all()),
        "cache_rows_equal": torch.equal(q_tr.cache.cache_values,
                                        tier_tr["int8"].cache.cache_values),
        "launches": {k: v for k, v in q_launches.items() if v},
        "nvidia_smi": smi}
    emit("store_int8", q_out)
    if (q_epoch.miss_rate, q_epoch.h2d_bytes) != (tiers_out["int8"]["miss_rate"],
                                                  tiers_out["int8"]["h2d_bytes"]):
        fail(f"int8 store: miss rate {q_epoch.miss_rate} and h2d bytes {q_epoch.h2d_bytes} "
             f"differ from the f32 store's int8 tier {tiers_out['int8']}")
    if not (q_out["scale_equal"] and q_out["cache_rows_equal"]):
        fail("int8 store: its scale or cache rows differ from the f32 store's int8 tier")
    if not math.isfinite(q_epoch.mean_loss):
        fail(f"int8 store: non-finite loss {q_epoch.mean_loss}")
    steps = q_epoch.num_batches
    if {k: v for k, v in q_launches.items() if v} != {
            "assemble_int8_to_bf16": steps, "block_gather_fwd_mean_bf16": 2 * steps,
            "block_gather_bwd_mean_bf16": steps, "grad_to_bf16": steps}:
        fail(f"int8 store: launches {q_out['launches']} over {steps} steps, expected one "
             "assemble_int8_to_bf16, two bf16 block forwards, one bf16 block backward "
             "and one grad_to_bf16")

    # -- host_dispatch: the host path at the JAX package's defaults -------------------
    # backend "auto" (the native sampler) and steps_per_dispatch: the loader
    # alone with each sampler; then fresh Trainers (seed 0) of the chip
    # configuration: K=8 replayed from CUDA graphs (epoch 0 eager), twice the
    # eager form of K=8 (the eager spread), the eager and the graph form of
    # K=1; bf16 compute over the bf16 tier, K=8 replayed and twice eager;
    # cache.rank_by="access_freq" (refilled after epoch 0), K=8 replayed
    # and eager
    omp = {"OMP_NUM_THREADS": os.environ.get("OMP_NUM_THREADS"), "cpu_count": os.cpu_count(),
           "torch_threads": torch.get_num_threads()}

    def host_cfg(k: int, compute: str = "float32", cache_dtype: str = "float32",
                 backend: str = "auto", rank_by: str = "out_degree"):
        c = config("mean", cache_dtype, compute=compute)
        c.train.steps_per_dispatch = k
        c.sampler.backend = backend
        c.cache.rank_by = rank_by
        return c

    def params_of(t_):
        return {n: p.detach().clone() for n, p in t_.state.model.named_parameters()}

    def loader_epoch(t_):
        """One epoch of the host pipeline alone, as the Trainer consumes it
        (sampling, plan, miss gather, pack, the groups stacked in pinned
        memory; nothing crosses to the card): seconds, batches, the bytes
        the groups would ship, the miss rate."""
        t_.cache.reset_stats()
        t0 = time.perf_counter()
        nb = h2d = 0
        for grp in t_.loader.groups(t_.steps_per_dispatch):
            nb, h2d = nb + grp.k, h2d + grp.nbytes
        return {"s": time.perf_counter() - t0, "batches": nb, "h2d_bytes": h2d,
                "miss_rate": t_.cache.miss_rate()}

    def group_device_ms(t_):
        """Device ms a step of one group's dispatch in the form the Trainer
        runs now (its H2D copy included), behind a device sleep that
        outlasts its enqueue: the first group of a further loader epoch,
        one replay; in the eager form its first two batches (eight eager
        steps, some 1,100 launches, would fill the launch queue and block
        the host)."""
        gen = t_.loader.groups(t_.steps_per_dispatch)
        grp = next(gen)
        gen.close()
        graphs = t_.group_graphs if t_.host_graphs else None
        if graphs is not None and graphs.needs_capture(grp):
            graphs.capture(grp, t_._acc)
        if graphs is None:
            grp = PackedGroup(grp.layout, grp.i32[:2], grp.u8[:2], grp.miss[:2])
        eager = make_multistep_train_step(t_.state, t_.cache.cache_values,
                                          t_.cache.dequant_scale_dev)

        def run():
            if graphs is not None:
                graphs(grp, t_._acc)
            else:
                eager(grp, t_._acc)
        run()
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(400_000_000)
        ev[1].record()
        t0 = time.perf_counter()
        run()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        torch.cuda.synchronize()
        return {"device_ms_per_step": ev[1].elapsed_time(ev[2]) / grp.k, "timed_group_k": grp.k,
                "device_time_is_pure": enqueue_ms < ev[0].elapsed_time(ev[1])}

    def group_parity(t_):
        """The first and the last (partial) group of a further loader epoch,
        each dispatched three times from the same state (parameters, Adam's
        state, the dropout generator, the step counts, the accumulator,
        restored in place between): replayed from the Trainer's graph of its
        key, then twice through the eager form.  For each, the relative
        difference of the group's loss sum and the largest
        ||p - p_eager|| / ||p_eager||, replay against eager and eager
        against eager."""
        gen = t_.loader.groups(t_.steps_per_dispatch)
        first = last = next(gen)
        for last in gen:
            pass
        grps = (first, last)
        st, acc = t_.state, t_._acc
        params = list(st.model.parameters())
        graphs = t_.group_graphs
        eager = make_multistep_train_step(st, t_.cache.cache_values,
                                          t_.cache.dequant_scale_dev)
        for grp in (grps[0], grps[-1]):
            if graphs.needs_capture(grp):
                graphs.capture(grp, acc)
        torch.cuda.synchronize()
        snap = ([p.detach().clone() for p in params],
                [{k: v.clone() for k, v in st.optimizer.state[p].items()} for p in params],
                st.generator.get_state(), st.step_t.clone(), st.step, acc.clone())

        def restore():
            with torch.no_grad():
                for p, v, o in zip(params, snap[0], snap[1]):
                    p.copy_(v)
                    for k, t in o.items():
                        st.optimizer.state[p][k].copy_(t)
                st.step_t.copy_(snap[3])
                acc.copy_(snap[5])
            st.generator.set_state(snap[2])
            st.step = snap[4]

        out = {}
        for which, grp in (("first", grps[0]), ("last", grps[-1])):
            results = []
            for form in ("replayed", "eager", "eager_again"):
                restore()
                if form == "replayed":
                    graphs(grp, acc)
                else:
                    eager(grp, acc)
                torch.cuda.synchronize()
                results.append(((acc[0] - snap[5][0]).item(),
                                {n: p.detach().clone()
                                 for n, p in st.model.named_parameters()}))
            (l_r, p_r), (l_e, p_e), (l_e2, p_e2) = results
            out[which] = {"group_key": [grp.k, grp.layout.bucket],
                          "group_loss_sum": [l_r, l_e, l_e2],
                          "loss_rel_diff": {"replay_vs_eager": rel(l_r, l_e),
                                            "eager_vs_eager": rel(l_e2, l_e)},
                          "param_rel_diff": {"replay_vs_eager": param_rel(p_r, p_e),
                                             "eager_vs_eager": param_rel(p_e2, p_e)}}
        restore()
        return out

    def host_run(cfg_h, n_epochs: int, graphs: bool):
        """A fresh Trainer's ``n_epochs`` (the first eager, then the form
        ``graphs`` picks): each epoch's metrics and host enqueue ms a step,
        setup, capture seconds, graphs, the launches run (counted from 0 just
        before), peak device bytes from the run's start, the parameters
        after epoch 1, and the device time a step of one more group; whether
        the cache was refilled (``access_freq``) and the graphs read the
        rows it holds now."""
        free_memory()
        start_bytes = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        t_ = Trainer.from_dataset(cfg_h, ds, seed=0)
        t_.host_graphs = graphs
        t_._maybe_fill_cache()
        first_fill = t_.cache.cache_values
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        gk.reset_launch_counts()
        ms, eps, params = [], [], None
        for e in range(n_epochs):
            step_s = t_.timers.total["step"]
            ms.append(t_.run_epoch(e))
            m = ms[-1]
            eps.append({"epoch": e, "form": "graphs" if graphs and e else "eager",
                        "time_s": m.time_s, "edges": m.edges,
                        "edges_per_s": m.edges / m.time_s, "batches": m.num_batches,
                        "miss_rate": m.miss_rate, "h2d_bytes": m.h2d_bytes,
                        "mean_loss": m.mean_loss, "mean_acc": m.mean_acc,
                        "enqueue_ms_per_step": (t_.timers.total["step"] - step_s) * 1e3
                        / m.num_batches})
            if e == 1:
                params = params_of(t_)
        torch.cuda.synchronize()
        counts = executed_launches(gk.launch_counts(), t_.group_graphs)
        peak = torch.cuda.max_memory_allocated() - start_bytes
        out = {"k": t_.steps_per_dispatch, "form": "graphs" if graphs else "eager",
               "sampler_backend": t_.sampler.backend_name, "caps": list(t_.sampler.caps),
               "setup_s": setup, "epochs": eps,
               "capture_s": t_.timers.total["capture"],
               "graphs": len(t_.group_graphs.graphs) if t_.group_graphs else 0,
               "graph_keys": ([[k, lay.bucket] for k, lay in t_.group_graphs.keys]
                              if t_.group_graphs else []),
               "launches": {k: v for k, v in counts.items() if v},
               "run_peak_device_bytes": peak,
               "cache_refilled": t_.cache.cache_values is not first_fill,
               "graphs_read_current_cache": (t_.group_graphs.cache_values
                                             is t_.cache.cache_values
                                             if t_.group_graphs else None),
               "replayed_launches_per_step": (
                   {k: v / sum(m.num_batches for m in ms[1:])
                    for k, v in t_.group_graphs.replayed_launches().items()}
                   if t_.group_graphs else {})}
        out.update(group_device_ms(t_))
        out["device_busy_share"] = (out["device_ms_per_step"] * ms[-1].num_batches / 1e3
                                    / ms[-1].time_s)
        return t_, ms, params, out

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-30)

    def param_rel(pa, pb):
        """The largest ||pa - pb|| / ||pb|| over the parameters."""
        return max(((pa[n] - pb[n]).norm() / pb[n].norm().clamp(min=1e-30)).item() for n in pb)

    hd_out, hd_bad = {"omp": omp, "nvidia_smi": smi}, []
    # the loader alone, numpy and native sampler, in turns
    loader_tr = {b: Trainer.from_dataset(host_cfg(8, backend=b), ds, seed=0)
                 for b in ("numpy", "auto")}
    for t_ in loader_tr.values():
        t_._maybe_fill_cache()
    lo = {"numpy": [], "native": []}
    for b in ("numpy", "auto", "auto", "numpy"):
        lo["numpy" if b == "numpy" else "native"].append(loader_epoch(loader_tr[b]))
    hd_out["loader_only"] = {
        "epoch_s": {k: [r["s"] for r in v] for k, v in lo.items()},
        "first_epoch": {k: {f: v[0][f] for f in ("batches", "miss_rate", "h2d_bytes")}
                        for k, v in lo.items()},
        "caps": {k: list(loader_tr[b].sampler.caps) for k, b in (("numpy", "numpy"),
                                                                 ("native", "auto"))},
        "backend": {k: loader_tr[b].sampler.backend_name for k, b in (("numpy", "numpy"),
                                                                      ("native", "auto"))}}
    del loader_tr, t_
    if hd_out["loader_only"]["backend"] != {"numpy": "numpy", "native": "native"}:
        hd_bad.append(f"sampler backends {hd_out['loader_only']['backend']}")

    runs = {}
    for label, cfg_h, n_epochs, graphs in (
            ("f32_k8_graphs", host_cfg(8), 3, True),
            ("f32_k8_eager", host_cfg(8), 2, False),
            ("f32_k8_eager_again", host_cfg(8), 2, False),
            ("f32_k1_eager", host_cfg(1), 2, False),
            ("f32_k1_graphs", host_cfg(1), 2, True),
            ("bf16_k8_graphs", host_cfg(8, "bfloat16", "bfloat16"), 3, True),
            ("bf16_k8_eager", host_cfg(8, "bfloat16", "bfloat16"), 2, False),
            ("bf16_k8_eager_again", host_cfg(8, "bfloat16", "bfloat16"), 2, False),
            ("access_freq_k8_graphs", host_cfg(8, rank_by="access_freq"), 2, True),
            ("access_freq_k8_eager", host_cfg(8, rank_by="access_freq"), 2, False)):
        t_, ms, params, out = host_run(cfg_h, n_epochs, graphs)
        runs[label] = (ms, params)
        hd_out[label] = out
        if graphs and t_.steps_per_dispatch == 8:
            hd_out[label.replace("_graphs", "_group_parity")] = group_parity(t_)
        del t_
    f32_step = {"assemble_f32": 1, "block_gather_fwd_mean": 2, "block_gather_bwd_mean": 1}
    for pre, per_step in (("f32", f32_step),
                          ("bf16", {"assemble_bf16_to_bf16": 1,
                                    "block_gather_fwd_mean_bf16": 2,
                                    "block_gather_bwd_mean_bf16": 1, "grad_to_bf16": 1}),
                          ("access_freq", f32_step)):
        graph_k8, eager_k8 = f"{pre}_k8_graphs", f"{pre}_k8_eager"
        ms_g, p_g = runs[graph_k8]
        ms_e, p_e = runs[eager_k8]
        # the whole runs: their epoch 0 is eager in both.  At f32 the
        # atomics' order in the block backward parts them (reported); at
        # bf16 compute the backward's f32 table is rounded once to bf16,
        # and the replayed run must equal the eager one to the bit
        whole = {"loss_rel_diff": {"replay_vs_eager": [rel(a.mean_loss, b.mean_loss)
                                                       for a, b in zip(ms_g, ms_e)]},
                 "param_rel_diff_after_epoch_1": {"replay_vs_eager": param_rel(p_g, p_e)},
                 "bit_equal": {"losses": [a.mean_loss for a in ms_g[:len(ms_e)]]
                               == [b.mean_loss for b in ms_e],
                               "params": all(torch.equal(p_g[n], p_e[n]) for n in p_e)}}
        if f"{pre}_k8_eager_again" in runs:
            ms_e2, p_e2 = runs[f"{pre}_k8_eager_again"]
            whole["loss_rel_diff"]["eager_vs_eager"] = [rel(a.mean_loss, b.mean_loss)
                                                        for a, b in zip(ms_e2, ms_e)]
            whole["param_rel_diff_after_epoch_1"]["eager_vs_eager"] = param_rel(p_e2, p_e)
        hd_out[f"{pre}_epochs_replay_vs_eager"] = whole
        if pre == "bf16" and whole["bit_equal"] != {"losses": True, "params": True}:
            hd_bad.append(f"bf16: the replayed run is not bit-equal to the eager run: {whole}")
        # one group from the same state: the first (8, bucket) and the
        # last, partial (2, bucket) group of an epoch, each against its graph
        for which, par in hd_out[f"{pre}_k8_group_parity"].items():
            par["bound"] = ("the group's loss within max(1e-6, eager spread) relative, "
                            "every parameter within max(1e-5, eager spread) of its norm")
            for what, tol in (("loss_rel_diff", 1e-6), ("param_rel_diff", 1e-5)):
                got, spread = par[what]["replay_vs_eager"], par[what]["eager_vs_eager"]
                if not got <= max(tol, spread):
                    hd_bad.append(f"{pre}: the {which} group {par['group_key']} replayed "
                                  f"against the eager form from the same state: {what} "
                                  f"{got}, over {tol} and the eager spread {spread}")
        if not ms_g[1].mean_loss < ms_g[0].mean_loss:
            hd_bad.append(f"{pre}: loss did not fall: {ms_g[0].mean_loss} -> "
                          f"{ms_g[1].mean_loss}")
        labels_pre = [k for k in runs if k.startswith(pre + "_")]
        for label in labels_pre:
            out, (ms, _) = hd_out[label], runs[label]
            steps = sum(m.num_batches for m in ms)
            if out["sampler_backend"] != "native":
                hd_bad.append(f"{label}: sampler backend {out['sampler_backend']}")
            if out["launches"] != {k: v * steps for k, v in per_step.items()}:
                hd_bad.append(f"{label}: launches {out['launches']} over {steps} steps, "
                              f"expected {per_step} a step")
            if out["form"] == "graphs" and (out["replayed_launches_per_step"]
                                            != {k: float(v) for k, v in per_step.items()}
                                            or not out["graphs"]):
                hd_bad.append(f"{label}: replayed launches a step "
                              f"{out['replayed_launches_per_step']}, expected {per_step}")
            if out["form"] == "graphs" and not out["graphs_read_current_cache"]:
                hd_bad.append(f"{label}: the graphs do not read the cache's current rows")
            if out["cache_refilled"] != (pre == "access_freq"):
                hd_bad.append(f"{label}: cache refilled: {out['cache_refilled']}")
            if not all(math.isfinite(m.mean_loss) for m in ms):
                hd_bad.append(f"{label}: non-finite loss")
            for m, r in zip(ms, runs[graph_k8][0]):
                if (m.num_batches, m.edges, m.miss_rate) != (r.num_batches, r.edges,
                                                             r.miss_rate):
                    hd_bad.append(f"{label}: epoch {m.epoch} batches/edges/miss rate "
                                  f"{(m.num_batches, m.edges, m.miss_rate)} != the graph "
                                  f"run's {(r.num_batches, r.edges, r.miss_rate)}")
                if "_k8" in label and m.h2d_bytes != r.h2d_bytes:
                    hd_bad.append(f"{label}: epoch {m.epoch} h2d bytes {m.h2d_bytes} != the "
                                  f"graph run's {r.h2d_bytes}")
    # the refill by access frequency moved the miss rate of epoch 1
    af, od = runs["access_freq_k8_graphs"][0], runs["f32_k8_graphs"][0]
    hd_out["access_freq_miss_rate"] = {"access_freq": [m.miss_rate for m in af],
                                       "out_degree": [m.miss_rate for m in od[:2]]}
    if af[0].miss_rate != od[0].miss_rate:
        hd_bad.append("access_freq: epoch 0 (the out-degree fill) missed "
                      f"{af[0].miss_rate}, the out-degree run {od[0].miss_rate}")
    k1 = [runs["f32_k1_eager"][0], runs["f32_k1_graphs"][0]]
    if [m.h2d_bytes for m in k1[0]] != [m.h2d_bytes for m in k1[1]]:
        hd_bad.append("K=1: the eager and the graph run shipped different bytes")
    emit("host_dispatch", hd_out)
    if hd_bad:
        fail("host_dispatch: " + "; ".join(hd_bad))
    del runs

    def host_and_device(fn, reps: int = 20, dev_reps: int = 2):
        """Host enqueue and wall time a call (``reps`` back to back), and
        device time a call behind a ~0.1 s device sleep that outlasts the
        enqueue of ``dev_reps`` calls (few, to stay under the launch queue)."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        enqueue = (time.perf_counter() - t0) * 1e3 / reps
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(200_000_000)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(dev_reps):
            fn()
        ev[2].record()
        dev_enqueue = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        return {"host_enqueue_ms": enqueue, "wall_ms": wall,
                "device_ms": ev[1].elapsed_time(ev[2]) / dev_reps,
                "device_time_is_pure": dev_enqueue < ev[0].elapsed_time(ev[1]),
                "sleep_ms": ev[0].elapsed_time(ev[1])}

    # -- device_epoch: the whole-epoch on-device path ------------------------
    # each run a fresh Trainer (seed 0) with the full cache and the CSR on the
    # card, 2 epochs: epoch 0 eager, epoch 1 replayed from the CUDA graphs of
    # its epoch_dispatch (every mode driven); launches counted from 0 over its
    # epochs: those counted eagerly plus each graph's captured launches times
    # its replays (the counter counts a captured launch once, at capture)
    def device_run(dispatch: str, dtype: str = "float32", paired: bool = False,
                   compute: str = "float32"):
        key = f"assemble_{TIERS[dtype]}" + ("_to_bf16" if compute == "bfloat16" else "")
        t0 = time.perf_counter()
        d_tr = Trainer.from_dataset(config("mean", dtype, on_device=True, paired=paired,
                                           compute=compute, dispatch=dispatch), ds, seed=0)
        d_tr._maybe_fill_cache()
        torch.cuda.synchronize()
        d_setup = time.perf_counter() - t0
        start_bytes = torch.cuda.memory_allocated()   # earlier phases' tensors included
        torch.cuda.reset_peak_memory_stats()
        gk.reset_launch_counts()
        ms = [d_tr.run_epoch(e) for e in range(2)]
        torch.cuda.synchronize()
        counted = gk.launch_counts()
        counts = executed_launches(counted, d_tr.epoch_runner)
        cv_d = d_tr.cache.cache_values
        timers = d_tr.timers.summary()
        out = {"cache_dtype": dtype, "compute": compute, "paired_draws": paired,
               "epoch_dispatch": dispatch, "setup_s": d_setup,
               "capture_s": timers["capture"]["total_s"],
               "epochs": [{"epoch": m.epoch, "form": "eager" if m.epoch == 0 else "replayed",
                           "time_s": m.time_s, "batches": m.num_batches,
                           "edges": m.edges, "edges_per_s": m.edges / m.time_s,
                           "vertices": m.vertices, "mean_loss": m.mean_loss,
                           "mean_acc": m.mean_acc, "miss_rate": m.miss_rate,
                           "h2d_bytes": m.h2d_bytes} for m in ms],
               "cache_bytes": cv_d.numel() * cv_d.element_size(),
               "csr_bytes": d_tr._dev_csr.nbytes(),
               "peak_device_bytes": torch.cuda.max_memory_allocated(),
               "run_peak_device_bytes": torch.cuda.max_memory_allocated() - start_bytes
               + cv_d.numel() * cv_d.element_size() + d_tr._dev_csr.nbytes(),
               "launches": {k: v for k, v in counts.items() if v},
               "launches_counted": {k: v for k, v in counted.items() if v},
               "graphs": len(d_tr.epoch_runner.graphs)}
        steps = sum(m.num_batches for m in ms)
        losses = [m.mean_loss for m in ms]
        what = f"device epoch ({dtype}, paired={paired}, {compute}, {dispatch})"
        if not all(math.isfinite(v) for v in losses):
            fail(f"{what}: non-finite loss {losses}")
        if counts[key] != steps or sum(counts.values()) != steps:
            fail(f"{what}: launches {out['launches']} over {steps} steps, expected one "
                 f"{key} a step and no other gather kernel")
        if not (d_tr.epoch_runner.graph and d_tr.epoch_runner.graphs):
            fail(f"{what}: epoch 1 did not replay CUDA graphs")
        return d_tr, out

    dev_tr, dev_out = {}, {}
    for label, dispatch, kw in (
            ("f32", "scan", {}), ("f32_paired", "steps", {"paired": True}),
            ("bf16_paired", "pipelined", {"dtype": "bfloat16", "paired": True}),
            ("int8_paired", "steps", {"dtype": "int8", "paired": True}),
            ("bf16_compute", "pipelined", {"dtype": "bfloat16", "paired": True,
                                           "compute": "bfloat16"})):
        dev_tr[label], dev_out[label] = device_run(dispatch, **kw)
        if label in ("f32_paired", "bf16_compute"):
            del dev_tr[label]                # keep the card's memory for what follows
        free_memory()
    emit("device_epoch", dev_out)
    for label in dev_out:
        e0, e1 = (m["mean_loss"] for m in dev_out[label]["epochs"])
        if not e1 < e0:
            fail(f"device epoch ({label}): loss did not fall: {e0} -> {e1}")
    dev_launches = {TIERS[dev_tr[k].cfg.cache.dtype]: dev_out[k]["launches"]
                    for k in ("f32", "bf16_paired", "int8_paired")}

    # -- dispatch: each epoch_dispatch mode replayed against its eager form ---
    # for each run and mode: a Trainer (epoch 0 eager, the capture, epoch 1
    # replayed) against a fresh Trainer's epochs through the eager form of the
    # same function (DeviceEpochRunner(graph=False), main stream) from the same
    # seed; the eager spread from a second eager run of the scan form
    MODES = ("scan", "steps", "pipelined")

    def eager_form(cfg_d, n_epochs: int):
        """A fresh Trainer's ``n_epochs`` through the eager form: each
        epoch's wall time, host enqueue and metrics; the Trainer."""
        t_ = Trainer.from_dataset(cfg_d, ds, seed=0)
        runner = DeviceEpochRunner(cfg_d, t_.state, t_.epoch_inputs, t_.device_data())
        out = []
        for e in range(n_epochs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t_.epoch_inputs.load(*t_.epoch_randomness(e, out=t_.epoch_inputs))
            acc = runner()
            enqueue = time.perf_counter() - t0
            v = acc.values()
            out.append({"time_s": time.perf_counter() - t0, "enqueue_ms": enqueue * 1e3,
                        "steps": int(v["steps"]), "edges": int(v["edges"]),
                        "vertices": int(v["vertices"]),
                        "mean_loss": v["loss_sum"] / max(v["steps"], 1)})
        return t_, out

    def replay_run(cfg_d, n_epochs: int):
        """A Trainer's ``n_epochs`` (the first eager, then replays), its
        peak bytes and launches run and its parameters after them; then one
        more replayed epoch (a graph's first replay also uploads it) and
        one behind a device sleep that outlasts its enqueue: the replay's
        device time."""
        free_memory()
        start_bytes = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        gk.reset_launch_counts()
        t_ = Trainer.from_dataset(cfg_d, ds, seed=0)
        ms, enqueue_ms = [], []
        for e in range(n_epochs):
            before = t_.timers.total["enqueue"]
            ms.append(t_.run_epoch(e))
            enqueue_ms.append((t_.timers.total["enqueue"] - before) * 1e3)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - start_bytes
        counts = executed_launches(gk.launch_counts(), t_.epoch_runner)
        params = {n: p.detach().clone() for n, p in t_.state.model.named_parameters()}
        before = t_.timers.total["enqueue"]
        again = t_.run_epoch(n_epochs)
        enqueue_ms.append((t_.timers.total["enqueue"] - before) * 1e3)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(200_000_000)
        ev[1].record()
        t0 = time.perf_counter()
        t_.enqueue_device_epoch(n_epochs + 1)
        dev_enqueue_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        torch.cuda.synchronize()
        return t_, ms, params, {"run_peak_device_bytes": peak, "launches": counts,
                                "enqueue_ms": enqueue_ms, "again_s": again.time_s,
                                "device_epoch_ms": ev[1].elapsed_time(ev[2]),
                                "device_time_is_pure": dev_enqueue_ms
                                < ev[0].elapsed_time(ev[1])}

    def dispatch_config(kw, mode: str):
        return config("mean", kw.get("dtype", "float32"), on_device=True,
                      paired=kw.get("paired", False), compute=kw.get("compute", "float32"),
                      dispatch=mode, cosine_steps=kw.get("cosine_steps", 0))

    dispatch_out, bad = {}, []
    for label, kw in (("f32", {}), ("f32_paired", {"paired": True}),
                      ("bf16_tier", {"dtype": "bfloat16", "paired": True}),
                      ("int8_tier", {"dtype": "int8", "paired": True}),
                      ("bf16_compute", {"dtype": "bfloat16", "paired": True,
                                        "compute": "bfloat16"}),
                      ("f32_cosine", {"cosine_steps": 150})):
        dtype, compute = kw.get("dtype", "float32"), kw.get("compute", "float32")
        key = f"assemble_{TIERS[dtype]}" + ("_to_bf16" if compute == "bfloat16" else "")
        free_memory()
        t_e2, eager2 = eager_form(dispatch_config(kw, "scan"), 2)
        p_e2 = {n: p.detach().clone() for n, p in t_e2.state.model.named_parameters()}
        # the eager step's device time (the steps mode's eager step_fn)
        _, step_fn = make_device_step_fns(t_e2.cfg, t_e2.state, t_e2.epoch_inputs,
                                          t_e2.device_data())
        eager_step = host_and_device(step_fn, reps=2, dev_reps=2)
        nb = t_e2.epoch_inputs.num_batches
        del t_e2, step_fn
        run_out = {"cache_dtype": dtype, "compute": compute,
                   "paired_draws": kw.get("paired", False),
                   "lr_schedule": (f"cosine, lr_decay_steps {kw['cosine_steps']} of "
                                   f"{2 * nb} updates") if "cosine_steps" in kw else "none",
                   "eager_step_device_ms": eager_step["device_ms"],
                   "eager_step_device_time_is_pure": eager_step["device_time_is_pure"]}
        for mode in MODES:
            cfg_m = dispatch_config(kw, mode)
            t_r, ms, p_r, meas = replay_run(cfg_m, 2)
            timers = t_r.timers.summary()
            runner = t_r.epoch_runner
            replayed = runner.replayed_launches()
            replayed_steps = nb * (len(ms) + 1)     # epochs 1.., again, the timing epoch
            del t_r, runner
            free_memory()
            start_bytes = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t_e, eager = eager_form(cfg_m, 2)
            eager_peak = torch.cuda.max_memory_allocated() - start_bytes
            p_e = {n: p.detach().clone() for n, p in t_e.state.model.named_parameters()}
            del t_e
            m1, e1 = ms[1], eager[1]
            dev_step_ms = meas["device_epoch_ms"] / nb
            entry = {
                "capture_s": timers["capture"]["total_s"],
                "epoch_s": {"replayed": m1.time_s, "replayed_again": meas["again_s"],
                            "eager": e1["time_s"]},
                "enqueue_ms": {"replayed": meas["enqueue_ms"][1],
                               "replayed_again": meas["enqueue_ms"][2],
                               "eager": e1["enqueue_ms"],
                               "eager_first_epoch_of_the_trainer": meas["enqueue_ms"][0]},
                "device_ms_per_step": {"replayed": dev_step_ms,
                                       "eager": eager_step["device_ms"]},
                "device_time_is_pure": meas["device_time_is_pure"],
                "device_busy_share": {"replayed_again": meas["device_epoch_ms"] / 1e3
                                      / meas["again_s"],
                                      "eager": nb * eager_step["device_ms"] / 1e3
                                      / e1["time_s"]},
                "replayed_gather_launches_per_step": {k: v / replayed_steps
                                                      for k, v in replayed.items()},
                "launches": {k: v for k, v in meas["launches"].items() if v},
                "run_peak_device_bytes": {"replayed": meas["run_peak_device_bytes"],
                                          "eager": eager_peak},
                "epochs": [{"replayed": [m.num_batches, m.edges, m.vertices, m.mean_loss],
                            "eager": [e["steps"], e["edges"], e["vertices"], e["mean_loss"]],
                            "eager2": [e2["steps"], e2["edges"], e2["vertices"],
                                       e2["mean_loss"]]}
                           for m, e, e2 in zip(ms, eager, eager2)],
                "loss_rel_diff": {"replay_vs_eager": [rel(m.mean_loss, e["mean_loss"])
                                                      for m, e in zip(ms, eager)],
                                  "eager_vs_eager": [rel(e2["mean_loss"], e["mean_loss"])
                                                     for e, e2 in zip(eager, eager2)]},
                "param_rel_diff": {"replay_vs_eager": param_rel(p_r, p_e),
                                   "eager_vs_eager": param_rel(p_e2, p_e)},
            }
            run_out[mode] = entry
            what = f"dispatch ({label}, {mode})"
            for m, e in zip(ms, eager):
                if (m.num_batches, m.edges, m.vertices) != (e["steps"], e["edges"],
                                                            e["vertices"]):
                    bad.append(f"{what}: epoch {m.epoch} steps/edges/vertices "
                               f"{(m.num_batches, m.edges, m.vertices)} != eager "
                               f"{(e['steps'], e['edges'], e['vertices'])}")
            for r_, s_ in zip(*entry["loss_rel_diff"].values()):
                if not r_ <= max(1e-4, s_):
                    bad.append(f"{what}: loss {r_} from the eager form's, over 1e-4 and "
                               f"the eager spread {s_}")
            worst = entry["param_rel_diff"]["replay_vs_eager"]
            if not worst <= 1e-3:
                bad.append(f"{what}: parameters {worst} of their norm from the eager form's")
            if entry["replayed_gather_launches_per_step"] != {key: 1.0}:
                bad.append(f"{what}: replayed gather launches a step "
                           f"{entry['replayed_gather_launches_per_step']}, expected one {key}")
            if not ms[1].mean_loss < ms[0].mean_loss:
                bad.append(f"{what}: loss did not fall: {ms[0].mean_loss} -> {ms[1].mean_loss}")
            if not all(math.isfinite(m.mean_loss) for m in ms):
                bad.append(f"{what}: non-finite loss")
        dispatch_out[label] = run_out
    dispatch_out["nvidia_smi"] = smi
    emit("dispatch", dispatch_out)
    if bad:
        fail("graph replays disagree with the eager form: " + "; ".join(bad))

    # one device-sampled batch of the f32 run's epoch 0: the on-device path's shapes
    dtr = dev_tr["f32"]
    dcfg = dtr.cfg
    d_perm, d_draws = dtr.epoch_randomness(0)
    d_seeds, d_masks = epoch_schedule(d_perm, dtr._dev_train_nids, dcfg.sampler.batch_size)
    d_step = (d_seeds[0], d_masks[0], [d[0] for d in d_draws])
    d_mb = sample_minibatch_device(dtr._dev_csr, d_step[0], d_step[1], dcfg.sampler.num_hops,
                                   dcfg.sampler.hop_fanouts(), d_step[2],
                                   labels=dtr._dev_labels)
    d_ids = d_mb.input_nids
    d_full = {TIERS[t.cfg.cache.dtype]: (t.cache.cache_values, t.cache.dequant_scale_dev)
              for t in (dev_tr["f32"], dev_tr["bf16_paired"], dev_tr["int8_paired"])}

    # -- kernels: one batch of the run, at its shapes ------------------------
    seeds = tr.sampler.train_nids[:cfg.sampler.batch_size]
    mb_h = tr.sampler.sample(seeds)
    mb = mb_h.to(dev)

    def tier_inputs(cache):
        """The assembly's inputs for this batch at a cache's tier: cache
        rows, the plan's index a row and miss rows, the int8 scale."""
        plan = cache.fetch_plan(mb_h.input_nids, mb_h.input_mask, track=False)
        return (cache.cache_values, torch.from_numpy(plan.src_row).to(dev),
                plan.miss_feats.to(dev), cache.dequant_scale_dev)

    # f32: the main path's own cache; the others from the tiers phase
    tier_in = {dtype: tier_inputs(tr.cache if dtype == "float32" else tier_tr[dtype].cache)
               for dtype in TIERS}
    cv, src_row, miss_feats, _ = tier_in["float32"]
    b0, b1 = mb.blocks
    gen = torch.Generator(device=dev).manual_seed(1)
    feats = gk.assemble(cv, src_row, miss_feats)
    h1 = torch.randn(b0.cap_dst, 2 * cfg.model.hidden, generator=gen, device=dev)
    g1 = torch.randn(b1.cap_dst, 2 * cfg.model.hidden, generator=gen, device=dev)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def rows_bytes(n, d, size=4):
        return size * n * d

    def distinct(*idx):
        """Distinct source rows that one launch reads through these
        indices: each is read from memory once."""
        return int(torch.unique(torch.cat([i.reshape(-1) for i in idx])).numel())

    def reduce_inputs(pos, mask):
        """embedding_bag's flat valid positions and bag offsets."""
        counts = mask.sum(1)
        offsets = torch.zeros_like(counts)
        offsets[1:] = torch.cumsum(counts, 0)[:-1]
        return pos[mask].long(), offsets.long(), int(counts.sum())

    cases = []

    def gather_case(label, src, ids):
        n, d = ids.shape[0], src.shape[1]
        ids_l = ids.long()
        cases.append(dict(
            name=f"gather_rows[{label}]", key="gather_rows",
            replaces=f"{PALLAS}:58 gather_rows_pallas",
            shape=f"src {list(src.shape)} ids [{n}]", tol="exact",
            kernel=lambda: gk.gather_rows(src, ids),
            plain=lambda: gk.gather_rows_plain(src, ids),
            library=lambda: torch.index_select(src, 0, ids_l),
            nbytes=4 * n + rows_bytes(distinct(ids), d) + rows_bytes(n, d)))

    def assemble_same_fn(cv_t, sr_t, mf_t, sc_t):
        """The assembly in PyTorch calls from the kernel's own inputs: a row
        gather from each table, the selection, the cast (and the scale)."""
        rows = torch.where((sr_t >= 0)[:, None],
                           torch.index_select(cv_t, 0, sr_t.clamp(min=0)),
                           torch.index_select(mf_t, 0, (-1 - sr_t).clamp(min=0))).float()
        return rows if sc_t is None else rows * sc_t

    gather_case("block0 self", feats, b0.self_pos)
    gather_case("block1 self", h1, b1.self_pos)
    n0, d0 = src_row.shape[0], cv.shape[1]
    for dtype, tag in TIERS.items():
        # the bound: 4 index bytes a row, each distinct source row read once
        # at the tier's width, the f32 rows written, the int8 scale read
        cv_t, sr_t, mf_t, sc_t = tier_in[dtype]
        cases.append(dict(
            name=f"assemble[{tag}]", key=f"assemble_{tag}",
            launches=(launches if dtype == "float32" else tier_launches[dtype])[f"assemble_{tag}"],
            replaces=f"{PALLAS}:58 gather_rows_pallas (+ storage/cache.py:103 "
                     "assemble_features, :69 dequantize_fused)",
            shape=f"cache {list(cv_t.shape)} {cv_t.dtype} miss {list(mf_t.shape)} "
                  f"src_row [{n0}]",
            tol="exact",
            kernel=lambda a=tier_in[dtype]: gk.assemble(*a),
            plain=lambda a=tier_in[dtype]: gk.assemble_plain(*a),
            library=None, same_fn=lambda a=tier_in[dtype]: assemble_same_fn(*a),
            nbytes=4 * n0 + distinct(sr_t) * d0 * cv_t.element_size() + rows_bytes(n0, d0)
            + (0 if sc_t is None else 4 * d0)))
    # the on-device path's layer-0 fetch (take_rows): the assembly with no
    # miss rows, from the full cache, at a device-sampled batch's layer 0;
    # the bound as above, with no miss rows
    nd, dd = d_ids.shape[0], d_full["f32"][0].shape[1]
    nd_distinct = distinct(d_ids)

    def full_same_fn(cv_t, sc_t):
        """take_rows in PyTorch calls: index_select, .float(), the scale."""
        rows = torch.index_select(cv_t, 0, d_ids).float()
        return rows if sc_t is None else rows * sc_t

    for dtype, tag in TIERS.items():
        cv_f, sc_f = d_full[tag]
        cases.append(dict(
            name=f"assemble_full[{tag}]", key=f"assemble_{tag}",
            launches=dev_launches[tag][f"assemble_{tag}"],
            replaces=f"{PALLAS}:58 gather_rows_pallas (on-device layer-0 fetch: "
                     "ops/gather.py:21 chunked_take + storage/cache.py:69 dequantize_fused)",
            shape=f"cache {list(cv_f.shape)} {cv_f.dtype} ids [{nd}], no miss rows",
            tol="exact",
            kernel=lambda c=cv_f, s=sc_f: take_rows(c, d_ids, s),
            plain=lambda c=cv_f, s=sc_f: gk.assemble_plain(c, d_ids, c[:0], s),
            library=(lambda c=cv_f: torch.index_select(c, 0, d_ids)) if sc_f is None
            and cv_f.dtype == torch.float32 else None,
            same_fn=lambda c=cv_f, s=sc_f: full_same_fn(c, s),
            nbytes=4 * nd + nd_distinct * dd * cv_f.element_size() + rows_bytes(nd, dd)
            + (0 if sc_f is None else 4 * dd)))
    # -- the backwards: the fused block backward and its single-half uses ----
    s1, d1 = h1.shape
    n1, f1 = b1.neigh_pos.shape
    g1n = torch.randn(n1, d1, generator=gen, device=dev)
    ids1_l = b1.self_pos.long()
    flat1, _, _ = reduce_inputs(b1.neigh_pos, b1.neigh_mask)
    rows1 = b1.neigh_mask.nonzero(as_tuple=True)[0]
    cnt1 = b1.neigh_mask.sum(1, keepdim=True).clamp(min=1).float()

    def expanded(g, kind):
        """The index_add_ yardstick's input: the per-row division and the
        expansion over valid slots, done outside the timed call."""
        return (g / cnt1.to(g.dtype) if kind == "mean" else g)[rows1].contiguous()

    def same_fn(g_self, g_neigh, kind):
        """The backward from the kernel's own inputs in PyTorch calls: a
        zeroed table, the division and expansion, the index_add_ calls."""
        out = torch.zeros(s1, d1, device=dev,
                          dtype=(g_self if g_self is not None else g_neigh).dtype)
        if g_self is not None:
            out.index_add_(0, b1.self_pos, g_self)
        if g_neigh is not None:
            m = b1.neigh_mask
            g = g_neigh / m.sum(1, keepdim=True).clamp(min=1) if kind == "mean" else g_neigh
            out.index_add_(0, b1.neigh_pos.view(-1),
                           (g[:, None, :] * m[..., None]).view(-1, d1))
        return out

    def fwd_same_fn(src, blk, kind):
        """The block forward from the kernel's own inputs in PyTorch calls:
        a row gather, and a mask-weighted embedding_bag sum (divided by
        the count for mean)."""
        w = blk.neigh_mask.to(src.dtype)
        agg = torch.nn.functional.embedding_bag(blk.neigh_pos, src,
                                                per_sample_weights=w, mode="sum")
        if kind == "mean":
            agg = agg / w.sum(1, keepdim=True).clamp(min=1)
        return torch.index_select(src, 0, blk.self_pos), agg

    sbuf = torch.zeros_like(h1)
    cases.append(dict(
        name="scatter_add_rows[block1 self bwd]", key="scatter_add_rows",
        replaces=f"{PALLAS}:58 gather_rows_pallas (backward; JAX: autodiff of jnp.take)",
        shape=f"grad_out {list(g1.shape)} -> [{s1}, {d1}]", tol="atomic",
        kernel=lambda: gk.scatter_add_rows(g1, b1.self_pos, s1),
        plain=lambda: gk.scatter_add_rows_plain(g1, b1.self_pos, s1),
        library=lambda: sbuf.index_add_(0, ids1_l, g1),
        same_fn=lambda: same_fn(g1, None, "sum"),
        nbytes=4 * n1 + rows_bytes(n1, d1) + rows_bytes(s1, d1)))
    for rk in ("mean", "sum"):
        for label, src, blk in (("block0", feats, b0), ("block1", h1, b1)):
            flat, offs, _ = reduce_inputs(blk.neigh_pos, blk.neigh_mask)
            n, f = blk.neigh_pos.shape
            d = src.shape[1]
            neigh_rows = blk.neigh_pos[blk.neigh_mask]
            cases.append(dict(
                name=f"gather_reduce_{rk}[{label}]", key=f"gather_reduce_{rk}",
                replaces=f"{PALLAS}:132 gather_mean_pallas",
                shape=f"src {list(src.shape)} pos/mask [{n}, {f}]", tol="reduce",
                kernel=lambda s=src, b=blk, k=rk: gk.gather_reduce(s, b.neigh_pos, b.neigh_mask, k),
                plain=lambda s=src, b=blk, k=rk: gk.gather_reduce_plain(s, b.neigh_pos, b.neigh_mask, k),
                library=lambda s=src, fl=flat, of=offs, k=rk: torch.nn.functional.embedding_bag(
                    fl, s, of, mode=k),
                nbytes=5 * n * f + rows_bytes(distinct(neigh_rows), d) + rows_bytes(n, d)))
            n_s = blk.self_pos.shape[0]
            cases.append(dict(
                name=f"block_gather_fwd_{rk}[{label}]", key=f"block_gather_fwd_{rk}",
                replaces=f"{PALLAS}:58 gather_rows_pallas + {PALLAS}:132 gather_mean_pallas",
                shape=f"src {list(src.shape)} self_pos [{n_s}] pos/mask [{n}, {f}]",
                tol=("exact", "reduce"),
                kernel=lambda s=src, b=blk, k=rk: gk.block_gather_fwd(
                    s, b.self_pos, b.neigh_pos, b.neigh_mask, k),
                plain=lambda s=src, b=blk, k=rk: gk.block_gather_fwd_plain(
                    s, b.self_pos, b.neigh_pos, b.neigh_mask, k),
                library=lambda s=src, ids=blk.self_pos.long(), fl=flat, of=offs, k=rk: (
                    torch.index_select(s, 0, ids),
                    torch.nn.functional.embedding_bag(fl, s, of, mode=k)),
                same_fn=lambda s=src, b=blk, k=rk: fwd_same_fn(s, b, k),
                nbytes=4 * n_s + 5 * n * f + rows_bytes(distinct(blk.self_pos, neigh_rows), d)
                + rows_bytes(n_s, d) + rows_bytes(n, d)))
        bbuf = torch.zeros_like(h1)
        cases.append(dict(
            name=f"gather_reduce_bwd_{rk}[block1]", key=f"gather_reduce_bwd_{rk}",
            replaces=f"{PALLAS}:132 gather_mean_pallas (backward; JAX: autodiff of jnp.take)",
            shape=f"grad_out {list(g1.shape)} pos/mask [{n1}, {f1}] -> {list(h1.shape)}",
            tol="atomic",
            kernel=lambda k=rk: gk.gather_reduce_bwd(g1, b1.neigh_pos, b1.neigh_mask, s1, k),
            plain=lambda k=rk: gk.gather_reduce_bwd_plain(g1, b1.neigh_pos, b1.neigh_mask, s1, k),
            library=lambda ex=expanded(g1, rk), bb=bbuf: bb.index_add_(0, flat1, ex),
            same_fn=lambda k=rk: same_fn(None, g1, k),
            nbytes=5 * n1 * f1 + rows_bytes(n1, d1) + rows_bytes(s1, d1)))
        fbuf_s, fbuf_n = torch.zeros_like(h1), torch.zeros_like(h1)
        cases.append(dict(
            name=f"block_gather_bwd_{rk}[block1]", key=f"block_gather_bwd_{rk}",
            replaces=f"{PALLAS}:58 gather_rows_pallas + {PALLAS}:132 gather_mean_pallas "
                     "(backward of both; JAX: autodiff of jnp.take)",
            shape=f"g_self {list(g1.shape)} self_pos [{n1}], g_neigh {list(g1n.shape)} "
                  f"pos/mask [{n1}, {f1}] -> {list(h1.shape)}",
            tol="atomic",
            kernel=lambda k=rk: gk.block_gather_bwd(g1, b1.self_pos, g1n, b1.neigh_pos,
                                                    b1.neigh_mask, s1, k),
            plain=lambda k=rk: gk.block_gather_bwd_plain(g1, b1.self_pos, g1n, b1.neigh_pos,
                                                         b1.neigh_mask, s1, k),
            library=lambda ex=expanded(g1n, rk), bs=fbuf_s, bn=fbuf_n: (
                bs.index_add_(0, ids1_l, g1), bn.index_add_(0, flat1, ex)),
            same_fn=lambda k=rk: same_fn(g1, g1n, k),
            nbytes=4 * n1 + 5 * n1 * f1 + 2 * rows_bytes(n1, d1) + rows_bytes(s1, d1)))

    # -- bf16 compute: the block kernels on bf16 rows, the assembly to bf16 --
    # the same batch and blocks; block 0's rows are the f32 tier's assembly
    # to bf16, block 1's and the gradients the f32 tensors above rounded.
    # The bound counts bf16 rows (2 bytes a value).  launches: the bf16_train
    # runs (mean over the bf16 tier; sum over the f32 tier), the store_int8
    # run (int8 tier) and the device_epoch bf16 compute run
    bf = torch.bfloat16
    feats_bf = gk.assemble(cv, src_row, miss_feats, out_dtype=bf)
    h1_bf, g1_bf, g1n_bf = h1.to(bf), g1.to(bf), g1n.to(bf)
    bf_runs = {"mean": bf_launches, "sum": bf_gcn_launches}
    for rk in ("mean", "sum"):
        for label, src, blk in (("block0", feats_bf, b0), ("block1", h1_bf, b1)):
            flat, offs, _ = reduce_inputs(blk.neigh_pos, blk.neigh_mask)
            n, f = blk.neigh_pos.shape
            d = src.shape[1]
            n_s = blk.self_pos.shape[0]
            neigh_rows = blk.neigh_pos[blk.neigh_mask]
            cases.append(dict(
                name=f"block_gather_fwd_{rk}_bf16[{label}]", key=f"block_gather_fwd_{rk}_bf16",
                launches=bf_runs[rk][f"block_gather_fwd_{rk}_bf16"],
                replaces=f"{PALLAS}:58 gather_rows_pallas + {PALLAS}:132 gather_mean_pallas "
                         "(bf16 source rows)",
                shape=f"src {list(src.shape)} bf16 self_pos [{n_s}] pos/mask [{n}, {f}]",
                tol=("exact", "bf16"),
                kernel=lambda s=src, b=blk, k=rk: gk.block_gather_fwd(
                    s, b.self_pos, b.neigh_pos, b.neigh_mask, k),
                plain=lambda s=src, b=blk, k=rk: gk.block_gather_fwd_plain(
                    s, b.self_pos, b.neigh_pos, b.neigh_mask, k),
                library=lambda s=src, ids=blk.self_pos.long(), fl=flat, of=offs, k=rk: (
                    torch.index_select(s, 0, ids),
                    torch.nn.functional.embedding_bag(fl, s, of, mode=k)),
                same_fn=lambda s=src, b=blk, k=rk: fwd_same_fn(s, b, k),
                nbytes=4 * n_s + 5 * n * f + rows_bytes(distinct(blk.self_pos, neigh_rows), d, 2)
                + rows_bytes(n_s, d, 2) + rows_bytes(n, d, 2)))
        bs_bf, bn_bf = torch.zeros_like(h1_bf), torch.zeros_like(h1_bf)
        cases.append(dict(
            name=f"block_gather_bwd_{rk}_bf16[block1]", key=f"block_gather_bwd_{rk}_bf16",
            launches=bf_runs[rk][f"block_gather_bwd_{rk}_bf16"],
            replaces=f"{PALLAS}:58 gather_rows_pallas + {PALLAS}:132 gather_mean_pallas "
                     "(backward of both on bf16 gradients; JAX: autodiff of jnp.take)",
            shape=f"g_self {list(g1.shape)} bf16 self_pos [{n1}], g_neigh {list(g1n.shape)} "
                  f"bf16 pos/mask [{n1}, {f1}] -> {list(h1.shape)} bf16 (memset, the "
                  "reductions into an f32 table, grad_to_bf16: one C call)",
            tol="bf16",
            kernel=lambda k=rk: gk.block_gather_bwd(g1_bf, b1.self_pos, g1n_bf, b1.neigh_pos,
                                                    b1.neigh_mask, s1, k),
            plain=lambda k=rk: gk.block_gather_bwd_plain(g1_bf, b1.self_pos, g1n_bf,
                                                         b1.neigh_pos, b1.neigh_mask, s1, k),
            library=lambda ex=expanded(g1n_bf, rk), bs=bs_bf, bn=bn_bf: (
                bs.index_add_(0, ids1_l, g1_bf), bn.index_add_(0, flat1, ex)),
            same_fn=lambda k=rk: same_fn(g1_bf, g1n_bf, k),
            nbytes=4 * n1 + 5 * n1 * f1 + 2 * rows_bytes(n1, d1, 2) + rows_bytes(s1, d1, 2)))
    bf_assemble_runs = {"float32": bf_gcn_launches, "bfloat16": bf_launches,
                        "int8": q_launches}
    for dtype, tag in TIERS.items():
        cv_t, sr_t, mf_t, sc_t = tier_in[dtype]
        cases.append(dict(
            name=f"assemble[{tag}->bf16]", key=f"assemble_{tag}_to_bf16",
            launches=bf_assemble_runs[dtype][f"assemble_{tag}_to_bf16"],
            replaces=f"{PALLAS}:58 gather_rows_pallas (+ storage/cache.py:103 "
                     "assemble_features, :69 dequantize_fused, train/state.py:50 the bf16 cast)",
            shape=f"cache {list(cv_t.shape)} {cv_t.dtype} miss {list(mf_t.shape)} "
                  f"src_row [{n0}] -> bf16",
            tol="exact",
            kernel=lambda a=tier_in[dtype]: gk.assemble(*a, out_dtype=bf),
            plain=lambda a=tier_in[dtype]: gk.assemble_plain(*a, out_dtype=bf),
            library=None, same_fn=lambda a=tier_in[dtype]: assemble_same_fn(*a).to(bf),
            nbytes=4 * n0 + distinct(sr_t) * d0 * cv_t.element_size() + rows_bytes(n0, d0, 2)
            + (0 if sc_t is None else 4 * d0)))
    cv_f = d_full["bf16"][0]
    cases.append(dict(
        name="assemble_full[bf16->bf16]", key="assemble_bf16_to_bf16",
        launches=dev_out["bf16_compute"]["launches"]["assemble_bf16_to_bf16"],
        replaces=f"{PALLAS}:58 gather_rows_pallas (on-device layer-0 fetch at bf16 compute: "
                 "ops/gather.py:21 chunked_take + storage/cache.py:69 dequantize_fused "
                 "+ train/state.py:50 the bf16 cast)",
        shape=f"cache {list(cv_f.shape)} {cv_f.dtype} ids [{nd}], no miss rows -> bf16",
        tol="exact",
        kernel=lambda: take_rows(cv_f, d_ids, out_dtype=bf),
        plain=lambda: gk.assemble_plain(cv_f, d_ids, cv_f[:0], out_dtype=bf),
        library=lambda: torch.index_select(cv_f, 0, d_ids),
        same_fn=lambda: torch.index_select(cv_f, 0, d_ids),
        nbytes=4 * nd + nd_distinct * dd * 2 + rows_bytes(nd, dd, 2)))

    entries, bad = [], []
    for c in cases:
        err, ok, tol_text = compare(torch, c["kernel"](), c["plain"](), c["tol"])
        entry = {
            "name": c["name"], "route": "cuda", "source": SOURCE,
            "replaces": c["replaces"],
            "launches": c.get("launches", (gcn_launches if c["key"].endswith("_sum")
                                           else launches)[c["key"]]),
            "max_abs_err": err, "tolerance": tol_text,
            "ms": time_ms(torch, c["kernel"], flush),
            "plain_ms": time_ms(torch, c["plain"], flush),
            "bound_ms": c["nbytes"] / bw * 1e3, "bound_by": "bytes",
            "bound_bytes": c["nbytes"],
            "library_ms": time_ms(torch, c["library"], flush) if c["library"] else None,
            "shape": c["shape"],
        }
        if "same_fn" in c:
            entry["library_same_fn_ms"] = time_ms(torch, c["same_fn"], flush)
            entry["library_same_fn_max_abs_err"] = compare(
                torch, c["same_fn"](), c["plain"](), c["tol"])[0]
        entry["bound_share"] = entry["bound_ms"] / entry["ms"]
        entries.append(entry)
        if not ok:
            bad.append(f"{c['name']}: max_abs_err {err} ({tol_text})")
    print(json.dumps({"kernels": entries}), flush=True)
    if bad:
        fail("kernels disagree with their plain versions: " + "; ".join(bad))

    # -- the block forward's other branches, and the backward's ----------------
    branches = fwd_branches(torch, gk, dev)
    emit("fwd_branches", branches)
    bad = [f"{b['case']}: {b['max_abs_err']} ({b['tolerance']})"
           for b in branches if not b["ok"]]
    if bad:
        fail("block gather branches disagree with their plain versions: " + "; ".join(bad))
    branches = assemble_branches(torch, gk, dev)
    emit("assemble_branches", branches)
    bad = [f"{b['case']}: {b['max_abs_err']}" for b in branches if not b["ok"]]
    if bad:
        fail("assembly branches disagree with their plain versions: " + "; ".join(bad))

    # -- graph_block_kernels: the block kernels' forward and backward wrappers
    # captured in a CUDA graph (the backward launches from autograd's thread,
    # on the stream autograd runs it on) and replayed, against the eager call
    gen_g = torch.Generator(device=dev).manual_seed(9)
    g_src = torch.randn(b0.cap_dst, 2 * cfg.model.hidden, generator=gen_g, device=dev,
                        requires_grad=True)
    g_w = torch.randn(b1.cap_dst, 2 * cfg.model.hidden, generator=gen_g, device=dev)
    g_blk = Block(neigh_pos=b1.neigh_pos, neigh_mask=b1.neigh_mask, self_pos=b1.self_pos)

    def block_fwd_bwd():
        h_self, h_neigh = block_gather(g_src, g_blk, "mean")
        ((h_self * g_w).sum() + (h_neigh * g_w * 2).sum()).backward()
        return g_src.grad

    want_g = block_fwd_bwd().clone()
    g_src.grad = None
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        block_fwd_bwd()
    torch.cuda.current_stream(dev).wait_stream(side)
    g_src.grad = None
    gk.reset_launch_counts()
    block_graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(block_graph):
        got_g = block_fwd_bwd()
    captured = {k: v for k, v in gk.launch_counts().items() if v}
    got_g.zero_()
    block_graph.replay()
    err, ok, text = compare(torch, got_g, want_g, "atomic")
    emit("graph_block_kernels", {"captured_launches": captured, "max_abs_err": err,
                                 "tolerance": text})
    if not ok or captured != {"block_gather_fwd_mean": 1, "block_gather_bwd_mean": 1}:
        fail(f"the block kernels replayed from a CUDA graph: error {err} ({text}), "
             f"captured launches {captured}")
    del block_graph, got_g

    # what the times above cannot go below: the event pair around no work,
    # the block backward's memset of its table alone (its C entry point with
    # both halves absent), and a streamed copy of the block-0 forward's bytes
    table = torch.empty_like(h1)
    fwd0_bytes = next(c["nbytes"] for c in cases if c["name"] == "block_gather_fwd_mean[block0]")
    copy_src = torch.empty(fwd0_bytes // 2, dtype=torch.uint8, device=dev)
    copy_dst = torch.empty_like(copy_src)
    emit("timing_floor", {
        "empty_event_pair_ms": time_ms(torch, lambda: None, flush),
        "block_bwd_memset_ms": time_ms(torch, lambda: gk._lib().pg_block_gather_bwd(
            None, None, 0, None, None, None, 0, 0, table.data_ptr(), None, s1, d1, 0, 1, 0,
            torch.cuda.current_stream(dev).cuda_stream), flush),
        "memset_shape": [s1, d1],
        "copy_block0_fwd_bytes_ms": time_ms(torch, lambda: copy_dst.copy_(copy_src), flush),
        "copy_bytes_moved": 2 * copy_src.numel()})

    # -- step parity ------------------------------------------------------------
    def clone_state(src, c):
        """A train state with a copy of ``src``'s model and dropout
        generator and a fresh optimizer for config ``c``."""
        model = copy.deepcopy(src.model)
        g = torch.Generator(device=dev)
        g.set_state(src.generator.get_state())
        return TrainState(model=model, optimizer=make_optimizer(c, model.parameters()),
                          generator=g, dtype=src.dtype)

    parities = {}
    for dtype, tag in TIERS.items():
        cv_t, sr_t, mf_t, sc_t = tier_in[dtype]
        s_kernel, s_plain = clone_state(tr.state, cfg), clone_state(tr.state, cfg)
        gk.reset_launch_counts()
        m_kernel = train_step(s_kernel, mb, mf_t, sr_t, cv_t, sc_t)
        with gk.plain_versions():
            m_plain = train_step(s_plain, mb, mf_t, sr_t, cv_t, sc_t)
        torch.cuda.synchronize()
        counts = gk.launch_counts()
        l_k, l_p = m_kernel["loss"].item(), m_plain["loss"].item()
        parity = {"loss_kernel": l_k, "loss_plain": l_p,
                  "loss_rel_err": abs(l_k - l_p) / max(abs(l_p), 1e-30),
                  "kernel_launches": sum(counts.values()),
                  "assemble_launches": counts[f"assemble_{tag}"], "grads": {}}
        for (name, pk), (_, pp) in zip(s_kernel.model.named_parameters(),
                                       s_plain.model.named_parameters()):
            err = (pk.grad - pp.grad).abs().max().item()
            parity["grads"][name] = err / max(pp.grad.abs().max().item(), 1e-30)
        parities[dtype] = parity
    emit("step_parity", parities)
    for dtype, parity in parities.items():
        worst = max([parity["loss_rel_err"], *parity["grads"].values()])
        if not worst <= 1e-5:
            fail(f"step parity ({dtype} cache): worst relative error {worst} > 1e-5")
        if parity["kernel_launches"] != 4 or parity["assemble_launches"] != 1:
            fail(f"the kernel step ({dtype} cache) launched {parity['kernel_launches']} "
                 "kernels, expected 4 with one assembly of its tier")

    # -- bf16_step_parity: one bf16-compute step a tier, kernel and plain -----
    # from the bf16_train model; the loss within 1e-2 relative and each
    # gradient within ||g - g_plain|| <= 2e-2 ||g_plain|| (bf16 reductions
    # round in another order); 5 launches, all bf16; the assembly to bf16
    # bit-equal to its plain version
    bf_parities = {}
    for dtype, tag in TIERS.items():
        cv_t, sr_t, mf_t, sc_t = tier_in[dtype]
        s_kernel, s_plain = clone_state(bf_tr.state, bf_cfg), clone_state(bf_tr.state, bf_cfg)
        gk.reset_launch_counts()
        m_kernel = train_step(s_kernel, mb, mf_t, sr_t, cv_t, sc_t)
        with gk.plain_versions():
            m_plain = train_step(s_plain, mb, mf_t, sr_t, cv_t, sc_t)
        torch.cuda.synchronize()
        counts = {k: v for k, v in gk.launch_counts().items() if v}
        l_k, l_p = m_kernel["loss"].item(), m_plain["loss"].item()
        parity = {"loss_kernel": l_k, "loss_plain": l_p,
                  "loss_rel_err": abs(l_k - l_p) / max(abs(l_p), 1e-30),
                  "launches": counts,
                  "assemble_bit_equal": torch.equal(gk.assemble(*tier_in[dtype], out_dtype=bf),
                                                    gk.assemble_plain(*tier_in[dtype],
                                                                      out_dtype=bf)),
                  "grads_rel_norm_err": {}}
        for (name, pk), (_, pp) in zip(s_kernel.model.named_parameters(),
                                       s_plain.model.named_parameters()):
            parity["grads_rel_norm_err"][name] = (
                (pk.grad - pp.grad).norm().item() / max(pp.grad.norm().item(), 1e-30))
        bf_parities[dtype] = parity
    emit("bf16_step_parity", bf_parities)
    for dtype, parity in bf_parities.items():
        tag = TIERS[dtype]
        if not (parity["loss_rel_err"] <= 1e-2
                and max(parity["grads_rel_norm_err"].values()) <= 2e-2):
            fail(f"bf16 step parity ({dtype} cache): {parity}")
        if parity["launches"] != {f"assemble_{tag}_to_bf16": 1, "block_gather_fwd_mean_bf16": 2,
                                  "block_gather_bwd_mean_bf16": 1, "grad_to_bf16": 1}:
            fail(f"bf16 step parity ({dtype} cache): launches {parity['launches']}, expected "
                 f"one assemble_{tag}_to_bf16, two bf16 block forwards, one bf16 backward "
                 "and one grad_to_bf16")
        if not parity["assemble_bit_equal"]:
            fail(f"bf16 step parity ({dtype} cache): the assembly to bf16 is not bit-equal")

    # -- breakdown: host pipeline alone vs device step alone -----------------
    t0 = time.perf_counter()
    n_items = sum(1 for _ in tr.loader.epoch())
    torch.cuda.synchronize()
    loader_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sum(1 for _ in bf_tr.loader.epoch())
    torch.cuda.synchronize()
    loader_bf_s = time.perf_counter() - t0

    s_bench = clone_state(tr.state, cfg)
    t_step = host_and_device(lambda: train_step(s_bench, mb, miss_feats, src_row, cv),
                             dev_reps=4)
    cv_b, sr_b, mf_b, _ = tier_in["bfloat16"]
    s_bench_bf = clone_state(bf_tr.state, bf_cfg)
    t_step_bf = host_and_device(lambda: train_step(s_bench_bf, mb, mf_b, sr_b, cv_b),
                                dev_reps=4)
    emit("breakdown", {
        "loader_only_epoch_s": loader_s, "loader_batches": n_items,
        "train_epoch_s": epochs[1].time_s,
        "step_host_enqueue_ms": t_step["host_enqueue_ms"], "step_wall_ms": t_step["wall_ms"],
        "step_device_ms": t_step["device_ms"],
        "device_time_is_pure": t_step["device_time_is_pure"],
        "sleep_ms": t_step["sleep_ms"],
        "bf16_step": {"cache": "bfloat16", "compute": "bfloat16", **t_step_bf,
                      "loader_only_epoch_s": loader_bf_s,
                      "train_epoch_s": bf_epochs[1].time_s},
        "note": "steps on one pre-shipped batch, no loader threads running",
    })

    # -- device_sampler_parity: the sampler on the card and on the CPU ---------
    # one batch of the f32 run's epoch 0, fresh draws for each kind; the same
    # function on CPU copies of the same tensors must give equal batches
    nh, fanouts, bsz = dcfg.sampler.num_hops, dcfg.sampler.hop_fanouts(), dcfg.sampler.batch_size
    csr_cpu = DeviceCSR.from_graph(ds.graph, "cpu")
    gen_d = torch.Generator(device=dev).manual_seed(8)

    def fresh_draws(paired: bool):
        return [hop_draws(gen_d, n, f, paired, dev)
                for n, f in zip(hop_sizes(bsz, fanouts), fanouts)]

    def batch_tensors(m):
        return (list(m.layer_nids) + list(m.layer_mask) + [m.labels]
                + [t for b in m.blocks for t in (b.neigh_pos, b.neigh_mask, b.self_pos)])

    sampler_parity = {}
    for paired in (False, True):
        draws_p = fresh_draws(paired)
        mb_g = sample_minibatch_device(dtr._dev_csr, d_step[0], d_step[1], nh, fanouts, draws_p,
                                       labels=dtr._dev_labels, paired=paired)
        mb_c = sample_minibatch_device(csr_cpu, d_step[0].cpu(), d_step[1].cpu(), nh, fanouts,
                                       [x.cpu() for x in draws_p],
                                       labels=dtr._dev_labels.cpu(), paired=paired)
        pairs = list(zip(batch_tensors(mb_g), batch_tensors(mb_c)))
        sampler_parity["paired" if paired else "generic"] = {
            "equal": all(torch.equal(g.cpu(), c) for g, c in pairs), "tensors": len(pairs),
            "layer_rows": [x.shape[0] for x in mb_g.layer_nids],
            "valid_edges": int(sum(b.neigh_mask.sum() for b in mb_g.blocks)),
            "prefix_layout": all(b.prefix_layout for b in mb_g.blocks)}
    del csr_cpu
    emit("device_sampler_parity", sampler_parity)
    for kind_, r in sampler_parity.items():
        if not (r["equal"] and r["prefix_layout"]):
            fail(f"device sampler ({kind_}): the card's batch differs from the CPU's: {r}")

    # -- device_step_parity: one device-sampled step, kernel and plain --------
    dev_parities = {}
    for label in ("f32", "bf16_paired", "int8_paired"):
        t_d = dev_tr[label]
        tag = TIERS[t_d.cfg.cache.dtype]
        step_in = (d_step[0], d_step[1], fresh_draws(t_d.cfg.sampler.paired_draws),
                   t_d._dev_labels, t_d._dev_csr, t_d.cache.cache_values,
                   t_d.cache.dequant_scale_dev)
        res = {}
        for mode in ("kernel", "plain"):
            s_m, acc_m = clone_state(t_d.state, t_d.cfg), EpochAccumulator.zeros(dev)
            gk.reset_launch_counts()
            with (gk.plain_versions() if mode == "plain" else contextlib.nullcontext()):
                device_batch_step(t_d.cfg, s_m, acc_m, *step_in)
            torch.cuda.synchronize()
            res[mode] = (s_m, acc_m.values(), gk.launch_counts())
        (s_k, v_k, c_k), (s_p, v_p, c_p) = res["kernel"], res["plain"]
        parity = {"loss_kernel": v_k["loss_sum"], "loss_plain": v_p["loss_sum"],
                  "loss_rel_err": abs(v_k["loss_sum"] - v_p["loss_sum"])
                  / max(abs(v_p["loss_sum"]), 1e-30),
                  "edges": [v_k["edges"], v_p["edges"]],
                  "kernel_launches": sum(c_k.values()),
                  "assemble_launches": c_k[f"assemble_{tag}"],
                  "plain_launches": sum(c_p.values()), "grads": {}}
        for (name, pk), (_, pp) in zip(s_k.model.named_parameters(),
                                       s_p.model.named_parameters()):
            err = (pk.grad - pp.grad).abs().max().item()
            parity["grads"][name] = err / max(pp.grad.abs().max().item(), 1e-30)
        dev_parities[label] = parity
    emit("device_step_parity", dev_parities)
    for label, parity in dev_parities.items():
        worst = max([parity["loss_rel_err"], *parity["grads"].values()])
        if not worst <= 1e-5:
            fail(f"device step parity ({label}): worst relative error {worst} > 1e-5")
        if parity["edges"][0] != parity["edges"][1]:
            fail(f"device step parity ({label}): edges {parity['edges']} differ")
        if (parity["kernel_launches"], parity["assemble_launches"],
                parity["plain_launches"]) != (1, 1, 0):
            fail(f"device step parity ({label}): launches {parity}, expected one assembly "
                 "through the kernel and none under the plain versions")

    # -- device_breakdown: one on-device step alone (f32, generic draws) ------
    s_b, acc_b = clone_state(dtr.state, dcfg), EpochAccumulator.zeros(dev)
    d_cv = d_full["f32"][0]
    fetched = fetch_batch(dcfg, d_step[0], d_step[1], d_step[2], dtr._dev_labels,
                          dtr._dev_csr, d_cv)
    parts = {
        "step": lambda: device_batch_step(dcfg, s_b, acc_b, *d_step, dtr._dev_labels,
                                          dtr._dev_csr, d_cv),
        "sample": lambda: sample_minibatch_device(dtr._dev_csr, *d_step[:2], nh, fanouts,
                                                  d_step[2], labels=dtr._dev_labels),
        "fetch": lambda: take_rows(d_cv, d_ids),
        "train": lambda: train_batch(s_b, acc_b, *fetched),
    }

    def profiled(fn):
        """CUDA kernels, memory operations and their summed device time in
        one call, from a torch.profiler trace (the second of two calls, each
        traced), and the host operations with the most time of their own."""
        from torch.profiler import ProfilerActivity, profile
        for _ in range(2):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
        host_ops = sorted((a for a in prof.key_averages() if a.self_cpu_time_total > 0),
                          key=lambda a: -a.self_cpu_time_total)[:10]
        evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        mem = [e for e in evs if "memcpy" in e.name.lower() or "memset" in e.name.lower()]
        names: dict = {}
        for e in evs:
            names[e.name[:60]] = names.get(e.name[:60], 0) + 1
        return {"cuda_kernels": len(evs) - len(mem), "cuda_memory_ops": len(mem),
                "profiler_device_ms": sum(e.time_range.elapsed_us() for e in evs) / 1e3,
                "most_launched": sorted(names.items(), key=lambda kv: -kv[1])[:12],
                "host_self_ms_top": [[a.key[:60], a.count, a.self_cpu_time_total / 1e3]
                                     for a in host_ops]}

    # no host sync inside a step: the sync debug mode raises on one
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        parts["step"]()
        sync_free = True
    except RuntimeError as e:
        sync_free = f"{type(e).__name__}: {e}"
    finally:
        torch.cuda.set_sync_debug_mode("default")
    # one replayed step: the steps mode's step graph on the same state,
    # reading the f32 run's last epoch schedule
    _, parts["replayed_step"] = make_device_step_fns(dcfg, s_b, dtr.epoch_inputs,
                                                     dtr.device_data(), graph=True)
    breakdown_d = {name: {**host_and_device(fn), **profiled(fn)} for name, fn in parts.items()}
    breakdown_d["step_is_sync_free"] = sync_free
    breakdown_d["epoch_s"] = {"eager": dev_out["f32"]["epochs"][0]["time_s"],
                              "replayed": dev_out["f32"]["epochs"][1]["time_s"]}
    breakdown_d["epoch_batches"] = dev_out["f32"]["epochs"][1]["batches"]
    breakdown_d["note"] = ("device_batch_step on one device-sampled batch of the f32 run "
                           "(generic draws): sample, fetch (take_rows) and train "
                           "(forward, loss, backward, Adam) are its parts; replayed_step "
                           "replays the steps mode's CUDA graph of one step")
    emit("device_breakdown", breakdown_d)
    if sync_free is not True:
        fail(f"a device step synchronized with the host: {sync_free}")

    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
