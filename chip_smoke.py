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
  ``Trainer.from_dataset``, with each kernel's launch count; then one epoch
  with the ``gcn`` aggregator, the path of the ``sum`` kind;
* ``kernels``: every kernel on a batch of that run at its main-path shapes,
  against its plain PyTorch version on the card (K1 exact, K2 within 1e-6
  of the output's scale, the atomicAdd backwards within 1e-5), timed with
  CUDA events (L2 flushed between launches) beside its plain version, one
  PyTorch library call where one computes the same function, and its
  device-memory bound;
* ``step_parity``: one train step from the same parameters and batch,
  through the kernels and through the plain versions: loss and every
  gradient within 1e-5 relative (atomic summation order);
* ``breakdown``: where the epoch's time goes — an epoch of the loader alone
  (host sampling, miss gather, pinned H2D), and one train step alone on a
  shipped batch (host enqueue time, wall time, device time).

Any failed check exits non-zero without the final line.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import copy
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
        from pagraph_tpu_torch.train.loop import Trainer
        from pagraph_tpu_torch.train.state import (TrainState, make_optimizer,
                                                   train_step)
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

    def config(aggregator: str):
        return pt.Config(
            model=pt.ModelConfig(arch="graphsage", n_layers=1, hidden=16,
                                 feat_dim=100, n_classes=47,
                                 aggregator=aggregator, dropout=0.2),
            sampler=pt.SamplerConfig(batch_size=6000, fanout=2, num_hops=2,
                                     seed=0, prefetch=3),
            cache=pt.CacheConfig(enabled=True, capacity=int(ds.num_nodes * 0.4)),
            train=pt.TrainConfig(lr=1e-2, warmup_epochs=1),
        )

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
    launches = gk.launch_counts()
    main_keys = ("gather_rows", "assemble_from_map", "scatter_add_rows",
                 "gather_reduce_mean", "gather_reduce_bwd_mean")
    train_out = {
        "graph": {"vertices": ds.num_nodes, "edges": ds.graph.num_edges},
        "caps": list(tr.sampler.caps), "cache_capacity": tr.cache.capacity,
        "dataset_s": data_s, "setup_s": setup_s,
        "epochs": [{"epoch": m.epoch, "time_s": m.time_s,
                    "edges": m.edges, "edges_per_s": m.edges / m.time_s,
                    "miss_rate": m.miss_rate, "mean_loss": m.mean_loss,
                    "mean_acc": m.mean_acc, "batches": m.num_batches,
                    "h2d_bytes": m.h2d_bytes} for m in epochs],
        "step_host_ms": tr.timers.summary()["step"]["mean_ms"],
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
    for k in ("gather_reduce_sum", "gather_reduce_bwd_sum"):
        if gcn_launches[k] <= 0:
            fail(f"kernel {k} was not launched by the gcn-aggregator run")
    losses = [m.mean_loss for m in epochs] + [gcn_epoch.mean_loss]
    if not all(math.isfinite(v) for v in losses):
        fail(f"non-finite loss {losses}")
    if not epochs[1].mean_loss < epochs[0].mean_loss:
        fail(f"loss did not fall: {epochs[0].mean_loss} -> {epochs[1].mean_loss}")

    # -- kernels: one batch of the run, at its shapes ------------------------
    seeds = tr.sampler.train_nids[:cfg.sampler.batch_size]
    mb_h = tr.sampler.sample(seeds)
    plan = tr.cache.fetch_plan(mb_h.input_nids, mb_h.input_mask, track=False)
    mb = mb_h.to(dev)
    miss_feats = torch.from_numpy(plan.miss_feats).to(dev)
    miss_slot = torch.from_numpy(plan.miss_slot).to(dev)
    cv, cmap = tr.cache.cache_values, tr.cache.cache_map_dev
    b0, b1 = mb.blocks
    gen = torch.Generator(device=dev).manual_seed(1)
    feats = gk.assemble_from_map(cv, cmap, mb.input_nids, miss_slot, miss_feats)
    h1 = torch.randn(b0.cap_dst, 2 * cfg.model.hidden, generator=gen, device=dev)
    g1 = torch.randn(b1.cap_dst, 2 * cfg.model.hidden, generator=gen, device=dev)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def rows_bytes(n, d):
        return 4 * n * d

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
            nbytes=4 * n + 2 * rows_bytes(n, d)))

    gather_case("block0 self", feats, b0.self_pos)
    gather_case("block1 self", h1, b1.self_pos)
    n0, d0 = mb.input_nids.shape[0], cv.shape[1]
    cases.append(dict(
        name="assemble_from_map[layer0]", key="assemble_from_map",
        replaces=f"{PALLAS}:58 gather_rows_pallas (+ storage/cache.py:112 "
                 "assemble_features_from_map)",
        shape=f"cache {list(cv.shape)} miss {list(miss_feats.shape)} nids [{n0}]",
        tol="exact",
        kernel=lambda: gk.assemble_from_map(cv, cmap, mb.input_nids, miss_slot, miss_feats),
        plain=lambda: gk.assemble_from_map_plain(cv, cmap, mb.input_nids, miss_slot, miss_feats),
        library=None, nbytes=3 * 4 * n0 + 2 * rows_bytes(n0, d0)))
    sbuf = torch.zeros_like(h1)
    ids1_l = b1.self_pos.long()
    cases.append(dict(
        name="scatter_add_rows[block1 self bwd]", key="scatter_add_rows",
        replaces=f"{PALLAS}:58 gather_rows_pallas (backward; JAX: autodiff of jnp.take)",
        shape=f"grad_out {list(g1.shape)} -> [{h1.shape[0]}, {h1.shape[1]}]",
        tol="atomic",
        kernel=lambda: gk.scatter_add_rows(g1, b1.self_pos, h1.shape[0]),
        plain=lambda: gk.scatter_add_rows_plain(g1, b1.self_pos, h1.shape[0]),
        library=lambda: sbuf.index_add_(0, ids1_l, g1),
        nbytes=4 * g1.shape[0] + rows_bytes(*g1.shape) + rows_bytes(*h1.shape)))
    for rk in ("mean", "sum"):
        for label, src, blk in (("block0", feats, b0), ("block1", h1, b1)):
            flat, offs, valid = reduce_inputs(blk.neigh_pos, blk.neigh_mask)
            n, f = blk.neigh_pos.shape
            d = src.shape[1]
            cases.append(dict(
                name=f"gather_reduce_{rk}[{label}]", key=f"gather_reduce_{rk}",
                replaces=f"{PALLAS}:132 gather_mean_pallas",
                shape=f"src {list(src.shape)} pos/mask [{n}, {f}]", tol="reduce",
                kernel=lambda s=src, b=blk, k=rk: gk.gather_reduce(s, b.neigh_pos, b.neigh_mask, k),
                plain=lambda s=src, b=blk, k=rk: gk.gather_reduce_plain(s, b.neigh_pos, b.neigh_mask, k),
                library=lambda s=src, fl=flat, of=offs, k=rk: torch.nn.functional.embedding_bag(
                    fl, s, of, mode=k),
                nbytes=5 * n * f + rows_bytes(valid, d) + rows_bytes(n, d)))
        flat, offs, valid = reduce_inputs(b1.neigh_pos, b1.neigh_mask)
        rows = b1.neigh_mask.nonzero(as_tuple=True)[0]
        cnt = b1.neigh_mask.sum(1, keepdim=True).clamp(min=1).float()
        expanded = (g1 / cnt if rk == "mean" else g1)[rows].contiguous()
        bbuf = torch.zeros_like(h1)
        n, f = b1.neigh_pos.shape
        cases.append(dict(
            name=f"gather_reduce_bwd_{rk}[block1]", key=f"gather_reduce_bwd_{rk}",
            replaces=f"{PALLAS}:132 gather_mean_pallas (backward; JAX: autodiff of jnp.take)",
            shape=f"grad_out {list(g1.shape)} pos/mask [{n}, {f}] -> {list(h1.shape)}",
            tol="atomic",
            kernel=lambda k=rk: gk.gather_reduce_bwd(g1, b1.neigh_pos, b1.neigh_mask, h1.shape[0], k),
            plain=lambda k=rk: gk.gather_reduce_bwd_plain(g1, b1.neigh_pos, b1.neigh_mask, h1.shape[0], k),
            library=lambda fl=flat, ex=expanded, bb=bbuf: bb.index_add_(0, fl, ex),
            nbytes=5 * n * f + rows_bytes(*g1.shape) + rows_bytes(*h1.shape)))

    tolerances = {"exact": 0.0, "reduce": 1e-6, "atomic": 1e-5}
    entries, bad = [], []
    for c in cases:
        out_k, out_p = c["kernel"](), c["plain"]()
        torch.cuda.synchronize()
        err = (out_k - out_p).abs().max().item()
        scale = max(out_p.abs().max().item(), 1e-30)
        ok = err <= tolerances[c["tol"]] * scale
        entry = {
            "name": c["name"], "route": "cuda", "source": SOURCE,
            "replaces": c["replaces"], "launches": launches[c["key"]]
            if c["key"] in main_keys else gcn_launches[c["key"]],
            "max_abs_err": err, "tolerance": f"{c['tol']}: |err| <= "
            f"{tolerances[c['tol']]} * max|plain| ({scale:.6g})",
            "ms": time_ms(torch, c["kernel"], flush),
            "plain_ms": time_ms(torch, c["plain"], flush),
            "bound_ms": c["nbytes"] / bw * 1e3, "bound_by": "bytes",
            "bound_bytes": c["nbytes"],
            "library_ms": time_ms(torch, c["library"], flush) if c["library"] else None,
            "shape": c["shape"],
        }
        entries.append(entry)
        if not ok:
            bad.append(f"{c['name']}: max_abs_err {err} ({c['tol']})")
    print(json.dumps({"kernels": entries}), flush=True)
    if bad:
        fail("kernels disagree with their plain versions: " + "; ".join(bad))

    # -- step parity ------------------------------------------------------------
    def fresh_state():
        model = copy.deepcopy(tr.state.model)
        g = torch.Generator(device=dev)
        g.set_state(tr.state.generator.get_state())
        return TrainState(model=model, optimizer=make_optimizer(cfg, model.parameters()),
                          generator=g)

    s_kernel, s_plain = fresh_state(), fresh_state()
    gk.reset_launch_counts()
    m_kernel = train_step(s_kernel, mb, miss_feats, miss_slot, cv, cmap)
    with gk.plain_versions():
        m_plain = train_step(s_plain, mb, miss_feats, miss_slot, cv, cmap)
    torch.cuda.synchronize()
    step_launches = sum(gk.launch_counts().values())
    l_k, l_p = m_kernel["loss"].item(), m_plain["loss"].item()
    parity = {"loss_kernel": l_k, "loss_plain": l_p,
              "loss_rel_err": abs(l_k - l_p) / max(abs(l_p), 1e-30),
              "kernel_launches": step_launches, "grads": {}}
    for (name, pk), (_, pp) in zip(s_kernel.model.named_parameters(),
                                   s_plain.model.named_parameters()):
        err = (pk.grad - pp.grad).abs().max().item()
        parity["grads"][name] = err / max(pp.grad.abs().max().item(), 1e-30)
    emit("step_parity", parity)
    worst = max([parity["loss_rel_err"], *parity["grads"].values()])
    if not worst <= 1e-5:
        fail(f"step parity: worst relative error {worst} > 1e-5")
    if step_launches != 7:
        fail(f"the kernel step launched {step_launches} kernels, expected 7")

    # -- breakdown: host pipeline alone vs device step alone -----------------
    t0 = time.perf_counter()
    n_items = sum(1 for _ in tr.loader.epoch())
    torch.cuda.synchronize()
    loader_s = time.perf_counter() - t0
    s_bench = fresh_state()
    train_step(s_bench, mb, miss_feats, miss_slot, cv, cmap)
    torch.cuda.synchronize()
    reps = 20                            # host: enqueue, then wall to the sync
    t0 = time.perf_counter()
    for _ in range(reps):
        train_step(s_bench, mb, miss_feats, miss_slot, cv, cmap)
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    # device: few enough steps to fit the launch queue, behind a ~0.1 s
    # device sleep that outlasts their host enqueue
    dev_reps = 4
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(200_000_000)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(dev_reps):
        train_step(s_bench, mb, miss_feats, miss_slot, cv, cmap)
    ev[2].record()
    dev_enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    sleep_ms = ev[0].elapsed_time(ev[1])
    emit("breakdown", {
        "loader_only_epoch_s": loader_s, "loader_batches": n_items,
        "train_epoch_s": epochs[1].time_s,
        "step_host_enqueue_ms": enqueue_ms, "step_wall_ms": wall_ms,
        "step_device_ms": ev[1].elapsed_time(ev[2]) / dev_reps,
        "device_time_is_pure": dev_enqueue_ms < sleep_ms,
        "sleep_ms": sleep_ms,
        "note": "steps on one pre-shipped batch, no loader threads running",
    })

    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
