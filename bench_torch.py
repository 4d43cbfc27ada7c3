#!/usr/bin/env python3
"""Headline benchmark of the PyTorch/CUDA port (``pagraph_tpu_torch``):
GraphSAGE neighbor-sampled training throughput on one GPU (the port of
``bench.py``, whose workload, phases and output it keeps).

Workload: 2-layer GraphSAGE (reference default shape: batch 6000, fan-out 2,
hidden 16, 47-class head; BASELINE.md) on an RMAT power-law graph standing in
for ogbn-products (generated on the machine at comparable scale: RMAT scale
20, 1,048,576 vertices, 16,084,917 edges, 100-dim features).

    python3 bench_torch.py          # from the repository root, one CUDA card

Prints ONE JSON line on standard output:
    {"metric": "edges_per_s_per_chip", "value": N, "unit": "edges/s",
     "vs_baseline": R, "detail": {...}}

``vs_baseline`` is the speedup over a reference-equivalent naive path
measured in the same run: no device feature cache (every batch ships all its
feature rows from host memory) — the "DGL baseline" ablation the reference
ships as dgl_gcn.py/dgl_gs.py.  ``detail`` carries the card's name and power
limit (``nvidia-smi``).  Progress and each phase's timers go to stderr.

The headline is the larger of the host path's (``full``) and the on-device
path's (``device``, or ``paired``/``bf16`` where faster) median edges/s,
and the two paths count edges differently: the host path deduplicated
edges, the on-device path every valid slot of its undeduplicated layers.

Environment:
  PAGRAPH_BENCH_PHASES    comma list (default baseline,partial,full,device,
                          paired,mlp; bf16 is opt-in)
  PAGRAPH_BENCH_DEADLINE  seconds before the watchdog prints the best result
                          so far and exits with code 1 (default 3300)
  PAGRAPH_BENCH_DATA      where the generated dataset is kept as raw .npy
                          files (default ~/.cache/pagraph_tpu_torch_bench)
  PAGRAPH_BENCH_FAST_PRNG read and ignored: torch has one generator
                          implementation
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

METRIC = "edges_per_s_per_chip"
DEFAULT_PHASES = "baseline,partial,full,device,paired,mlp"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


_best_result = None     # updated as phases finish; the watchdog prints it


def arm_watchdog(seconds: float) -> None:
    """If the whole bench exceeds its budget (a hung copy or kernel), print
    the best result gathered so far as the one JSON line, marked as cut, and
    exit with code 1."""
    import threading

    def fire():
        log(f"[bench] WATCHDOG: exceeded {seconds:.0f}s, emitting "
            "best-so-far result")
        r = _best_result or {
            "metric": METRIC, "value": 0.0,
            "unit": "edges/s", "vs_baseline": 0.0,
            "detail": {"error": "watchdog timeout before any phase finished"},
        }
        r["detail"]["watchdog_expired_s"] = seconds
        print(json.dumps(r), flush=True)
        os._exit(1)

    t = threading.Timer(seconds, fire)
    t.daemon = True
    t.start()


def _nbr_labels(path: str, graph, feats: np.ndarray) -> np.ndarray:
    """Structure-dependent labels (the 2-hop teacher,
    ``data/synthetic.py`` ``neighborhood_labels``, seed 9), kept beside the
    dataset.  At the reference shape this bench times (hidden 16, fan-out 2)
    the GNN underfits the 47-class task below the structure-blind MLP
    control, so ``final_acc`` is a loss-decreases check on the training
    loop: the JSON carries the ``mlp_probe`` ceiling beside it
    (``accuracy_control``)."""
    lab_path = os.path.join(path, "labels_nbr.npy")
    if os.path.exists(lab_path):
        return np.load(lab_path)
    from pagraph_tpu_torch.data.synthetic import neighborhood_labels
    t0 = time.time()
    labels = neighborhood_labels(graph, feats, 47, seed=9)
    np.save(lab_path, labels)
    log(f"[bench] neighborhood teacher labels built in {time.time()-t0:.1f}s")
    return labels


def build_dataset(cache_dir: str):
    """RMAT scale-20 graph (1,048,576 vertices, 16,084,917 edges), 100-dim
    features, generated once and cached in raw .npy CSR form (compressed
    npz decompression alone costs a minute)."""
    from pagraph_tpu_torch.data.formats import Dataset
    from pagraph_tpu_torch.data.synthetic import random_split_masks, rmat_coo
    from pagraph_tpu_torch.graph import CSRGraph

    path = os.path.join(cache_dir, "rmat20_raw")
    marker = os.path.join(path, "ok")
    if os.path.exists(marker):
        log(f"[bench] loading cached dataset from {path}")
        t0 = time.time()
        ld = lambda n: np.load(os.path.join(path, n + ".npy"))
        graph = CSRGraph(ld("indptr"), ld("indices"), ld("out_degrees"))
        feat = ld("feat")
        ds = Dataset(graph, feat, _nbr_labels(path, graph, feat),
                     ld("train"), ld("val"), ld("test"))
        log(f"[bench] loaded in {time.time()-t0:.1f}s")
        return ds
    log("[bench] generating RMAT scale-20 dataset (one-time)...")
    t0 = time.time()
    coo = rmat_coo(20, 16, seed=42)
    graph = CSRGraph.from_coo(coo)
    n = graph.num_nodes
    rng = np.random.default_rng(7)
    feats = rng.random((n, 100), dtype=np.float32)
    # structure-free labels kept on disk for provenance; training uses the
    # neighborhood-teacher labels (_nbr_labels)
    proj = rng.normal(size=(100, 47)).astype(np.float32)
    labels = np.argmax(feats @ proj, axis=1).astype(np.int64)
    train, val, test = random_split_masks(n, seed=11)
    os.makedirs(path, exist_ok=True)
    for name, arr in [("indptr", graph.indptr), ("indices", graph.indices),
                      ("out_degrees", graph.out_degrees), ("feat", feats),
                      ("labels", labels), ("train", train), ("val", val),
                      ("test", test)]:
        np.save(os.path.join(path, name + ".npy"), arr)
    with open(marker, "w") as f:
        f.write("ok")
    labels = _nbr_labels(path, graph, feats)
    log(f"[bench] dataset ready in {time.time()-t0:.1f}s: "
        f"{graph.num_nodes} vertices, {graph.num_edges} edges")
    return Dataset(graph, feats, labels, train, val, test)


def _hit_path_probe(tr, K: int = 17) -> dict:
    """Link-independent partial-cache metrics: (a) the last epoch's miss-row
    count and bytes (deterministic given the seeds: read before the probe's
    own batches are planned), (b) the hit-path step time: one packed group
    copied to the card once, then its step graph (the Trainer's host-step
    CUDA graph of its key) replayed K times behind a synchronize and timed
    with CUDA events, so no host-to-device copy lies inside the timing.  On
    the CPU there is no device time: ``hit_step_ms`` is None."""
    miss_rows = int(tr.cache.miss_num)
    out = {
        "hit_step_ms": None,
        "miss_rows_last_epoch": miss_rows,
        "miss_mb_last_epoch": round(
            miss_rows * tr.cache.total_dim * tr.cache.row_dtype.itemsize / 1e6, 1),
    }
    if tr.device.type != "cuda":
        return out
    import torch

    if tr.group_graphs is None:
        raise RuntimeError("the hit-path probe replays the host-step graphs: "
                           "train 2 epochs or more first")
    groups = tr.loader.groups(tr.steps_per_dispatch)
    group = next(groups)
    groups.close()
    graph = tr.group_graphs.load(group)      # copied in (captured if its key is new)
    graph()                                  # warm
    torch.cuda.synchronize(tr.device)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(K):
        graph()
    end.record()
    end.synchronize()
    out["hit_step_ms"] = round(start.elapsed_time(end) / (K * group.k), 3)
    return out


def run(ds, *, cache_enabled: bool, epochs: int, seed: int = 0,
        capacity=None, on_device: bool = False, cache_dtype: str = "float32",
        paired: bool = False, hit_probe: bool = False, device=None):
    """One phase: a fresh ``Trainer`` of the bench configuration for
    ``epochs``; the medians of the epochs after the warm-up one.  ``device``:
    ``None`` is the card; the tests pass ``"cpu"``."""
    import pagraph_tpu_torch as pt
    from pagraph_tpu_torch.train.loop import Trainer

    cfg = pt.Config(
        model=pt.ModelConfig(arch="graphsage", n_layers=1, hidden=16,
                             feat_dim=100, n_classes=47, aggregator="mean",
                             dropout=0.2),
        sampler=pt.SamplerConfig(batch_size=6000, fanout=2, num_hops=2,
                                 seed=seed, prefetch=3, paired_draws=paired),
        cache=pt.CacheConfig(enabled=cache_enabled, capacity=capacity,
                             dtype=cache_dtype),
        # scan_unroll as bench.py sets it; the port reads it not
        train=pt.TrainConfig(lr=1e-2, warmup_epochs=1,
                             on_device_sampling=on_device,
                             scan_unroll=4 if on_device else 1),
    )
    tr = Trainer.from_dataset(cfg, ds, seed=seed, log=False, device=device)
    tr.train(epochs)
    w = cfg.train.warmup_epochs
    steady = tr.epoch_metrics[w:] or tr.epoch_metrics
    epoch_time = float(np.median([m.time_s for m in steady]))
    edges_per_s = float(np.median([m.edges / m.time_s for m in steady]))
    out = {
        "epoch_time_s": epoch_time,
        "edges_per_s": edges_per_s,
        "miss_rate": tr.epoch_metrics[-1].miss_rate,
        "final_loss": tr.epoch_metrics[-1].mean_loss,
        "final_acc": tr.epoch_metrics[-1].mean_acc,
        "timers": tr.timers.summary(),
    }
    if hit_probe and not on_device:
        out["probe"] = _hit_path_probe(tr)
    return out


def card_identity() -> dict:
    """The card this run measures: nvidia-smi's name and power limit (W).
    Raises without a card: the bench measures the GPU, never the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: bench_torch.py measures a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name, power = (s.strip() for s in smi.split(",", 1))
    return {"device": name, "power_limit_w": float(power.split()[0]), "nvidia_smi": smi}


def build_result(ds, base, partial, full, device, card: dict) -> dict:
    """The one JSON line, in ``bench.py``'s schema, with the card's name
    and power limit in ``detail``.  The headline takes the faster of the
    host (``full``) and the on-device (``device``) phase, whose edge counts
    differ (see the module's docstring)."""
    cands = [r for r in (full, device) if r] or [r for r in (partial, base) if r]
    ours = max(cands, key=lambda r: r["edges_per_s"])
    detail = {
        "workload": (f"graphsage-2layer rmat20({ds.num_nodes:,} v, "
                     f"{ds.graph.num_edges:,} e) batch6000 fanout2"),
        "epoch_time_s": round(ours["epoch_time_s"], 3),
        "epochs_per_hr": round(3600.0 / ours["epoch_time_s"], 1),
        "cache_hit_rate": round(1.0 - ours["miss_rate"], 4),
    }
    if base:
        detail["baseline_edges_per_s"] = round(base["edges_per_s"], 1)
    if partial:
        detail["partial_cache_40pct"] = {
            "edges_per_s": round(partial["edges_per_s"], 1),
            "hit_rate": round(1.0 - partial["miss_rate"], 4),
            **partial.get("probe", {}),
        }
    if full and device:
        detail["host_pipeline_edges_per_s"] = round(full["edges_per_s"], 1)
        detail["on_device_edges_per_s"] = round(device["edges_per_s"], 1)
    detail["device"] = card["device"]
    detail["power_limit_w"] = card["power_limit_w"]
    return {
        "metric": METRIC,
        "value": round(ours["edges_per_s"], 1),
        "unit": "edges/s",
        "vs_baseline": (
            round(ours["edges_per_s"] / max(base["edges_per_s"], 1e-9), 3)
            if base else 1.0
        ),
        "detail": detail,
    }


def main():
    global _best_result
    from pagraph_tpu_torch.utils.platform import tune_host_allocator

    card = card_identity()
    log(f"[bench] {card['nvidia_smi']}")
    arm_watchdog(float(os.environ.get("PAGRAPH_BENCH_DEADLINE", "3300")))
    t0 = time.time()
    tune_host_allocator(1 << 30)
    log(f"[bench] allocator tuned + heap warmed in {time.time()-t0:.1f}s")
    if "PAGRAPH_BENCH_FAST_PRNG" in os.environ:
        log("[bench] PAGRAPH_BENCH_FAST_PRNG is ignored: torch has one generator")
    cache_dir = os.environ.get(
        "PAGRAPH_BENCH_DATA", os.path.expanduser("~/.cache/pagraph_tpu_torch_bench"))
    os.makedirs(cache_dir, exist_ok=True)
    ds = build_dataset(cache_dir)

    phases = os.environ.get("PAGRAPH_BENCH_PHASES", DEFAULT_PHASES)
    base = partial = full = device = None
    if "baseline" in phases:
        log("[bench] baseline (no device cache)...")
        base = run(ds, cache_enabled=False, epochs=2)
        log(f"[bench] baseline: {base['edges_per_s']:.0f} edges/s, "
            f"epoch {base['epoch_time_s']:.2f}s")

    if "partial" in phases:
        log("[bench] partial cache (40% capacity, degree-ranked)...")
        partial = run(ds, cache_enabled=True, epochs=4,
                      capacity=int(ds.num_nodes * 0.4), hit_probe=True)
        log(f"[bench] partial: {partial['edges_per_s']:.0f} edges/s, "
            f"hit rate {1 - partial['miss_rate']:.1%}, "
            f"probe {partial.get('probe')}")
        log(f"[bench] phase timers: {partial['timers']}")

    if "full" in phases:
        log("[bench] pagraph path (degree-ranked device cache)...")
        full = run(ds, cache_enabled=True, epochs=6)
        log(f"[bench] full: {full['edges_per_s']:.0f} edges/s, "
            f"epoch {full['epoch_time_s']:.2f}s, "
            f"miss rate {full['miss_rate']:.1%}, "
            f"acc {full['final_acc']:.3f}")
        log(f"[bench] phase timers: {full['timers']}")

    if base or partial or full:
        _best_result = build_result(ds, base, partial, full, None, card)
    plain_eps = paired_eps = None
    if "device" in phases:
        # whole-epoch on-device path: sampling on the card, zero host bytes a step
        log("[bench] on-device path (epoch = one graph replay)...")
        device = run(ds, cache_enabled=True, epochs=6, on_device=True)
        plain_eps = device["edges_per_s"]
        log(f"[bench] device: {device['edges_per_s']:.0f} edges/s, "
            f"epoch {device['epoch_time_s']:.2f}s, "
            f"acc {device['final_acc']:.3f}")
        log(f"[bench] phase timers: {device['timers']}")

    if "paired" in phases:
        # paired row-gather draws: one 32 B aligned row gather serves all
        # fan-out slots of a vertex (sampling/device_sampler.sample_hop)
        log("[bench] on-device path, paired draws...")
        dp_ = run(ds, cache_enabled=True, epochs=6, on_device=True, paired=True)
        paired_eps = dp_["edges_per_s"]
        log(f"[bench] device paired: {dp_['edges_per_s']:.0f} edges/s, "
            f"epoch {dp_['epoch_time_s']:.2f}s, acc {dp_['final_acc']:.3f}")
        if device and dp_["edges_per_s"] > device["edges_per_s"]:
            device = dp_

    if "bf16" in phases:
        # opt-in: bfloat16 feature rows on the on-device path (halves the
        # layer-0 fetch's bytes)
        log("[bench] on-device path, bf16 feature tier...")
        d16 = run(ds, cache_enabled=True, epochs=6, on_device=True,
                  cache_dtype="bfloat16")
        log(f"[bench] device bf16: {d16['edges_per_s']:.0f} edges/s, "
            f"epoch {d16['epoch_time_s']:.2f}s, acc {d16['final_acc']:.3f}")
        if device and d16["edges_per_s"] > device["edges_per_s"]:
            device = d16

    result = build_result(ds, base, partial, full, device, card)
    if plain_eps is not None:
        result["detail"]["device_plain_edges_per_s"] = round(plain_eps, 1)
    if paired_eps is not None:
        result["detail"]["device_paired_edges_per_s"] = round(paired_eps, 1)

    acc_src = device or full
    if acc_src and "mlp" in phases:
        # the reference-shape accuracy is a loss-decreases check: the
        # structure-blind MLP ceiling goes beside it
        log("[bench] structure-blind MLP control (2-layer, own features)...")
        from pagraph_tpu_torch.models.mlp_probe import mlp_val_acc
        t0 = time.time()
        mlp_acc = mlp_val_acc(ds.features, ds.labels, ds.train_mask,
                              ds.val_mask, steps=200, max_train=100_000)
        log(f"[bench] mlp control: {mlp_acc:.4f} in {time.time()-t0:.0f}s")
        result["detail"]["accuracy_control"] = {
            "final_acc": round(acc_src["final_acc"], 4),
            "mlp_ceiling": round(float(mlp_acc), 4),
            "note": ("reference shape (hid16/fan2) underfits the structure "
                     "task below the MLP control; final_acc is a training-"
                     "loop sanity check, not a certification of the "
                     "aggregation path"),
        }
    if not math.isfinite(result["value"]):
        raise RuntimeError(f"non-finite headline {result['value']}")
    _best_result = result
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
