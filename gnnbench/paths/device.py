"""The on-device path on one card: ``Trainer`` with
``train.on_device_sampling`` (``pagraph_tpu_torch/train/loop.py``), each
epoch one ``DeviceEpochRunner`` call (``train/device_epoch.py``): the eager
form for epoch 0, CUDA graphs from epoch 1 on.

Set-up: the dataset (generated in a checkout's first run), the Trainer and
its weights, epoch 0 eager with :class:`probe.StepProbe` reading the first
steps, then epoch 1, which captures the graphs and replays them once.  The
window runs whole epochs from epoch 2 until ``--seconds`` have passed and
the epoch in flight has synced, the program's state copied on the device
before and after its first epoch (:class:`probe.EpochSnapshot`).  With
``--trace 1`` its first ``trace_epochs`` epochs run under the profiler.
Once the window has closed and the peak memory has been read, the program
is freed and the reference checks its first steps, the window's first
epoch (a replay) from the state before it, and the sampled counts of epoch
0 and of the window's first and last epochs.
"""
from __future__ import annotations

import gc
import importlib
import math
import time
from typing import Optional

import torch

from .. import check, data
from ..harness import Run, log
from ..metrics import Readings
from ..probe import EpochSnapshot, StepProbe
from ..reference import streams
from ..trace import profiled


def port_config(config: dict, workload: dict, dtype: Optional[str] = None):
    """The program's ``Config`` of a cell; ``dtype`` overrides the compute
    dtype (the control's ``bfloat16``)."""
    from pagraph_tpu_torch.config import (CacheConfig, Config, ModelConfig, SamplerConfig,
                                          TrainConfig)

    s = config["sampler"]
    fan = tuple(int(f) for f in s["fanouts"])
    return Config(model=ModelConfig(**config["model"]),
                  sampler=SamplerConfig(batch_size=s["batch_size"], fanouts=fan,
                                        num_hops=len(fan)),
                  cache=CacheConfig(capacity=None),
                  train=TrainConfig(lr=config["train"]["lr"],
                                    dtype=dtype or config["train"]["dtype"],
                                    **workload["train"]))


def set_weights(state, config: dict, seed: int, device) -> None:
    """The benchmark's initial weights (:func:`streams.uniform_leaves`) into
    the program's parameters, which must be the reference's leaves."""
    arch = importlib.import_module(f"{__package__.rsplit('.', 1)[0]}.reference."
                                   f"{config['model']['arch']}")
    specs = arch.param_specs(config["model"])
    named = dict(state.model.named_parameters())
    want = {k: tuple(shape) for k, shape, _ in specs}
    have = {k: tuple(p.shape) for k, p in named.items()}
    if want != have:
        raise RuntimeError(f"the program's parameters {have} are not the reference's {want}")
    init = streams.uniform_leaves(specs, seed, device)
    with torch.no_grad():
        for k, p in named.items():
            p.copy_(init[k])


def load_arrays(run: Run) -> dict:
    """The configuration's dataset, made on the run's device (host arrays);
    the device's peak memory is counted from here on, the program's."""
    t = time.perf_counter()
    arrays = data.generate(run.config["data"], run.device)
    if torch.device(run.device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    log(f"dataset {run.config['name']}: made in {time.perf_counter() - t:.1f} s, "
        f"{len(arrays['indptr']) - 1} vertices, {len(arrays['indices'])} edges")
    return arrays


def build_trainer(run: Run, arrays: dict, dtype: Optional[str] = None):
    from pagraph_tpu_torch.graph import CSRGraph
    from pagraph_tpu_torch.storage.feature_store import FeatureStore
    from pagraph_tpu_torch.train.loop import Trainer

    cfg = port_config(run.config, run.workload, dtype)
    graph = CSRGraph(indptr=arrays["indptr"], indices=arrays["indices"],
                     out_degrees=arrays["out_degrees"])
    store = FeatureStore.build(graph, arrays["features"])
    tr = Trainer(cfg, store, graph, arrays["train"], arrays["labels"], device=run.device,
                 seed=run.seed)
    set_weights(tr.state, run.config, run.seed, tr.device)
    tr.state.generator.manual_seed(streams.dropout_seed(run.seed))
    run.at("trainer", trainer=tr)
    return tr


def first_epochs(run: Run, tr) -> StepProbe:
    """Epoch 0, eager, with the probe on its first steps; then epoch 1,
    which captures the graphs and replays them once (a fault of the replay
    alone is planted in between, at the ``replay`` hook)."""
    with StepProbe(run.workload["check_steps"]) as probe:
        tr.train(1)
    run.at("replay", trainer=tr)
    tr.train(2, start_epoch=1)
    return probe


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_window(run: Run, tr, first: int) -> dict:
    """Whole epochs from ``first`` until ``run.seconds`` have passed, the
    first ``trace_epochs`` traced with ``--trace 1``; ``snap`` holds the
    state before and after the first."""
    snap = EpochSnapshot(tr.state, first)
    sync(tr.device)
    t0 = time.perf_counter()
    epoch = first
    out = {"t0": t0, "snap": snap}

    def one_epoch() -> None:
        nonlocal epoch
        tr.train(epoch + 1, start_epoch=epoch)
        if epoch == first:
            snap.end(tr.state)
        epoch += 1

    if run.trace:
        tr.timers.use_scopes = True
        enq = (tr.timers.total["enqueue"], tr.timers.count["enqueue"])
        with profiled(True, cuda=tr.device.type == "cuda") as prof:
            for _ in range(run.workload["trace_epochs"]):
                one_epoch()
        tr.timers.use_scopes = False
        out.update(trace=prof["trace"], traced=list(range(first, epoch)),
                   enqueue=(tr.timers.total["enqueue"] - enq[0],
                            tr.timers.count["enqueue"] - enq[1]))
    while epoch == first or time.perf_counter() - t0 < run.seconds:
        one_epoch()
    out["t1"] = time.perf_counter()
    out["epochs"] = list(range(first, epoch))
    return out


def free() -> None:
    """Hand the memory of what the caller dropped back to the device."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def stamp(run: Run, what: str) -> None:
    """Log how far into the run's set-up ``what`` ended."""
    log(f"{time.perf_counter() - run.t_start:8.2f} s  {what}")


def reading_epochs(run: Run, tr) -> tuple:
    """Epochs 0 and 1 (:func:`first_epochs`), then epoch 2, the second
    replay, as a run's window starts: what a run's check reads, without a
    measured window (``calibrate.py``).  ``(probe, snapshot, epoch 2's mean
    loss, {epoch: (edges, vertices)} of epochs 0 and 2)``."""
    probe = first_epochs(run, tr)
    snap = EpochSnapshot(tr.state, 2)
    tr.train(3, start_epoch=2)
    snap.end(tr.state)
    ems = {em.epoch: em for em in tr.epoch_metrics}
    return (probe, snap.read(tr.state), ems[2].mean_loss,
            {e: (ems[e].edges, ems[e].vertices) for e in (0, 2)})


def checked(run: Run, inp: check.Inputs, probe: StepProbe, snap: dict, prog_loss: float,
            counted: dict) -> dict:
    """The numbers of a run: its first steps, the replayed epoch ``snap``
    holds, and the counts ``counted`` (``{epoch: (edges, vertices)}``)
    against the reference's."""
    config = run.config
    numbers = check.first_steps(inp, config, run.seed, probe, run.workload["check_steps"])
    replayed, counts = check.replay(inp, config, run.seed, snap, prog_loss)
    numbers.update(replayed)
    ref = {e: counts if e == snap["epoch"] else check.epoch_counts(inp, config, run.seed, e)
           for e in counted}
    numbers["count_mismatch"] = sum(abs(counted[e][0] - ref[e][0]) + abs(counted[e][1] - ref[e][1])
                                    for e in counted)
    return numbers


def run_cell(run: Run) -> dict:
    config, wl = run.config, run.workload
    stamp(run, "imports")
    arrays = load_arrays(run)
    stamp(run, "dataset")
    tr = build_trainer(run, arrays)
    stamp(run, "Trainer")
    probe = first_epochs(run, tr)
    stamp(run, "epochs 0 (eager, probed) and 1 (capture, first replay)")
    win = run_window(run, tr, first=2)
    setup_s = win["t0"] - run.t_start
    n_train = len(arrays["train"])
    nb = check.num_batches(n_train, config["sampler"]["batch_size"])
    ems = {em.epoch: em for em in tr.epoch_metrics}
    window = [ems[e] for e in win["epochs"]]
    bad_steps = sum(em.num_batches for em in window if not math.isfinite(em.mean_loss))
    wrong_steps = sum(abs(em.num_batches - nb) for em in window)
    elapsed = win["t1"] - win["t0"]
    peak = (torch.cuda.max_memory_allocated(tr.device) if tr.device.type == "cuda" else 0)
    timers = {k: float(v) for k, v in tr.timers.total.items()}
    snap = win["snap"].read(tr.state)
    counted = {e: (ems[e].edges, ems[e].vertices) for e in (0, snap["epoch"], win["epochs"][-1])}
    log(f"window: {len(window)} epochs, {elapsed:.3f} s, set-up {setup_s:.3f} s, "
        f"peak {peak} bytes, timers {timers}")
    del tr
    free()
    t_check = time.perf_counter()
    inp = check.Inputs(arrays, run.device)
    numbers = checked(run, inp, probe, snap, ems[snap["epoch"]].mean_loss, counted)
    numbers["count_mismatch"] += wrong_steps
    log(f"check: {time.perf_counter() - t_check:.1f} s")
    out = {
        "e2e": {"seeds_per_s": n_train * len(window) / elapsed, "setup_s": setup_s},
        "numbers": numbers,
        "attempted": nb * len(window),
        "failed": bad_steps,
        "memory_peak_bytes": int(peak),
    }
    if run.trace:
        traced = win["traced"]
        rows = check.layer_rows(config)
        arch = importlib.import_module(f"{__package__.rsplit('.', 1)[0]}.flops."
                                       f"{config['model']['arch']}")
        steps = nb * len(traced)
        out["readings"] = Readings(
            trace=win["trace"], epochs=len(traced), steps=steps,
            flops=float(arch.step_flops(config["model"], rows)) * steps,
            take_rows_bytes=check.take_rows_bytes(inp, config, run.seed, traced),
            enqueue_s=win["enqueue"][0], enqueue_count=win["enqueue"][1],
            capture_s=timers.get("capture"))
    del inp
    free()
    return out
