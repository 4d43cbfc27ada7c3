"""Data-parallel training on the device over PaGraph's partitions: one
process and one card a rank, ``DataParallelTrainer``
(``pagraph_tpu_torch/parallel/dp_trainer.py``) with the ``cache`` feature
source and on-device epochs, gradients all-reduced over ``nccl`` inside
each rank's epoch graph.

The parent process starts the ranks with the program's
``parallel/multihost.py`` ``spawn_local``.  Each rank loads the dataset,
reads the dg assignment of the train vertices to the ranks (the program's
``partition/dg_part.py`` ``dg_assign``, computed by rank 0 in a checkout's
first run and kept beside the dataset: an input the program prepares, which
the reference takes as it is), builds its own part's self-reliant closure
in memory (``partition/utils.py`` ``extract_partition``), its Trainer and
the benchmark's weights, runs epoch 0 eagerly with the probe and epoch 1
(the capture), then the window: whole lockstep epochs until rank 0 has seen
``--seconds`` pass, the decision broadcast after each epoch so that every
rank runs the same epochs, each rank's state copied before and after the
first.  After the
window each rank reads its peak memory, the ranks compare their parameters
bit for bit, the program is freed, and the reference runs as a
data-parallel reference: each rank rebuilds its part with
``reference/partition.py``, samples and trains its own batches in plain
torch, and the ranks average their reference gradients in float64 before
the same Adam update, over the first steps and over the window's first
epoch.  Each rank compares its own, and looks at its own ``sys.modules``;
rank 0 gathers the numbers (the worst over the ranks), the modules found
and its trace, and writes them for the parent, which prints the line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import importlib
import os
import pickle
import tempfile
import time

import numpy as np
import torch

from .. import check
from ..harness import Run, forbidden_loaded, log
from ..metrics import Readings
from ..probe import EpochSnapshot
from . import device as single


def assignment(run: Run, arrays: dict, rank: int) -> np.ndarray:
    """The part of each train vertex: the program's dg assignment at
    ``partition.assign_hops``, computed by rank 0 in a checkout's first run
    and kept under ``gnnbench/.cache/dg/`` by the digest of the graph and
    train vertices it was computed for; the other ranks read it there (a
    rank whose dataset differs finds none and fails)."""
    import torch.distributed as dist

    p = run.workload["partition"]
    digest = hashlib.sha256()
    for k in ("indptr", "indices", "train"):
        digest.update(np.ascontiguousarray(arrays[k]).data)
    path = os.path.join(run.cache_dir(), "dg", f"{run.config['name']}_p{run.workload['world_size']}"
                        f"_h{p['assign_hops']}_{digest.hexdigest()[:16]}.npy")
    if rank == 0 and not os.path.exists(path):
        from pagraph_tpu_torch.graph import CSRGraph
        from pagraph_tpu_torch.partition.dg_part import dg_assign

        t = time.perf_counter()
        graph = CSRGraph(arrays["indptr"], arrays["indices"], arrays["out_degrees"])
        belongs = dg_assign(graph, arrays["train"], run.workload["world_size"],
                            p["assign_hops"], backend="native")
        log(f"dg assignment over {len(belongs)} train vertices in "
            f"{time.perf_counter() - t:.1f} s: {np.bincount(belongs).tolist()} a part")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.save(path + ".partial.npy", belongs)
        os.replace(path + ".partial.npy", path)
    dist.barrier()
    return np.load(path)


def run_cell(run: Run) -> dict:
    from pagraph_tpu_torch.parallel.multihost import spawn_local

    spec = dataclasses.replace(run, hook=None)
    world = run.workload["world_size"]
    with tempfile.TemporaryDirectory() as tmp:
        spawn_local(_rank_main, world, spec, tmp,
                    backend="nccl" if run.device == "cuda" else "gloo",
                    timeout=run.seconds + 900)
        with open(os.path.join(tmp, "rank0.pkl"), "rb") as f:
            return pickle.load(f)


def _stop(rank: int, t0: float, seconds: float, device) -> bool:
    """Rank 0's decision, whether the window has run long enough, on every
    rank."""
    import torch.distributed as dist

    flag = torch.tensor([int(rank == 0 and time.perf_counter() - t0 >= seconds)],
                        device=device)
    dist.broadcast(flag, 0)
    return bool(flag.item())


def _rank_main(rank: int, world: int, run: Run, out_dir: str) -> None:
    """A rank: with ``run.fault`` (tests) planted in this process first."""
    if run.fault is None:
        return _rank(rank, world, run, out_dir)
    from ..faults import planted

    with planted(run.fault, run):
        return _rank(rank, world, run, out_dir)


def _build(run: Run, rank: int, dev) -> tuple:
    """This rank's dataset, the assignment, its part (the program's
    closure) and the full store: what every Trainer of the rank reads."""
    from pagraph_tpu_torch.graph import CSRGraph
    from pagraph_tpu_torch.partition.utils import extract_partition
    from pagraph_tpu_torch.storage.feature_store import FeatureStore

    arrays = single.load_arrays(run)
    belongs = assignment(run, arrays, rank)
    graph = CSRGraph(arrays["indptr"], arrays["indices"], arrays["out_degrees"])
    mine = np.sort(arrays["train"][belongs == rank])
    part = extract_partition(graph, mine, arrays["labels"],
                             run.workload["partition"]["closure_hops"], backend="native")
    return arrays, belongs, part, FeatureStore.build(graph, arrays["features"])


def _trainer(run: Run, part, store, dev, dtype=None):
    from pagraph_tpu_torch.parallel.dp_trainer import DataParallelTrainer

    tr = DataParallelTrainer(single.port_config(run.config, run.workload, dtype), store, part,
                             device=dev, seed=run.seed)
    single.set_weights(tr.state, run.config, run.seed, dev)
    run.at("trainer", trainer=tr)
    return tr


def _replica_gap(tr, world: int) -> int:
    """Ranks whose parameters differ from this rank's, bit for bit."""
    import torch.distributed as dist

    flat = torch.cat([p.detach().reshape(-1) for p in tr.state.model.parameters()])
    gathered = [torch.empty_like(flat) for _ in range(world)]
    dist.all_gather(gathered, flat)
    return sum(int(not torch.equal(g, flat)) for g in gathered)


def _worst(numbers: dict, dev) -> dict:
    """Each number's largest value over the ranks."""
    import torch.distributed as dist

    keys = sorted(numbers)
    t = torch.tensor([float(numbers[k]) for k in keys], dtype=torch.float64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return dict(zip(keys, t.tolist()))


def _device(run: Run):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if run.device == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _rank(rank: int, world: int, run: Run, out_dir: str) -> None:
    import torch.distributed as dist

    dev = _device(run)
    cuda = dev.type == "cuda"
    wl = run.workload
    arrays, belongs, part, store = _build(run, rank, dev)
    tr = _trainer(run, part, store, dev)
    probe = single.first_epochs(run, tr)
    snap = EpochSnapshot(tr.state, 2)
    single.sync(dev)
    dist.barrier()
    t0 = time.perf_counter()
    epoch, traced, enq = 2, [], (0.0, 0)
    prof = {}

    def one_epoch() -> None:
        nonlocal epoch
        tr.train(epoch + 1, start_epoch=epoch)
        if epoch == 2:
            snap.end(tr.state)
        epoch += 1

    if run.trace and rank == 0:
        tr.timers.use_scopes = True
        e0 = (tr.timers.total["enqueue"], tr.timers.count["enqueue"])
        from ..trace import profiled
        with profiled(True, cuda=cuda) as prof:
            for _ in range(wl["trace_epochs"]):
                one_epoch()
        tr.timers.use_scopes = False
        traced = list(range(2, epoch))
        enq = (tr.timers.total["enqueue"] - e0[0], tr.timers.count["enqueue"] - e0[1])
    elif run.trace:
        for _ in range(wl["trace_epochs"]):
            one_epoch()
    while True:
        one_epoch()
        if _stop(rank, t0, run.seconds, dev):
            break
    t1 = time.perf_counter()
    window = list(range(2, epoch))
    ems = {em.epoch: em for em in tr.epoch_metrics}
    steps = tr.steps
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    timers = {k: float(v) for k, v in tr.timers.total.items()}
    replica_gap = _replica_gap(tr, world)
    counted = {e: (ems[e].edges, ems[e].vertices) for e in (0, 2, window[-1])}
    bad = sum(em.num_batches for em in (ems[e] for e in window)
              if not np.isfinite(em.mean_loss))
    wrong = sum(abs(ems[e].num_batches - steps) for e in window)
    state = snap.read(tr.state)
    del tr, part, store
    single.free()
    inp = check.Inputs.part(arrays, belongs, rank, wl["partition"]["closure_hops"], steps, dev)
    numbers = _reference(run, inp, world, probe, state, ems[2].mean_loss, counted)
    numbers["replica_gap"] = replica_gap
    numbers["count_mismatch"] += wrong
    numbers = _worst(numbers, dev)
    peak_t = torch.tensor([peak], dtype=torch.int64, device=dev)
    dist.all_reduce(peak_t, op=dist.ReduceOp.MAX)
    take_bytes = (check.take_rows_bytes(inp, run.config, run.seed, traced)
                  if run.trace and rank == 0 else None)
    del inp
    single.free()
    found = [None] * world
    dist.all_gather_object(found, forbidden_loaded())
    if rank != 0:
        return
    out = {
        "e2e": {"seeds_per_s": world * steps * run.config["sampler"]["batch_size"] * len(window)
                / (t1 - t0), "setup_s": t0 - run.t_start},
        "numbers": numbers,
        "attempted": world * steps * len(window),
        "failed": bad * world,
        "memory_peak_bytes": int(peak_t.item()),
        "forbidden": sorted({m for f in found for m in f}),
    }
    log(f"rank 0 window: {len(window)} epochs, {t1 - t0:.3f} s; timers {timers}")
    if run.trace:
        arch = importlib.import_module(f"{__package__.rsplit('.', 1)[0]}.flops."
                                       f"{run.config['model']['arch']}")
        n = steps * len(traced)
        out["readings"] = Readings(
            trace=prof["trace"], epochs=len(traced), steps=n,
            flops=float(arch.step_flops(run.config["model"], check.layer_rows(run.config))) * n,
            take_rows_bytes=take_bytes,
            enqueue_s=enq[0], enqueue_count=enq[1], capture_s=timers.get("capture"))
    _write(out_dir, out)


def _write(out_dir: str, obj) -> None:
    path = os.path.join(out_dir, "rank0.pkl")
    with open(path + ".partial", "wb") as f:
        pickle.dump(obj, f)
    os.replace(path + ".partial", path)


def _mean(world: int, dev):
    """The mean over the ranks, in float64, of a flat tensor or a float."""
    import torch.distributed as dist

    def mean(x):
        t = (x.double() if isinstance(x, torch.Tensor)
             else torch.tensor([x], dtype=torch.float64, device=dev))
        dist.all_reduce(t)
        t = t / world
        return t if isinstance(x, torch.Tensor) else float(t[0])

    return mean


def _reference(run: Run, inp: check.Inputs, world: int, probe, snap: dict,
               prog_loss: float, counted: dict) -> dict:
    """This rank's reference against its probe and its replayed epoch (in
    float64), the gradients and losses averaged over the ranks; the counts
    ``counted`` (the program's, summed over the ranks) against the sums of
    the ranks' reference counts."""
    import torch.distributed as dist

    config = run.config
    mean = _mean(world, inp.device)
    numbers = check.first_steps(inp, config, run.seed, probe, run.workload["check_steps"],
                                mean_grads=mean)
    replayed, counts = check.replay(inp, config, run.seed, snap, prog_loss, mean_grads=mean,
                                    mean_loss=mean)
    numbers.update(replayed)
    ref = {e: counts if e == snap["epoch"] else check.epoch_counts(inp, config, run.seed, e)
           for e in counted}
    mism = 0
    for e, (edges, verts) in counted.items():
        tot = torch.tensor(ref[e], dtype=torch.int64, device=inp.device)
        dist.all_reduce(tot)
        mism += abs(edges - int(tot[0])) + abs(verts - int(tot[1]))
    numbers["count_mismatch"] = mism
    return numbers


def calibrate(run: Run, plan) -> list:
    """The limit readings of a data-parallel cell (``calibrate.py``): for
    each ``(kind, seed, fault)`` of ``plan`` the program's epochs 0 to 2 on
    every rank (:func:`device.reading_epochs`), then the reference's
    numbers, the worst over the ranks; the dataset, the parts and the
    reference's parts built once."""
    from pagraph_tpu_torch.parallel.multihost import spawn_local

    with tempfile.TemporaryDirectory() as tmp:
        spawn_local(_calibrate_rank, run.workload["world_size"], dataclasses.replace(run, hook=None),
                    tmp, list(plan),
                    backend="nccl" if run.device == "cuda" else "gloo")
        with open(os.path.join(tmp, "rank0.pkl"), "rb") as f:
            return pickle.load(f)


def _calibrate_rank(rank: int, world: int, run: Run, out_dir: str, plan) -> None:
    from ..faults import planted

    dev = _device(run)
    arrays, belongs, part, store = _build(run, rank, dev)
    inp = None
    rows = []
    for kind, seed, fault in plan:
        r = dataclasses.replace(run, seed=seed)
        t = time.perf_counter()
        with planted(fault, r) if fault else contextlib.nullcontext():
            tr = _trainer(r, part, store, dev, "bfloat16" if kind == "control" else None)
            probe, snap, loss, counted = single.reading_epochs(r, tr)
        steps = tr.steps
        gap = _replica_gap(tr, world)
        del tr
        single.free()
        if inp is None:
            inp = check.Inputs.part(arrays, belongs, rank, run.workload["partition"]["closure_hops"],
                                    steps, dev)
        numbers = _reference(r, inp, world, probe, snap, loss, counted)
        numbers["replica_gap"] = gap
        rows.append({"kind": kind, "seed": seed, "numbers": _worst(numbers, dev),
                     "s": time.perf_counter() - t})
    if rank == 0:
        _write(out_dir, rows)
