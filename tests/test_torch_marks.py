"""The port's tracing on the CPU: the phase marks a step makes (recorded
through a hook on ``gather_kernels.mark``, which launches nothing here),
the rule by which ``mark`` launches on a card, the host spans of a
device-path epoch in a ``maybe_trace`` Chrome trace, the set-up spans, the
loader's spans, and ``PhaseTimers`` under threads."""
import glob
import json
import os
import re
import sys
import threading

import pytest
import torch

import pagraph_tpu_torch as pt
from pagraph_tpu_torch.data.synthetic import synthetic_dataset
from pagraph_tpu_torch.ops import gather_kernels as gk
from pagraph_tpu_torch.parallel.multihost import init_distributed
from pagraph_tpu_torch.sampling.loader import PrefetchLoader
from pagraph_tpu_torch.sampling.sampler import NeighborSampler
from pagraph_tpu_torch.storage.cache import FeatureCache
from pagraph_tpu_torch.storage.feature_store import FeatureStore
from pagraph_tpu_torch.train.loop import Trainer
from pagraph_tpu_torch.utils.timers import PhaseTimers, maybe_trace

DATA = dict(num_nodes=600, num_edges=4800, feat_dim=16, num_classes=5, seed=3, learnable=True)
STEP = ["sample", "fetch", "forward", "backward", "optimizer", "accumulate"]
HOST_STEP = STEP[1:]
EPOCH_SPANS = ("train", "enqueue", "enqueue.randomness", "enqueue.launch", "epoch.eager",
               "epoch.wait", "epoch.metrics")
SETUP_SPANS = ("setup.cache", "setup.csr", "setup.state", "cache.fill")
LOAD_SPANS = ("load.sample", "load.pack", "load.put", "load.wait", "load.stack")
CU_SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "pagraph_tpu_torch", "csrc", "gather_kernels.cu")


@pytest.fixture(scope="module")
def ds():
    return synthetic_dataset(**DATA)


def _cfg(on_device=True, dispatch="scan", capacity=None, batch=64):
    return pt.Config(
        model=pt.ModelConfig(arch="graphsage", n_layers=1, hidden=16, feat_dim=16,
                             n_classes=5, aggregator="mean", dropout=0.5),
        sampler=pt.SamplerConfig(batch_size=batch, fanouts=(3, 2), num_hops=2, seed=7),
        cache=pt.CacheConfig(capacity=capacity),
        train=pt.TrainConfig(lr=1e-2, on_device_sampling=on_device, epoch_dispatch=dispatch))


@pytest.fixture
def marks(monkeypatch):
    """The phases ``mark`` is asked to launch eagerly (``traced``), in order."""
    seen = []
    real = gk.mark

    def record(phase, device, traced):
        real(phase, device, traced)             # the CPU's: checks the phase, launches nothing
        if traced:
            seen.append(phase)

    monkeypatch.setattr(gk, "mark", record)
    return seen


def test_mark_phases_are_the_kernel_sources_markers():
    with open(CU_SOURCE) as f:
        src = f.read()
    table = re.search(r"kMarks\[\]\)\(\) = \{([^}]*)\}", src).group(1)
    assert tuple(re.findall(r"pg_mark_(\w+)", table)) == gk.MARK_PHASES
    assert set(re.findall(r"__global__ void pg_mark_(\w+)\(\) \{\}", src)) == set(gk.MARK_PHASES)


def test_mark_launches_on_the_card_when_traced_or_capturing(monkeypatch):
    launched = []

    class Lib:
        @staticmethod
        def pg_mark(code, stream):
            launched.append(code)
            return 0

    capturing = [False]
    monkeypatch.setattr(gk, "_lib", lambda: Lib)
    monkeypatch.setattr(gk, "_stream", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    card = torch.device("cuda", 0)
    gk.mark("sample", card, False)
    assert launched == []
    gk.mark("sample", card, True)
    capturing[0] = True
    gk.mark("epoch_end", card, False)
    assert launched == [gk.MARK_PHASES.index("sample"), gk.MARK_PHASES.index("epoch_end")]
    gk.mark("forward", torch.device("cpu"), True)
    assert len(launched) == 2
    with pytest.raises(ValueError, match="phase must be one of"):
        gk.mark("warmup", card, True)


@pytest.mark.parametrize("dispatch", ["scan", "steps", "pipelined"])
def test_a_device_epoch_marks_its_phases_only_when_traced(ds, marks, dispatch):
    tr = Trainer.from_dataset(_cfg(dispatch=dispatch), ds, device="cpu")
    nb = tr.epoch_inputs.num_batches
    tr.timers.use_scopes = True
    tr.train(1)
    if dispatch == "pipelined":         # each gather ahead of the training before it
        assert marks[0] == "epoch" and marks[-1] == "epoch_end"
        assert {p: marks.count(p) for p in STEP} == {p: nb for p in STEP}
        assert marks[1:5] == ["sample", "fetch", "sample", "fetch"]
    else:
        assert marks == ["epoch"] + STEP * nb + ["epoch_end"]
    assert tr.state.trace_marks
    tr.timers.use_scopes = False
    del marks[:]
    tr.train(2, start_epoch=1)
    assert marks == [] and not tr.state.trace_marks


def test_a_host_epoch_marks_fetch_to_accumulate(ds, marks):
    tr = Trainer.from_dataset(_cfg(on_device=False, capacity=200), ds, device="cpu")
    tr.train(1)
    assert marks == []
    tr.timers.use_scopes = True
    tr.train(2, start_epoch=1)
    assert marks == HOST_STEP * tr.epoch_metrics[-1].num_batches


def test_a_data_parallel_epoch_marks_its_sync(ds, marks):
    import torch.distributed as dist

    from pagraph_tpu_torch.parallel.dp_trainer import DataParallelTrainer

    init_distributed(0, 1, backend="gloo")
    try:
        tr = DataParallelTrainer.from_dataset(_cfg(), ds, device="cpu")
        tr.timers.use_scopes = True
        tr.train(1)
        step = STEP[:4] + ["sync"] + STEP[4:]
        assert marks == ["epoch"] + step * tr.steps + ["epoch_end"]
        assert {k: tr.timers.count[k] for k in ("train", "epoch.seed", "epoch.wait")} == {
            "train": 1, "epoch.seed": 1, "epoch.wait": 1}
    finally:
        dist.destroy_process_group()


def test_a_traced_device_epoch_names_its_host_spans(ds, tmp_path):
    tr = Trainer.from_dataset(_cfg(), ds, device="cpu")
    tr.timers.use_scopes = True
    with maybe_trace(str(tmp_path), device="cpu"):
        tr.train(1)
    (path,) = glob.glob(os.path.join(tmp_path, "trace_*.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert set(EPOCH_SPANS) <= names
    assert {k: tr.timers.count[k] for k in EPOCH_SPANS} == {
        "train": 1, "enqueue": 1, "enqueue.randomness": 1, "enqueue.launch": 1,
        "epoch.eager": 1, "epoch.wait": 1,
        "epoch.metrics": 3}    # its metrics, the evaluation's check, the summary


def test_set_up_spans(ds):
    tr = Trainer.from_dataset(_cfg(), ds, device="cpu")
    assert {k: tr.timers.count[k] for k in SETUP_SPANS} == {
        "setup.cache": 1, "setup.csr": 1, "setup.state": 1, "cache.fill": 0}
    tr.train(2)
    assert tr.timers.count["cache.fill"] == 1
    assert tr.timers.count["epoch.eager"] == 2          # the CPU runs the eager form
    assert "setup.state" in tr.summary()["phase_timers"]


@pytest.mark.parametrize("k", [1, 3])
def test_the_loaders_spans_count_one_an_item_or_a_wait(ds, k):
    cfg = _cfg(on_device=False, capacity=200)
    store = FeatureStore.build(ds.graph, ds.features)
    cache = FeatureCache(store, ["features"], ds.graph, device="cpu")
    cache.fill(capacity=200)
    sampler = NeighborSampler(ds.graph, ds.train_nids, cfg.sampler, labels=ds.labels, seed=1)
    timers = PhaseTimers()
    loader = PrefetchLoader(sampler, cache, device="cpu", timers=timers)
    groups = list(loader.groups(k))
    items = sum(g.k for g in groups)
    assert items == sampler.num_batches
    assert {s: timers.count[s] for s in LOAD_SPANS} == {
        "load.sample": items, "load.pack": items, "load.put": items,
        "load.wait": items + 1,                  # the last get takes the end of the epoch
        "load.stack": -(-items // k)}
    assert loader.timers is timers and PrefetchLoader(sampler, cache, device="cpu").timers


def test_phase_timers_are_exact_under_threads():
    timers, n_threads, entries = PhaseTimers(), 8, 1000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def enter():
            for _ in range(entries):
                with timers.scope("shared"):
                    pass

        threads = [threading.Thread(target=enter) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert timers.count["shared"] == n_threads * entries
    assert timers.summary()["shared"]["count"] == n_threads * entries
