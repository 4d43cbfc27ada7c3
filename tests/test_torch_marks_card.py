"""On a card (skipped without one): the phase marks of an on-device epoch's
CUDA graphs, seen by ``torch.profiler`` in a replay.  With tracing off a
replay runs no ``pg_mark_`` kernel; with it on, every mark of the epoch, in
the order of its phases; off again, none.  Run on the card with
``python -m pytest --noconftest tests/test_torch_marks_card.py`` (the
directory's conftest imports JAX, which the card's machine does not have)."""
import json
import os
import tempfile

import pytest
import torch

import pagraph_tpu_torch as pt
from pagraph_tpu_torch.data.synthetic import synthetic_dataset
from pagraph_tpu_torch.train.loop import Trainer

STEP = ["sample", "fetch", "forward", "backward", "optimizer", "accumulate"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _cfg(dispatch):
    return pt.Config(
        model=pt.ModelConfig(arch="graphsage", n_layers=2, hidden=32, feat_dim=24,
                             n_classes=5, aggregator="mean", dropout=0.5),
        sampler=pt.SamplerConfig(batch_size=256, fanouts=(5, 4, 3), num_hops=3, seed=7),
        cache=pt.CacheConfig(capacity=None),
        train=pt.TrainConfig(lr=1e-2, on_device_sampling=True, epoch_dispatch=dispatch))


def _marks_run(fn):
    """The ``pg_mark_`` kernels a profiled ``fn()`` ran, by start, as phases
    (read from the exported Chrome trace)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    ks = sorted((e["ts"], e["name"]) for e in events
                if e.get("cat") == "kernel" and e.get("name", "").startswith("pg_mark_"))
    return [name[len("pg_mark_"):] for _, name in ks]


@pytest.mark.card
@pytest.mark.parametrize("dispatch", ["scan", "steps", "pipelined"])
def test_replayed_graphs_run_their_marks_only_when_traced(card, dispatch):
    ds = synthetic_dataset(num_nodes=5000, num_edges=60000, feat_dim=24, num_classes=5,
                           seed=11, learnable=True)
    tr = Trainer.from_dataset(_cfg(dispatch), ds, seed=3)
    nb = tr.epoch_inputs.num_batches
    want = ["epoch"] + STEP * nb + ["epoch_end"]

    def check(got):
        if dispatch == "pipelined":    # each gather runs ahead of the training before it
            assert sorted(got) == sorted(want) and got[0] == "epoch" and got[-1] == "epoch_end"
        else:
            assert got == want

    tr.timers.use_scopes = True
    check(_marks_run(lambda: tr.train(1)))                     # the eager form
    tr.timers.use_scopes = False
    assert _marks_run(lambda: tr.train(2, start_epoch=1)) == []  # capture, first replay
    assert tr.epoch_runner.graph
    # a graph's marks: scan's whole epoch; steps' prepare and one step;
    # pipelined's prepare, two gathers and two trainings (epoch_end: the runner's)
    captured = {"scan": len(want), "steps": 1 + 6, "pipelined": 1 + 2 * 2 + 2 * 4}[dispatch]
    assert sum(len(g.marks) for g in tr.epoch_runner.graphs) == captured
    tr.timers.use_scopes = True
    check(_marks_run(lambda: tr.train(3, start_epoch=2)))
    tr.timers.use_scopes = False
    assert _marks_run(lambda: tr.train(4, start_epoch=3)) == []
    losses = [em.mean_loss for em in tr.epoch_metrics]
    assert all(map(torch.isfinite, torch.tensor(losses))), losses
