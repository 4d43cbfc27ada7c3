"""The host path at the JAX package's defaults: ``steps_per_dispatch`` K
steps a dispatch over a packed group (``train/state.py``
``make_multistep_train_step``), the native sampler, and the Trainer's
grouped loop (``train/loop.py``).

* The K-step eager form equals K sequential ``train_step`` calls bit for
  bit on the CPU (the same arithmetic in the same order), over a partial
  group and a group whose batches have different miss buckets.
* Three epochs of the port's Trainer in lockstep with ``pagraph_tpu``'s at
  its defaults (``backend="auto"``, ``steps_per_dispatch=8``,
  ``auto_caps=True``; dropout 0): the same batches (edges, vertices, miss
  rate and bytes shipped equal), losses and parameters within 1e-4 at f32
  compute (float32 reassociation over the Adam steps) and 3e-2 at bf16
  compute (bf16 rounds at other places in the two frameworks).
* The Trainer's graph branch, run on the CPU over the eager form: a key's
  first group is captured, the graphs are made after the access-frequency
  refill and read its rows, and a refill after them raises.
"""
import dataclasses
import subprocess
import time

import jax
import numpy as np
import pytest
import torch

import pagraph_tpu as pg
import pagraph_tpu_torch as pt
from pagraph_tpu.data.synthetic import synthetic_dataset as jsynthetic
from pagraph_tpu.sampling import native as jnative
from pagraph_tpu.train.loop import Trainer as JTrainer
from pagraph_tpu_torch.convert import params_from_jax
from pagraph_tpu_torch.data.synthetic import synthetic_dataset as tsynthetic
from pagraph_tpu_torch.sampling import pack
from pagraph_tpu_torch.train import loop
from pagraph_tpu_torch.train.loop import Trainer as TTrainer
from pagraph_tpu_torch.train.state import (GroupGraphs, create_state,
                                           make_multistep_train_step, train_step)

DATA = dict(num_nodes=1200, num_edges=9000, feat_dim=32, num_classes=6, seed=21,
            learnable=True)


@pytest.fixture(scope="module", autouse=True)
def jax_native_lib():
    """pagraph_tpu builds its library in place at first use, without a
    lock across processes, and its ``auto`` sampler falls back to numpy if
    the library does not load: wait until it loads."""
    for _ in range(60):
        try:
            return jnative.get_lib()
        except (OSError, subprocess.CalledProcessError):
            time.sleep(2)
    return jnative.get_lib()


@pytest.fixture(scope="module")
def datasets():
    return jsynthetic(**DATA), tsynthetic(**DATA)


def _cfgs(cache_dtype="float32", compute="float32", rank_by="out_degree", dropout=0.0,
          steps_per_dispatch=8):
    """The JAX package's defaults for the sampler and the dispatch, at a
    small width: 13 batches an epoch, so a group of 8 and one of 5."""
    kw = dict(
        model=dict(arch="graphsage", n_layers=1, hidden=16, feat_dim=32, n_classes=6,
                   aggregator="mean", dropout=dropout),
        sampler=dict(batch_size=64, fanout=3, num_hops=2, seed=7),
        cache=dict(capacity=DATA["num_nodes"] // 2, rank_by=rank_by, dtype=cache_dtype),
        train=dict(lr=1e-2, dtype=compute, steps_per_dispatch=steps_per_dispatch),
    )
    return tuple(mod.Config(model=mod.ModelConfig(**kw["model"]),
                            sampler=mod.SamplerConfig(**kw["sampler"]),
                            cache=mod.CacheConfig(**kw["cache"]),
                            train=mod.TrainConfig(**kw["train"]))
                 for mod in (pg, pt))


def _items_with_mixed_buckets(tr):
    """One epoch of the Trainer's packed host items; every third one's miss
    rows re-padded to twice its bucket (its plan reads the same rows)."""
    items = list(tr.loader.epoch())
    for j in range(0, len(items), 3):
        layout, i32, u8, miss = items[j]
        wide = torch.zeros((2 * max(layout.bucket, 256), miss.shape[1]), dtype=miss.dtype)
        wide[:miss.shape[0]] = miss
        items[j] = (dataclasses.replace(layout, bucket=wide.shape[0]), i32, u8, wide)
    return items


@pytest.mark.parametrize("k", [1, 3, 8])
def test_multistep_eager_equals_sequential_steps(datasets, k):
    """Groups of k (the last one partial; buckets mixed within a group):
    parameters, Adam's state, the dropout stream's position and the
    accumulated loss and accuracy equal those of one ``train_step`` a
    batch, bit for bit (dropout 0.5)."""
    _, tds = datasets
    cfg = _cfgs(dropout=0.5, steps_per_dispatch=k)[1]
    tr = TTrainer.from_dataset(cfg, tds, seed=3, device="cpu")
    tr._maybe_fill_cache()
    items = _items_with_mixed_buckets(tr)
    assert len(items) % k or k == 1
    cv, scale = tr.cache.cache_values, tr.cache.dequant_scale_dev
    s_group, s_seq = create_state(cfg, seed=3, device="cpu"), create_state(cfg, seed=3,
                                                                             device="cpu")
    acc_group = torch.zeros(2)
    steps = make_multistep_train_step(s_group, cv, scale)
    groups = [items[at:at + k] for at in range(0, len(items), k)]
    assert k == 1 or any(len({it[0].bucket for it in g}) > 1 for g in groups)
    for g in groups:
        steps(pack.stack(g), acc_group)
    acc_seq = torch.zeros(2)
    for layout, i32, u8, miss in items:
        mb, src_row, miss = pack.unpack(layout, i32, u8, miss)
        m = train_step(s_seq, mb, miss, src_row, cv, scale)
        acc_seq.add_(torch.stack([m["loss"], m["acc"]]))
    assert torch.equal(acc_group, acc_seq)
    assert s_group.step == s_seq.step == len(items)
    for (name, a), (_, b) in zip(s_group.model.named_parameters(),
                                 s_seq.model.named_parameters()):
        assert torch.equal(a, b), name
        sa, sb = s_group.optimizer.state[a], s_seq.optimizer.state[b]
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[key], sb[key]), (name, key)
    assert torch.equal(s_group.generator.get_state(), s_seq.generator.get_state())


@pytest.mark.parametrize("cache_dtype,compute,rank_by,tol", [
    ("float32", "float32", "out_degree", 1e-4),
    ("int8", "float32", "out_degree", 1e-4),
    ("float32", "float32", "access_freq", 1e-4),
    ("float32", "bfloat16", "out_degree", 3e-2),
    ("int8", "bfloat16", "access_freq", 3e-2)])
def test_trainer_lockstep_with_jax_defaults(datasets, cache_dtype, compute, rank_by, tol):
    """Three epochs from the same parameters: both samplers native, equal
    calibrated caps, equal batches (13 an epoch: groups of 8 and 5), edges,
    vertices, miss rates and bytes shipped; losses, accuracies and
    parameters within ``tol``; the cache map after the access-frequency
    refill equal."""
    jds, tds = datasets
    jcfg, tcfg = _cfgs(cache_dtype, compute, rank_by)
    jtr = JTrainer.from_dataset(jcfg, jds, seed=0)
    ttr = TTrainer.from_dataset(tcfg, tds, seed=0, device="cpu")
    assert jtr.sampler._native is not None and ttr.sampler.backend_name == "native"
    assert ttr.sampler.caps == jtr.sampler.caps
    assert ttr.steps_per_dispatch == 8 and not ttr.host_graphs
    ttr.state.model.load_state_dict(params_from_jax(jax.device_get(jtr.state.params)))
    jtr.train(3)
    ttr.train(3)
    for jm, tm in zip(jtr.epoch_metrics, ttr.epoch_metrics, strict=True):
        assert tm.num_batches == jm.num_batches == 13
        assert (tm.edges, tm.vertices) == (jm.edges, jm.vertices)
        assert (tm.miss_rate, tm.h2d_bytes) == (jm.miss_rate, jm.h2d_bytes)
        assert abs(tm.mean_loss - jm.mean_loss) < tol, (tm.mean_loss, jm.mean_loss)
        assert abs(tm.mean_acc - jm.mean_acc) < max(tol, 1e-3)
    losses = [m.mean_loss for m in ttr.epoch_metrics]
    assert losses[2] < losses[1] < losses[0], losses
    want = params_from_jax(jax.device_get(jtr.state.params))
    for name, p in ttr.state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0,
                                   atol=tol, err_msg=name)
    assert ttr.state.step == 39
    np.testing.assert_array_equal(ttr.cache.cache_map, jtr.cache.cache_map)


class EagerGraphs:
    """Stands in for :class:`GroupGraphs` on the CPU: the Trainer's graph
    branch (a key captured at its first group, then one call a group) over
    the eager form, with the cache rows it was made with."""

    made = []

    def __init__(self, state, cache_values, dequant_scale):
        self.cache_values = cache_values
        self._steps = make_multistep_train_step(state, cache_values, dequant_scale)
        self.captured, self.calls = [], 0
        EagerGraphs.made.append(self)

    def needs_capture(self, group):
        return GroupGraphs.key(group) not in self.captured

    def capture(self, group, acc):
        self.captured.append(GroupGraphs.key(group))

    def __call__(self, group, acc):
        self._steps(group, acc)
        self.calls += 1


def test_graph_branch_after_the_access_freq_refill(datasets, monkeypatch):
    """``host_graphs`` on the CPU with :class:`EagerGraphs` for the graphs:
    epoch 0 eager, then the graph branch; the run equals the eager form's
    bit for bit; the graphs were made once, after the refill, with the
    refilled rows, and captured the keys (8, layout) and (5, layout) once
    each; a refill after they exist raises at the next epoch."""
    _, tds = datasets
    real = loop.make_multistep_train_step

    def make(state, cv, scale, *, graph=False, stream=None):
        return EagerGraphs(state, cv, scale) if graph else real(state, cv, scale)
    monkeypatch.setattr(loop, "make_multistep_train_step", make)
    EagerGraphs.made.clear()
    cfg = _cfgs(rank_by="access_freq", dropout=0.3)[1]
    runs = []
    for graphs in (True, False):
        tr = TTrainer.from_dataset(cfg, tds, seed=1, device="cpu")
        tr.host_graphs = graphs
        tr._maybe_fill_cache()
        before = tr.cache.cache_values
        tr.train(3)
        runs.append(tr)
        if graphs:
            (g,) = EagerGraphs.made
            assert tr.group_graphs is g and g.cache_values is tr.cache.cache_values
            assert g.cache_values is not before
            assert [k for k, _ in g.captured] == [8, 5] and g.calls == 4
            assert tr.timers.count["capture"] == 2
    a, b = runs
    assert [m.mean_loss for m in a.epoch_metrics] == [m.mean_loss for m in b.epoch_metrics]
    for pa, pb in zip(a.state.model.parameters(), b.state.model.parameters()):
        assert torch.equal(pa, pb)
    a.run_epoch(0)                  # refills the cache under the graphs
    with pytest.raises(RuntimeError, match="refilled"):
        a.run_epoch(4)
