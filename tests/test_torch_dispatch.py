"""The on-device epoch's dispatch functions and the cosine learning-rate
schedule, against ``pagraph_tpu``'s, on CPU tensors.

The CPU runs each function's eager form (the card replays the same code
as CUDA graphs, held against this form by ``chip_smoke.py``).  As in
``tests/test_torch_device_epoch.py``: the same numpy data, the JAX initial
parameters, dropout 0, and JAX's random integers injected; losses within
1e-4 and parameters within 1e-4 after two epochs (float32 reassociation in
forward, backward and Adam).  The schedule's learning rate equals optax's
within 1e-7.
"""
import jax
import numpy as np
import optax
import pytest
import torch
from test_torch_device_epoch import (DATA, _assert_params_close, _cfgs,
                                     _jax_epoch_randomness)
from test_torch_trainer import _cfgs as _host_cfgs

from pagraph_tpu.data.synthetic import synthetic_dataset as jsynthetic
from pagraph_tpu.train.device_epoch import (make_device_pipelined_fns,
                                            make_device_step_fns)
from pagraph_tpu.train.loop import Trainer as JTrainer
from pagraph_tpu_torch.convert import params_from_jax
from pagraph_tpu_torch.data.synthetic import synthetic_dataset as tsynthetic
from pagraph_tpu_torch.train import device_epoch as tde
from pagraph_tpu_torch.train.loop import Trainer as TTrainer
from pagraph_tpu_torch.train.state import COSINE_ALPHA, cosine_decay, make_lr_schedule

LR = 1e-2
JAX_DISPATCH_FNS = {"steps": make_device_step_fns, "pipelined": make_device_pipelined_fns}


@pytest.fixture(scope="module")
def datasets():
    return jsynthetic(**DATA), tsynthetic(**DATA)


def _with_cosine(cfgs, decay_steps):
    for c in cfgs:
        c.train.lr_schedule, c.train.lr_decay_steps = "cosine", decay_steps
    return cfgs


def _lockstep(jcfg, tcfg, jds, tds, seed=3, epochs=2):
    """Train both device-path Trainers ``epochs`` epochs from the JAX
    initial parameters and randomness; compare each epoch and the final
    parameters.  Returns the port's Trainer."""
    jtr = JTrainer.from_dataset(jcfg, jds, seed=seed)
    ttr = TTrainer.from_dataset(tcfg, tds, seed=seed, device="cpu")
    ttr.state.model.load_state_dict(params_from_jax(jax.device_get(jtr.state.params)))
    n_train = len(tds.train_nids)
    ttr.epoch_randomness = lambda e, out=None: _jax_epoch_randomness(seed, e, n_train, tcfg)
    jtr.train(epochs)
    ttr.train(epochs)
    for jm, tm in zip(jtr.epoch_metrics, ttr.epoch_metrics, strict=True):
        assert tm.num_batches == jm.num_batches == -(-n_train // tcfg.sampler.batch_size)
        assert tm.edges == jm.edges and tm.vertices == jm.vertices
        assert abs(tm.mean_loss - jm.mean_loss) < 1e-4, (tm.mean_loss, jm.mean_loss)
        assert abs(tm.mean_acc - jm.mean_acc) < 1e-3
    _assert_params_close(ttr, jtr.state.params, 1e-4)
    assert ttr.state.step == int(ttr.state.step_t) == sum(m.num_batches
                                                          for m in ttr.epoch_metrics)
    return ttr


@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize("dispatch", ["steps", "pipelined"])
def test_dispatch_fns_lockstep_with_jax(datasets, dispatch, paired):
    """The port's ``make_device_step_fns`` / ``make_device_pipelined_fns``
    (through the Trainer, eager on the CPU) against the JAX functions of
    the same name (through JAX's Trainer), two epochs with a tail batch."""
    jds, tds = datasets
    jcfg, tcfg = _cfgs(paired=paired, batch=128, dispatch=dispatch)
    ttr = _lockstep(jcfg, tcfg, jds, tds)
    runner = ttr.epoch_runner
    assert runner.mode == dispatch and not runner.graph and not runner.graphs
    assert tde.DISPATCH_FNS[dispatch].__name__ == JAX_DISPATCH_FNS[dispatch].__name__


@pytest.mark.parametrize("decay_steps", [1, 7])
def test_cosine_schedule_matches_optax(decay_steps):
    """The learning rate at ``t = 0 .. T + 3`` updates applied, computed on
    the device from an int64 count, against optax's schedule (alpha 0.05,
    the JAX package's); ``make_lr_schedule`` is that function."""
    want = optax.cosine_decay_schedule(LR, decay_steps, alpha=COSINE_ALPHA)
    cfg = _with_cosine(_cfgs(), decay_steps)[1]
    sched = make_lr_schedule(cfg)
    for t in range(decay_steps + 4):
        count = torch.tensor(t, dtype=torch.int64)
        got = cosine_decay(count, LR, decay_steps)
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(got.item(), float(want(t)), rtol=0, atol=1e-7)
        assert torch.equal(sched(count), got)
    assert make_lr_schedule(_cfgs()[1]) is None


def test_host_path_cosine_lockstep_with_jax():
    """The host Trainer at ``lr_schedule="cosine"``, ``lr_decay_steps=3``
    (the schedule ends inside epoch 0) against JAX's, two epochs, as
    ``test_trainer_lockstep_with_jax``; the last update used ``alpha * lr``."""
    data_kw = dict(num_nodes=1200, num_edges=9000, feat_dim=32, num_classes=6, seed=21,
                   learnable=True)
    jds, tds = jsynthetic(**data_kw), tsynthetic(**data_kw)
    jcfg, tcfg = _with_cosine(_host_cfgs(jds.num_nodes, "out_degree", "float32"), 3)
    jtr = JTrainer.from_dataset(jcfg, jds, seed=0)
    ttr = TTrainer.from_dataset(tcfg, tds, seed=0, device="cpu")
    ttr.state.model.load_state_dict(params_from_jax(jax.device_get(jtr.state.params)))
    jtr.train(2)
    ttr.train(2)
    for jm, tm in zip(jtr.epoch_metrics, ttr.epoch_metrics, strict=True):
        assert tm.edges == jm.edges and tm.miss_rate == jm.miss_rate
        assert abs(tm.mean_loss - jm.mean_loss) < 1e-4, (tm.mean_loss, jm.mean_loss)
    _assert_params_close(ttr, jtr.state.params, 1e-4)
    assert ttr.state.step == int(ttr.state.step_t) > 3
    lr_t = ttr.state.optimizer.param_groups[0]["lr"]
    assert lr_t.item() == pytest.approx(LR * COSINE_ALPHA, rel=1e-6)


@pytest.mark.parametrize("dispatch", ["scan", "steps"])
def test_device_path_cosine_lockstep_with_jax(datasets, dispatch):
    """The on-device Trainer at ``lr_schedule="cosine"``,
    ``lr_decay_steps=3`` against JAX's, two epochs, injected randomness."""
    jds, tds = datasets
    jcfg, tcfg = _with_cosine(_cfgs(batch=128, dispatch=dispatch), 3)
    ttr = _lockstep(jcfg, tcfg, jds, tds)
    assert ttr.state.optimizer.param_groups[0]["lr"].item() == pytest.approx(
        LR * COSINE_ALPHA, rel=1e-6)


@pytest.mark.parametrize("dispatch", ["scan", "pipelined"])
def test_epoch_buffers_are_static_and_hold_the_epochs_draws(datasets, dispatch):
    """Across epochs every buffer of ``EpochInputs`` keeps its storage, and
    after epoch e they hold what ``epoch_randomness(e)`` draws afresh, the
    schedule of that permutation and the epoch's metrics."""
    _, tds = datasets
    cfg = _cfgs(paired=True, batch=64, dispatch=dispatch)[1]
    tr = TTrainer.from_dataset(cfg, tds, seed=5, device="cpu")
    bufs = tr.epoch_inputs
    tensors = (bufs.perm, *bufs.draws, bufs.seeds_all, bufs.mask_all, bufs.acc.sums,
               bufs.acc.counts, bufs.counter)
    ptrs = [t.data_ptr() for t in tensors]
    for epoch in range(2):
        m = tr.run_epoch(epoch)
        assert [t.data_ptr() for t in tensors] == ptrs
        perm, draws = TTrainer.from_dataset(cfg, tds, seed=5,
                                            device="cpu").epoch_randomness(epoch)
        assert perm.data_ptr() != bufs.perm.data_ptr()
        assert torch.equal(bufs.perm, perm)
        assert all(torch.equal(a, b) for a, b in zip(bufs.draws, draws, strict=True))
        seeds, mask = tde.epoch_schedule(perm, tr._dev_train_nids, 64)
        assert torch.equal(bufs.seeds_all, seeds) and torch.equal(bufs.mask_all, mask)
        vals = bufs.acc.values()
        assert vals["steps"] == m.num_batches and vals["edges"] == m.edges
    assert int(bufs.counter) == (m.num_batches if dispatch == "pipelined" else 0)
