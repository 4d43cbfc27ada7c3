"""Checkpoints, resume and evaluation during training in the port, against
``pagraph_tpu`` where it has a counterpart.

* ``save_checkpoint`` / ``restore_checkpoint`` round trip: every tensor of
  the train state (parameters, Adam's moments and steps, the lr tensor,
  ``step_t``) and the dropout generator's state come back equal, copied
  into the state's own tensors (their addresses unchanged); a state
  without Adam's tensors refuses ``in_place_only``.
* ``list_checkpoints`` parses the ``<arch>_<epoch>`` names as the JAX
  package's does.
* ``Trainer.resume`` into a fresh Trainer, then the remaining epochs,
  equals the uninterrupted run bit for bit on the CPU, on the host path (at
  the JAX defaults, pool, dropout 0.5, the sampler's random state
  restored) and on the on-device path in each dispatch mode; ``epoch_dispatch="steps"``
  refuses a checkpoint off an epoch boundary.
* ``train.eval_every``: the port's Trainer in lockstep with JAX's sets the
  same ``val_acc`` each epoch, on both paths.
* ``evaluate_checkpoints`` over the port's checkpoints of the JAX
  package's parameters equals the JAX package's over its own.
"""
import jax
import pytest
import torch

import pagraph_tpu as pg
import pagraph_tpu_torch as pt
from pagraph_tpu.data.synthetic import synthetic_dataset as jsynthetic
from pagraph_tpu.train import checkpoint as jck
from pagraph_tpu.train.loop import Trainer as JTrainer
from pagraph_tpu_torch.convert import params_from_jax
from pagraph_tpu_torch.data.synthetic import synthetic_dataset as tsynthetic
from pagraph_tpu_torch.train import checkpoint as tck
from pagraph_tpu_torch.train.loop import Trainer as TTrainer
from pagraph_tpu_torch.train.state import create_state
from tests.test_torch_aggregators import run_lockstep

DATA = dict(num_nodes=600, num_edges=4800, feat_dim=16, num_classes=5, seed=21,
            learnable=True)


@pytest.fixture(scope="module")
def datasets():
    return jsynthetic(**DATA), tsynthetic(**DATA)


def _cfgs(device=False, dispatch="scan", dropout=0.0, agg="mean", **train):
    kw = dict(
        model=dict(arch="graphsage", n_layers=1, hidden=8, feat_dim=16, n_classes=5,
                   aggregator=agg, dropout=dropout),
        sampler=dict(batch_size=64, fanout=3, num_hops=2, seed=7),
        cache=dict(capacity=None if device else 300),
        train=dict(lr=1e-2, on_device_sampling=device, epoch_dispatch=dispatch, **train))
    return tuple(mod.Config(model=mod.ModelConfig(**kw["model"]),
                            sampler=mod.SamplerConfig(**kw["sampler"]),
                            cache=mod.CacheConfig(**kw["cache"]),
                            train=mod.TrainConfig(**kw["train"]))
                 for mod in (pg, pt))


def _state_tensors(state):
    opt = state.optimizer
    out = {f"p.{n}": p for n, p in state.model.named_parameters()}
    for n, p in state.model.named_parameters():
        for k, v in opt.state[p].items():
            out[f"opt.{n}.{k}"] = v
    out["lr"], out["step_t"] = opt.param_groups[0]["lr"], state.step_t
    return out


def test_save_restore_round_trip(datasets, tmp_path):
    _, tds = datasets
    tcfg = _cfgs(dropout=0.5)[1]
    tr = TTrainer.from_dataset(tcfg, tds, seed=1, device="cpu")
    tr.train(1)
    path = tck.save_checkpoint(str(tmp_path), "graphsage", 4, tr.state)
    assert path.endswith("graphsage_4")
    saved = {k: v.detach().clone() for k, v in _state_tensors(tr.state).items()}
    gen, step = tr.state.generator.get_state(), tr.state.step
    tr.train(2, start_epoch=1)                          # move every tensor on
    ptrs = {k: v.data_ptr() for k, v in _state_tensors(tr.state).items()}
    tck.restore_checkpoint(str(tmp_path), "graphsage", 4, tr.state, in_place_only=True)
    for k, v in _state_tensors(tr.state).items():
        assert torch.equal(v, saved[k]), k
        assert v.data_ptr() == ptrs[k], k
    assert torch.equal(tr.state.generator.get_state(), gen) and tr.state.step == step
    fresh = create_state(tcfg, seed=1, device="cpu")
    with pytest.raises(RuntimeError, match="in place"):
        tck.restore_checkpoint(str(tmp_path), "graphsage", 4, fresh, in_place_only=True)
    tck.restore_checkpoint(str(tmp_path), "graphsage", 4, fresh)
    for k, v in _state_tensors(fresh).items():
        assert torch.equal(v, saved[k]), k


def test_list_checkpoints_matches_jax(tmp_path):
    for name in ("graphsage_3", "graphsage_10", "graphsage_1", "gcn_2", "graphsage_x",
                 "graphsage_2.aux", "graphsage_5.123.tmp"):
        (tmp_path / name).write_bytes(b"")
    for arch in ("graphsage", "gcn", "gat"):
        assert tck.list_checkpoints(str(tmp_path), arch) == jck.list_checkpoints(
            str(tmp_path), arch)
    assert tck.list_checkpoints(str(tmp_path), "graphsage") == [1, 3, 10]
    assert tck.list_checkpoints(str(tmp_path / "missing"), "graphsage") == []


def _snapshot(tr):
    return ({k: v.detach().clone() for k, v in _state_tensors(tr.state).items()},
            tr.state.generator.get_state(), [m.mean_loss for m in tr.epoch_metrics])


@pytest.mark.parametrize("device,dispatch,agg", [(False, "scan", "pool"),
                                                 (True, "scan", "lstm"),
                                                 (True, "steps", "mean"),
                                                 (True, "pipelined", "pool")])
def test_resume_equals_uninterrupted(datasets, tmp_path, device, dispatch, agg):
    """Two epochs with a checkpoint after each, against a fresh Trainer
    resumed from epoch 0's and run for epoch 1: equal bit for bit."""
    _, tds = datasets
    tcfg = _cfgs(device, dispatch, dropout=0.5, agg=agg, ckpt_dir=str(tmp_path),
                 ckpt_every=1)[1]
    a = TTrainer.from_dataset(tcfg, tds, seed=2, device="cpu")
    a.train(2)
    assert tck.list_checkpoints(str(tmp_path), "graphsage") == [0, 1]
    b = TTrainer.from_dataset(tcfg, tds, seed=2, device="cpu")
    assert b.resume(epoch=0) == 1
    b.train(2, start_epoch=1)
    (ta, ga, la), (tb, gb, lb) = _snapshot(a), _snapshot(b)
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k
    assert torch.equal(ga, gb) and la[1:] == lb
    assert b.resume() == 2                        # the newest checkpoint
    if dispatch == "steps":
        a.state.step_t.add_(1)
        a.state.step += 1
        tck.save_checkpoint(str(tmp_path), "graphsage", 7, a.state)
        with pytest.raises(ValueError, match="epoch-aligned"):
            b.resume(epoch=7)


@pytest.mark.parametrize("device", [False, True])
def test_eval_every_matches_jax(datasets, device):
    jds, tds = datasets
    jcfg, tcfg = _cfgs(device, eval_every=1, eval_backend="host")
    jtr = JTrainer.from_dataset(jcfg, jds, seed=0)
    ttr = TTrainer.from_dataset(tcfg, tds, seed=0, device="cpu")
    run_lockstep(jtr, ttr, 2, 1e-4)
    got = [m.val_acc for m in ttr.epoch_metrics]
    assert got == [m.val_acc for m in jtr.epoch_metrics] and None not in got
    assert ttr.summary()["val_acc"] == jtr.summary()["val_acc"] == got[-1]
    with pytest.raises(ValueError, match="eval_data"):
        TTrainer(tcfg, ttr.store, tds.graph, tds.train_nids, tds.labels, device="cpu")


def test_evaluate_checkpoints_matches_jax(datasets, tmp_path):
    jds, tds = datasets
    jcfg, tcfg = _cfgs(agg="pool", ckpt_dir=str(tmp_path / "jax"), ckpt_every=1)
    jtr = JTrainer.from_dataset(jcfg, jds, seed=0)
    jtr.train(2)
    state = create_state(tcfg, seed=0, device="cpu")
    for e in jck.list_checkpoints(str(tmp_path / "jax"), "graphsage"):
        js = jck.restore_checkpoint(str(tmp_path / "jax"), "graphsage", e,
                                    jax.device_get(jtr.state))
        state.model.load_state_dict(params_from_jax(jax.device_get(js.params)))
        tck.save_checkpoint(str(tmp_path / "port"), "graphsage", e, state)
    want = jck.evaluate_checkpoints(jcfg, str(tmp_path / "jax"), jds.graph, jds.features,
                                    jds.labels, jds.test_mask, backend="host")
    got = tck.evaluate_checkpoints(tcfg, str(tmp_path / "port"), tds.graph, tds.features,
                                   tds.labels, tds.test_mask, backend="host", device="cpu")
    assert got == want and sorted(got) == [0, 1]
