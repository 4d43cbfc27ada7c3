"""Lockstep training: the port's Trainer against ``pagraph_tpu``'s.

Set up as ``tests/test_torch_parity.py`` sets up its convergence anchor:
numpy sampler backend and ``auto_caps=False``, so both trainers see the
identical batch stream; dropout 0; and the same initial parameters (the JAX
trainer's, converted with ``params_from_jax``).  Two epochs at 50% cache
capacity.  Miss rate and edges are counted from identical batches, so they
must be equal; losses and parameters may drift apart only by float32
reassociation accumulated over the Adam steps (1e-4).
"""
import jax
import numpy as np
import pytest

import pagraph_tpu as pg
import pagraph_tpu_torch as pt
from pagraph_tpu.data.synthetic import synthetic_dataset as jsynthetic
from pagraph_tpu.train.loop import Trainer as JTrainer
from pagraph_tpu_torch.convert import params_from_jax
from pagraph_tpu_torch.data.synthetic import synthetic_dataset as tsynthetic
from pagraph_tpu_torch.train.loop import Trainer as TTrainer

EPOCHS = 2


def _cfgs(num_nodes, rank_by):
    kw = dict(
        model=dict(arch="graphsage", n_layers=1, hidden=16, feat_dim=32,
                   n_classes=6, aggregator="mean", dropout=0.0),
        sampler=dict(batch_size=128, fanout=3, num_hops=2, seed=7,
                     auto_caps=False, backend="numpy"),
        cache=dict(capacity=num_nodes // 2, rank_by=rank_by),
        train=dict(lr=1e-2, steps_per_dispatch=1),
    )
    return tuple(
        mod.Config(model=mod.ModelConfig(**kw["model"]),
                   sampler=mod.SamplerConfig(**kw["sampler"]),
                   cache=mod.CacheConfig(**kw["cache"]),
                   train=mod.TrainConfig(**kw["train"]))
        for mod in (pg, pt))


@pytest.mark.parametrize("rank_by", ["out_degree", "access_freq"])
def test_trainer_lockstep_with_jax(rank_by):
    """access_freq refills the cache from epoch 0's counts before epoch 1."""
    data_kw = dict(num_nodes=1200, num_edges=9000, feat_dim=32, num_classes=6,
                   seed=21, learnable=True)
    jds, tds = jsynthetic(**data_kw), tsynthetic(**data_kw)
    jcfg, tcfg = _cfgs(jds.num_nodes, rank_by)

    jtr = JTrainer.from_dataset(jcfg, jds, seed=0)
    init = jax.device_get(jtr.state.params)
    ttr = TTrainer.from_dataset(tcfg, tds, seed=0, device="cpu")
    ttr.state.model.load_state_dict(params_from_jax(init))
    jtr.train(EPOCHS)
    ttr.train(EPOCHS)

    for jm, tm in zip(jtr.epoch_metrics, ttr.epoch_metrics):
        assert tm.num_batches == jm.num_batches
        assert tm.edges == jm.edges and tm.vertices == jm.vertices
        assert tm.miss_rate == jm.miss_rate
        assert abs(tm.mean_loss - jm.mean_loss) < 1e-4, (tm.mean_loss, jm.mean_loss)
        assert abs(tm.mean_acc - jm.mean_acc) < 1e-3
    assert ttr.epoch_metrics[-1].mean_loss < ttr.epoch_metrics[0].mean_loss
    want = params_from_jax(jax.device_get(jtr.state.params))
    for name, p in ttr.state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-4, err_msg=name)
    assert ttr.state.step == sum(m.num_batches for m in ttr.epoch_metrics)
    np.testing.assert_array_equal(ttr.cache.cache_map, jtr.cache.cache_map)
    s = ttr.summary()
    assert s["epochs"] == EPOCHS and s["miss_rate"] == jtr.summary()["miss_rate"]
