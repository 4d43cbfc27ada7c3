"""The port's structure-blind MLP probe against
``pagraph_tpu.models.mlp_probe.mlp_val_acc``: the JAX initial weights
(``jax.random.normal`` from the probe's own keys) handed to the port's
``init=``, the same numpy subsample of the train and validation vertices,
full-batch AdamW on both sides.  The best validation accuracy over the
trajectory agrees within one validation vertex (1/len(val)): float32
reassociation may move one argmax.  Without a card and without
``device="cpu"`` the port raises, as every entry point does."""
import jax
import numpy as np
import pytest
import torch

from pagraph_tpu.data.synthetic import synthetic_dataset
from pagraph_tpu.models.mlp_probe import mlp_val_acc as jmlp
from pagraph_tpu_torch.models.mlp_probe import mlp_val_acc as tmlp


def jax_init(seed, d, hidden, c):
    """The weights the JAX probe draws for ``seed``."""
    k0, k1 = jax.random.split(jax.random.PRNGKey(seed))
    return {"w0": np.asarray(jax.random.normal(k0, (d, hidden)) * (1.0 / np.sqrt(d))),
            "b0": np.zeros(hidden, np.float32),
            "w1": np.asarray(jax.random.normal(k1, (hidden, c)) * (1.0 / np.sqrt(hidden))),
            "b1": np.zeros(c, np.float32)}


@pytest.fixture(scope="module")
def ds():
    return synthetic_dataset(num_nodes=1000, num_edges=6000, feat_dim=24, num_classes=6,
                             seed=4, learnable=True)


@pytest.mark.parametrize("weight_decay,max_train,seed", [(0.0, None, 0), (1e-2, None, 1),
                                                         (0.0, 300, 2)])
def test_mlp_val_acc_matches_jax(ds, weight_decay, max_train, seed):
    kw = dict(hidden=32, steps=80, lr=1e-2, seed=seed, weight_decay=weight_decay,
              max_train=max_train)
    want = jmlp(ds.features, ds.labels, ds.train_mask, ds.val_mask, **kw)
    init = jax_init(seed, ds.features.shape[1], 32, int(ds.labels.max()) + 1)
    got = tmlp(ds.features, ds.labels, ds.train_mask, ds.val_mask, init=init, device="cpu",
               **kw)
    n_val = min(int(ds.val_mask.sum()), max_train or ds.num_nodes)
    assert abs(got - want) <= 1.0 / n_val + 1e-9, (got, want)
    assert want > 1.5 / 6                       # it learned: above chance
    # its own init: a probe of the same task learns as well, to within noise
    own = tmlp(ds.features, ds.labels, ds.train_mask, ds.val_mask, device="cpu", **kw)
    assert abs(own - want) < 0.1


def test_mlp_val_acc_needs_a_card_unless_cpu_is_asked(ds, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmlp(ds.features, ds.labels, ds.train_mask, ds.val_mask, steps=2)
