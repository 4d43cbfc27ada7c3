"""The port's GraphSAGE, objective and parameter conversion against
``pagraph_tpu``: the same parameters (converted from the JAX pytree) and the
same MiniBatch must give the same logits, loss and gradients.

Dropout is 0: torch and ``jax.random`` streams never match.  Tolerances
rtol 1e-5 / atol 1e-6: float32 matmuls and sums reassociated between XLA
and PyTorch's CPU kernels.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pagraph_tpu as pg
import pagraph_tpu_torch as pt
from pagraph_tpu.models import sage as jsage
from pagraph_tpu.sampling.sampler import NeighborSampler as JSampler
from pagraph_tpu.train.objective import masked_accuracy, masked_cross_entropy
from pagraph_tpu_torch.convert import params_from_jax, params_to_jax
from pagraph_tpu_torch.models import get_model
from pagraph_tpu_torch.models.common import dropout
from pagraph_tpu_torch.sampling.block import Block as TBlock
from pagraph_tpu_torch.sampling.block import MiniBatch as TMiniBatch
from pagraph_tpu_torch.train import objective as tobj

RTOL, ATOL = 1e-5, 1e-6


def _port_mb(mb) -> TMiniBatch:
    a = np.asarray
    return TMiniBatch(
        layer_nids=tuple(a(x) for x in mb.layer_nids),
        layer_mask=tuple(a(x) for x in mb.layer_mask),
        blocks=tuple(TBlock(a(b.neigh_pos), a(b.neigh_mask), a(b.self_pos))
                     for b in mb.blocks),
        labels=a(mb.labels),
    ).to("cpu")


def _configs(agg, n_layers):
    kw = dict(arch="graphsage", n_layers=n_layers, hidden=8, feat_dim=32,
              n_classes=10, aggregator=agg, dropout=0.0)
    return pg.ModelConfig(**kw), pt.ModelConfig(**kw)


@pytest.fixture(scope="module", params=[1, 2], ids=["hops2", "hops3"])
def batch(request, small_ds):
    n_layers = request.param
    cfg = pg.SamplerConfig(batch_size=64, fanout=3, num_hops=n_layers + 1, seed=2)
    s = JSampler(small_ds.graph, small_ds.train_nids, cfg, labels=small_ds.labels,
                 backend="numpy")
    mb = jax.tree.map(np.asarray, s.sample(small_ds.train_nids[5:69]))
    # zero-mean inputs keep logits O(1), where float32 reassociation stays
    # inside atol (the dataset's [0, 1) features give |logits| ~ 20 under
    # the sum aggregator, whose ulp alone is 2e-6; three hops of sums grow
    # them 3x per hop, hence the small scale)
    feats = np.random.default_rng(n_layers).normal(
        scale=0.05, size=(mb.input_nids.shape[0], 32)).astype(np.float32)
    return n_layers, mb, feats


def test_params_round_trip():
    jcfg, tcfg = _configs("mean", 2)
    jp = jax.device_get(jsage.init_params(jax.random.PRNGKey(0), jcfg))
    sd = params_from_jax(jp)
    model = get_model(tcfg)
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert v.shape == sd[k].shape, k
    model.load_state_dict(sd)
    back = params_to_jax(model.state_dict())
    flat_j, tree_j = jax.tree.flatten(jp)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_j == tree_b
    for x, y in zip(flat_j, flat_b):
        np.testing.assert_array_equal(np.asarray(x), y)


def test_init_shapes_and_bounds_match():
    """The port draws its own init (torch RNG) with the JAX package's shapes
    and Xavier bounds."""
    jcfg, tcfg = _configs("gcn", 1)
    jp = jsage.init_params(jax.random.PRNGKey(0), jcfg)
    model = get_model(tcfg, generator=torch.Generator().manual_seed(0))
    for i, upd in enumerate(jp["updates"]):
        for lin in ("self", "neigh"):
            w = getattr(model.updates[i][lin], "w").detach().numpy()
            assert w.shape == upd[lin]["w"].shape
            bound = np.sqrt(2.0) * np.sqrt(6.0 / sum(w.shape))
            assert np.abs(w).max() <= bound


@pytest.mark.parametrize("agg", ["mean", "gcn"])
def test_forward_and_grads_match_jax(batch, agg):
    n_layers, mb, feats = batch
    jcfg, tcfg = _configs(agg, n_layers)
    jp = jsage.init_params(jax.random.PRNGKey(7), jcfg)

    def loss_fn(params):
        logits = jsage.apply(params, jcfg, mb, jnp.asarray(feats), train=True)
        return masked_cross_entropy(logits, mb.labels, mb.seed_mask), logits

    (jloss, jlogits), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(jp)
    model = get_model(tcfg)
    model.load_state_dict(params_from_jax(jax.device_get(jp)))
    tmb = _port_mb(mb)
    logits = model(tmb, torch.from_numpy(feats))
    loss = tobj.masked_cross_entropy(logits, tmb.labels, tmb.seed_mask)
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL, atol=ATOL)
    acc = tobj.masked_accuracy(logits, tmb.labels, tmb.seed_mask)
    assert acc.item() == pytest.approx(float(masked_accuracy(jlogits, mb.labels, mb.seed_mask)))
    jg = params_from_jax(jax.device_get(jgrads))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jg[name].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_dropout_keeps_rate_and_scale():
    g = torch.Generator().manual_seed(0)
    x = torch.ones(200_000)
    y = dropout(x, 0.2, g, train=True)
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.8) < 0.01          # ~13 sigma of a binomial at n=2e5
    assert torch.allclose(y[y != 0], torch.full_like(y[y != 0], 1.25))
    assert dropout(x, 0.2, None, train=True) is x
    assert dropout(x, 0.2, g, train=False) is x


@pytest.mark.parametrize("agg,kw", [("pool", {}), ("lstm", {}), ("mean", {"preprocess": True})])
def test_unported_variants_raise(agg, kw):
    """Every GraphSAGE variant is ported (tests/test_torch_aggregators.py,
    test_torch_preprocess.py), and so are GCN, GIN and GAT
    (tests/test_torch_gcn.py, test_torch_gin.py, test_torch_gat.py) and
    CV-GCN (tests/test_torch_cv_gcn.py): the same settings build them."""
    get_model(pt.ModelConfig(arch="graphsage", aggregator=agg, **kw))
    arch = {"pool": "gin", "lstm": "gat", "mean": "gcn"}[agg]
    assert type(get_model(pt.ModelConfig(arch=arch, aggregator=agg, **kw))).__name__ == \
        arch.upper()
    assert type(get_model(pt.ModelConfig(arch="gcn_cv", aggregator=agg,
                                         preprocess=True))).__name__ == "GCNCV"
