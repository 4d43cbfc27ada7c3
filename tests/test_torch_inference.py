"""Full-graph inference and evaluation of the port's GraphSAGE against
``pagraph_tpu.models.inference``.

* ``_BucketedNeighborhoods.aggregate`` (the device backend's window
  reductions, ``gather_kernels.gather_reduce``'s plain version here) against
  the JAX package's, sum and max, on a graph with zero-degree vertices and
  ``f_cap`` small enough that hubs split into windows and their partials
  take a second level of several widths: sum within 1e-5 (another
  summation order), max exact.
* ``full_graph_logits`` on both backends against the JAX package's, for the
  mean, gcn, pool and lstm aggregators, preprocess on and off, the skip on
  and off, on a graph with zero-degree vertices and a hub above the default
  ``f_cap`` (4096): within 1e-4 of each vertex's largest logit (under the
  gcn aggregator the hub's sums of 4200 rows reach 1e4, and its logits
  differences of such sums).  ``evaluate``: equal accuracy.
"""
import jax
import numpy as np
import pytest
import scipy.sparse as spsp
import torch

import pagraph_tpu as pg
import pagraph_tpu_torch as pt
from pagraph_tpu.graph import CSRGraph as JGraph
from pagraph_tpu.models import inference as jinf
from pagraph_tpu.models import sage as jsage
from pagraph_tpu_torch.convert import params_from_jax
from pagraph_tpu_torch.graph import CSRGraph as TGraph
from pagraph_tpu_torch.models import get_model
from pagraph_tpu_torch.models import inference as tinf
from pagraph_tpu_torch.ops import gather_kernels as gk


def _tgraph(g) -> TGraph:
    return TGraph(g.indptr, g.indices, g.out_degrees)


def _graph(n, e, hub_deg, seed):
    """Random edges, vertex 0 an in-hub of ``hub_deg`` distinct sources,
    and the highest ids without in-edges."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(1, n - n // 10, e)
    src = np.concatenate([src, rng.choice(np.arange(1, n), hub_deg, replace=False)])
    dst = np.concatenate([dst, np.zeros(hub_deg, np.int64)])
    keep = src != dst
    g = JGraph.from_coo(spsp.coo_matrix((np.ones(keep.sum(), np.float32),
                                         (dst[keep], src[keep])), shape=(n, n)))
    assert (g.in_degrees == 0).any() and g.in_degrees[0] == hub_deg
    return g


@pytest.mark.parametrize("kind", ["sum", "max"])
def test_bucketed_aggregate_matches_jax(kind):
    g = _graph(300, 900, 40, seed=1)
    h = np.random.default_rng(2).normal(size=(300, 6)).astype(np.float32)
    want = np.asarray(jinf._BucketedNeighborhoods(g, f_min=2, f_cap=4).aggregate(h, kind))
    bn = tinf._BucketedNeighborhoods(_tgraph(g), "cpu", f_min=2, f_cap=4)
    levels = [lv for lv, _, _ in bn.tables()]
    assert "hubs" in levels and levels.count("level2") > 1
    gk.reset_launch_counts()
    got = bn.aggregate(torch.from_numpy(h), kind).numpy()
    if kind == "max":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert not got[g.in_degrees == 0].any()
    assert not any(gk.LAUNCHES.values())        # CPU tensors: the plain versions


@pytest.fixture(scope="module")
def hub_graph():
    g = _graph(4400, 15000, 4200, seed=3)
    x = np.random.default_rng(4).normal(size=(4400, 12)).astype(np.float32)
    return g, x


CASES = [("mean", False, True), ("mean", True, False), ("gcn", False, False),
         ("gcn", True, True), ("pool", False, True), ("pool", True, False),
         ("lstm", False, False), ("lstm", True, True)]


def _assert_rows_close(got, want, msg=""):
    scale = 1.0 + np.abs(want).max(axis=1, keepdims=True)
    err = np.abs(got - want) / scale
    assert err.max() <= 1e-4, (msg, float(err.max()))


def _models(agg, preprocess, skip, n_layers=2):
    kw = dict(arch="graphsage", n_layers=n_layers, hidden=8, feat_dim=12, n_classes=5,
              aggregator=agg, preprocess=preprocess, skip_connection=skip, dropout=0.0)
    jcfg, tcfg = pg.ModelConfig(**kw), pt.ModelConfig(**kw)
    jp = jax.device_get(jsage.init_params(jax.random.PRNGKey(7), jcfg))
    model = get_model(tcfg)
    model.load_state_dict(params_from_jax(jp))
    return jcfg, tcfg, jp, model


@pytest.mark.parametrize("agg,preprocess,skip", CASES)
def test_full_graph_logits_match_jax(hub_graph, agg, preprocess, skip):
    g, x = hub_graph
    if agg == "lstm":
        g, x = _graph(300, 900, 40, seed=1), x[:300]
    jcfg, tcfg, jp, model = _models(agg, preprocess, skip)
    want = jinf.full_graph_logits(jp, jcfg, g, x, backend="host")
    for backend in ("host", "device"):
        got = tinf.full_graph_logits(model, tcfg, _tgraph(g), x, backend=backend)
        _assert_rows_close(got, want, backend)
    if agg in ("pool", "gcn"):              # JAX's own device backend agrees too
        jdev = jinf.full_graph_logits(jp, jcfg, g, x, backend="device")
        _assert_rows_close(got, np.asarray(jdev), "jax device")


@pytest.mark.parametrize("backend", ["host", "device"])
def test_evaluate_matches_jax(hub_graph, backend):
    g, x = hub_graph
    jcfg, tcfg, jp, model = _models("pool", False, True)
    labels = np.random.default_rng(5).integers(0, 5, g.num_nodes)
    mask = np.random.default_rng(6).random(g.num_nodes) < 0.3
    want = jinf.evaluate(jp, jcfg, g, x, labels, mask, backend="host")
    assert tinf.evaluate(model, tcfg, _tgraph(g), x, labels, mask, backend=backend) == want
    with pytest.raises(ValueError, match="unknown arch"):
        tinf.full_graph_logits(model, pt.ModelConfig(arch="sgc"), _tgraph(g), x)
