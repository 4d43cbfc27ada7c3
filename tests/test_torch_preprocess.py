"""GraphSAGE preprocess in the port against ``pagraph_tpu``: the native
SpMMs, the store's preprocess fields, the 2-hop teacher labels, the native
R-MAT CSR, and the Trainer in lockstep on both paths.

* ``spmm_mean_native`` and ``spmm_mean_i8_native`` (the port's copies of
  ``pg_spmm_mean_f32`` and ``pg_spmm_mean_i8``), ``full_graph_mean_aggregate``
  on both backends, ``FeatureStore.build`` and ``build_prequantized`` with
  each ``preprocess`` value: bit-equal to the JAX package's (the same
  arithmetic in the same order).
* ``neighborhood_labels`` (dense and chunked) and ``rmat_csr`` (native and
  numpy): equal.
* The Trainer with ``preprocess=True`` (the store's ``neigh`` field fetched
  beside ``features``, one hop less sampled), two epochs against JAX's on
  the host path at its defaults and on the on-device path, at the f32 and
  int8 cache tiers: losses and parameters within 1e-4.
"""
import jax
import numpy as np
import pytest

import pagraph_tpu as pg
import pagraph_tpu_torch as pt
from pagraph_tpu.data import synthetic as jsyn
from pagraph_tpu.sampling import native as jnative
from pagraph_tpu.storage import feature_store as jfs
from pagraph_tpu.train.loop import Trainer as JTrainer
from pagraph_tpu_torch.data import synthetic as tsyn
from pagraph_tpu_torch.graph import CSRGraph as TGraph
from pagraph_tpu_torch.sampling import native as tnative
from pagraph_tpu_torch.storage import feature_store as tfs
from pagraph_tpu_torch.train.loop import Trainer as TTrainer
from tests.test_torch_aggregators import run_lockstep


def _tgraph(g) -> TGraph:
    return TGraph(g.indptr, g.indices, g.out_degrees)


@pytest.fixture(scope="module")
def graph_feats():
    """A graph with zero-in-degree vertices, and relu'd features."""
    ds = jsyn.synthetic_dataset(num_nodes=700, num_edges=2000, feat_dim=24, seed=4)
    assert (ds.graph.in_degrees == 0).any()
    feats = np.maximum(np.random.default_rng(0).normal(size=ds.features.shape), 0
                       ).astype(np.float32)
    return ds.graph, feats


def test_spmms_match_jax(graph_feats):
    g, x = graph_feats
    norm = pg.graph.gcn_norm(g)
    np.testing.assert_array_equal(tnative.spmm_mean_native(_tgraph(g), x, norm),
                                  jnative.spmm_mean_native(g, x, norm))
    q = np.random.default_rng(1).integers(-127, 128, size=x.shape).astype(np.int8)
    scale = np.random.default_rng(2).random(x.shape[1]).astype(np.float32)
    for lo, hi in ((0, g.num_nodes), (100, 333), (5, 5)):
        np.testing.assert_array_equal(
            tnative.spmm_mean_i8_native(_tgraph(g), q, scale, norm, lo, hi),
            jnative.spmm_mean_i8_native(g, q, scale, norm, lo, hi))
    with pytest.raises(IndexError):
        tnative.spmm_mean_i8_native(_tgraph(g), q, scale, norm, 0, g.num_nodes + 1)
    with pytest.raises(ValueError, match="rows"):
        tnative.spmm_mean_native(_tgraph(g), x[:-1], norm)


@pytest.mark.parametrize("backend", ["native", "scipy", "auto"])
def test_full_graph_mean_aggregate_matches_jax(graph_feats, backend):
    g, x = graph_feats
    got = tfs.full_graph_mean_aggregate(_tgraph(g), x, backend=backend)
    np.testing.assert_array_equal(got, jfs.full_graph_mean_aggregate(g, x, backend=backend))
    assert not got[g.in_degrees == 0].any()


@pytest.mark.parametrize("preprocess", [None, "gcn", "graphsage"])
def test_build_matches_jax(graph_feats, preprocess):
    g, x = graph_feats
    t = tfs.FeatureStore.build(_tgraph(g), x, preprocess=preprocess)
    j = jfs.FeatureStore.build(g, x, preprocess=preprocess)
    assert list(t.fields) == list(j.fields)
    for name in j.fields:
        np.testing.assert_array_equal(t.fields[name], j.fields[name], err_msg=name)


@pytest.mark.parametrize("preprocess", [None, "gcn", "graphsage"])
def test_build_prequantized_matches_jax(graph_feats, preprocess):
    """Chunked (chunk 256 of 700 rows): the re-quantized field and its
    scale equal the JAX package's bit for bit."""
    g, x = graph_feats
    q = np.random.default_rng(3).integers(-127, 128, size=x.shape).astype(np.int8)
    t = tfs.build_prequantized(_tgraph(g), q, 0.02, preprocess=preprocess, chunk=256)
    j = jfs.build_prequantized(g, q, 0.02, preprocess=preprocess, chunk=256)
    assert list(t.fields) == list(j.fields) and list(t.scales) == list(j.scales)
    for name in j.fields:
        np.testing.assert_array_equal(t.fields[name], j.fields[name], err_msg=name)
    for name in j.scales:
        np.testing.assert_array_equal(t.scales[name], j.scales[name], err_msg=name)


@pytest.mark.parametrize("chunk_rows", [None, 128])
def test_neighborhood_labels_match_jax(graph_feats, chunk_rows):
    g, x = graph_feats
    np.testing.assert_array_equal(
        tsyn.neighborhood_labels(_tgraph(g), x, 7, seed=5, chunk_rows=chunk_rows),
        jsyn.neighborhood_labels(g, x, 7, seed=5, chunk_rows=chunk_rows))
    t = tsyn.synthetic_dataset(num_nodes=300, num_edges=1500, feat_dim=8, num_classes=4,
                               learnable="neighborhood", seed=2)
    j = jsyn.synthetic_dataset(num_nodes=300, num_edges=1500, feat_dim=8, num_classes=4,
                               learnable="neighborhood", seed=2)
    np.testing.assert_array_equal(t.labels, j.labels)


@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_rmat_csr_matches_jax(backend):
    t = tsyn.rmat_csr(10, 8, seed=3, backend=backend)
    j = jsyn.rmat_csr(10, 8, seed=3, backend=backend)
    for f in ("indptr", "indices", "out_degrees"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)


DATA = dict(num_nodes=600, num_edges=4800, feat_dim=16, num_classes=5, seed=21,
            learnable=True)


@pytest.fixture(scope="module")
def datasets():
    return jsyn.synthetic_dataset(**DATA), tsyn.synthetic_dataset(**DATA)


@pytest.mark.parametrize("device,cache_dtype", [(False, "float32"), (False, "int8"),
                                                (True, "float32"), (True, "int8")])
def test_preprocess_trainer_lockstep_with_jax(datasets, device, cache_dtype):
    """2 layers under preprocess: the ``pre`` update and one sampled hop
    (one block) less; the cache holds ``features`` and ``neigh``."""
    jds, tds = datasets
    kw = dict(
        model=dict(arch="graphsage", n_layers=2, hidden=8, feat_dim=16, n_classes=5,
                   dropout=0.0, preprocess=True),
        sampler=dict(batch_size=64, fanout=3, num_hops=2, seed=7),
        cache=dict(capacity=None if device else 300, dtype=cache_dtype),
        train=dict(lr=1e-2, on_device_sampling=device))
    jcfg, tcfg = (mod.Config(model=mod.ModelConfig(**kw["model"]),
                             sampler=mod.SamplerConfig(**kw["sampler"]),
                             cache=mod.CacheConfig(**kw["cache"]),
                             train=mod.TrainConfig(**kw["train"])) for mod in (pg, pt))
    jtr = JTrainer.from_dataset(jcfg, jds, seed=0)
    ttr = TTrainer.from_dataset(tcfg, tds, seed=0, device="cpu")
    assert ttr.cache.field_names == ["features", "neigh"] and ttr.cache.total_dim == 32
    assert ttr.cache.field_offsets == {"features": slice(0, 16), "neigh": slice(16, 32)}
    np.testing.assert_array_equal(ttr.store.fields["neigh"], jtr.store.fields["neigh"])
    run_lockstep(jtr, ttr, 2, 1e-4)
    assert len(ttr.state.model.updates) == 2 and hasattr(ttr.state.model, "pre")
