"""The port's feature store and device cache against ``pagraph_tpu.storage``:
the same store and graph must give bit-equal fills, plans and (valid)
assembled rows."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pagraph_tpu as pg
from pagraph_tpu.sampling.sampler import NeighborSampler as JSampler
from pagraph_tpu.storage import cache as jcache
from pagraph_tpu.storage.feature_store import FeatureStore as JStore
from pagraph_tpu_torch.graph import CSRGraph as TGraph
from pagraph_tpu_torch.storage import cache as tcache
from pagraph_tpu_torch.storage.feature_store import FeatureStore as TStore


def _tgraph(g) -> TGraph:
    return TGraph(g.indptr, g.indices, g.out_degrees)


@pytest.fixture(scope="module")
def pair(small_ds):
    jstore = JStore.build(small_ds.graph, small_ds.features)
    tstore = TStore.build(_tgraph(small_ds.graph), small_ds.features)
    return small_ds, jstore, tstore


def test_store_build_and_gather_match(pair):
    ds, jstore, tstore = pair
    assert list(jstore.fields) == list(tstore.fields)
    nids = np.random.default_rng(0).integers(0, ds.num_nodes, size=300)
    for names in (["features"], ["features", "norm"]):
        np.testing.assert_array_equal(tstore.gather(names, nids),
                                      jstore.gather(names, nids))


@pytest.mark.parametrize("n", [0, 1, 511, 512, 513, 5000, 9000])
def test_bucket_size_matches(n):
    assert tcache.bucket_size(n, 8192) == jcache.bucket_size(n, 8192)


@pytest.mark.parametrize("rank_by", ["out_degree", "in_degree", "access_freq"])
def test_rank_vertices_match(pair, rank_by):
    ds, jstore, tstore = pair
    jc = jcache.FeatureCache(jstore, ["features"], ds.graph)
    tc = tcache.FeatureCache(tstore, ["features"], _tgraph(ds.graph))
    np.testing.assert_array_equal(tc.rank_vertices(rank_by), jc.rank_vertices(rank_by))


@pytest.mark.parametrize("frac", [0.0, 0.3, 1.0])
def test_fill_plan_and_assembly_match(pair, frac):
    """Fill order, cache_map, cache rows, the miss slots and the miss rows
    are bit-equal; the assembled layer-0 features are equal on every valid row
    (padded rows may differ: see assemble_features_from_map)."""
    ds, jstore, tstore = pair
    cap = int(ds.num_nodes * frac)
    jc = jcache.FeatureCache(jstore, ["features"], ds.graph)
    tc = tcache.FeatureCache(tstore, ["features"], _tgraph(ds.graph), device="cpu")
    jc.fill(capacity=cap)
    tc.fill(capacity=cap)
    np.testing.assert_array_equal(tc.cache_map, jc.cache_map)
    np.testing.assert_array_equal(tc.cache_map_dev.numpy(), jc.cache_map)
    np.testing.assert_array_equal(tc.cache_values.numpy(), np.asarray(jc.cache_values))
    assert (tc.capacity, tc.fully_cached) == (jc.capacity, jc.fully_cached)

    cfg = pg.SamplerConfig(batch_size=128, fanout=3, num_hops=2, seed=5)
    sampler = JSampler(ds.graph, ds.train_nids, cfg, backend="numpy")
    for mb in list(sampler.epoch())[:3]:
        nids, mask = np.asarray(mb.input_nids), np.asarray(mb.input_mask)
        jp, tp = jc.fetch_plan(nids, mask), tc.fetch_plan(nids, mask)
        for field in ("miss_slot", "miss_feats"):
            np.testing.assert_array_equal(getattr(tp, field), np.asarray(getattr(jp, field)))
        want = jcache.assemble_features_from_map(
            jc.cache_values, jnp.asarray(jc.cache_map), jnp.asarray(nids),
            jnp.asarray(mask), jnp.asarray(jp.miss_feats))
        got = tcache.assemble_features_from_map(
            tc.cache_values, tc.cache_map_dev, torch.from_numpy(nids),
            torch.from_numpy(tp.miss_slot), torch.from_numpy(tp.miss_feats))
        np.testing.assert_array_equal(got.numpy()[mask], np.asarray(want)[mask])
        np.testing.assert_array_equal(got.numpy()[mask], ds.features[nids[mask]])
    assert tc.miss_rate() == jc.miss_rate()


def test_unported_tiers_raise(pair):
    ds, _, tstore = pair
    with pytest.raises(NotImplementedError):
        tcache.FeatureCache(tstore, ["features"], _tgraph(ds.graph), dtype="bfloat16")
    with pytest.raises(NotImplementedError):
        TStore({"features": ds.features.astype(np.int8)})
    with pytest.raises(ValueError):      # capacity=None sizes from GPU memory
        tcache.FeatureCache(tstore, ["features"], _tgraph(ds.graph)).fill(None)
