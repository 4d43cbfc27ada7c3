"""The port's feature store and device cache against ``pagraph_tpu.storage``:
the same store and graph must give bit-equal fills, plans and (valid)
assembled rows, at every cache tier (f32, bf16, int8).  And two repairs of
the port's own: the ``access_freq`` refill after epoch 0 keeps the first
fill's capacity at ``capacity=None`` (the old table released first, on a
device whose free memory counts every live table), and
``cache.hbm_reserve_bytes`` sizes a ``capacity=None`` fill."""
import weakref

import numpy as np
import pytest
import torch

import pagraph_tpu as pg
import pagraph_tpu_torch as pt
from pagraph_tpu.sampling.sampler import NeighborSampler as JSampler
from pagraph_tpu.storage import cache as jcache
from pagraph_tpu.storage.feature_store import FeatureStore as JStore
from pagraph_tpu.utils import platform as jplatform
from pagraph_tpu_torch.graph import CSRGraph as TGraph
from pagraph_tpu_torch.storage import cache as tcache
from pagraph_tpu_torch.storage.feature_store import FeatureStore as TStore
from pagraph_tpu_torch.train.loop import Trainer

TIERS = ("float32", "bfloat16", "int8")


def _tgraph(g) -> TGraph:
    return TGraph(g.indptr, g.indices, g.out_degrees)


def _bits(x) -> np.ndarray:
    """Host values as comparable bits: bf16 as its uint16 patterns."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16) if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


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
    tc = tcache.FeatureCache(tstore, ["features"], _tgraph(ds.graph), device="cpu")
    np.testing.assert_array_equal(tc.rank_vertices(rank_by), jc.rank_vertices(rank_by))


@pytest.mark.parametrize("frac,dtype", [
    *(pytest.param(f, "float32", id=str(f)) for f in (0.0, 0.3, 1.0)),
    *(pytest.param(f, t, id=f"{t}-{f}") for t in TIERS[1:] for f in (0.0, 0.3, 1.0))])
def test_fill_plan_and_assembly_match(pair, frac, dtype):
    """Per tier: fill order, cache_map, the cache rows, the dequant scale and
    the plan's miss rows are bit-equal (bf16 as uint16 bits); the plan's
    one index a row encodes JAX's hit_mask / cache_pos / miss_slot on every
    valid row; the assembled f32 features equal ``dequantize_fused(
    assemble_features(...), scale)`` on every valid row (padded rows may
    differ: see assemble_features)."""
    ds, jstore, tstore = pair
    cap = int(ds.num_nodes * frac)
    jc = jcache.FeatureCache(jstore, ["features"], ds.graph, dtype=dtype)
    tc = tcache.FeatureCache(tstore, ["features"], _tgraph(ds.graph), device="cpu",
                             dtype=dtype)
    jc.fill(capacity=cap)
    tc.fill(capacity=cap)
    np.testing.assert_array_equal(tc.cache_map, jc.cache_map)
    np.testing.assert_array_equal(_bits(tc.cache_values), _bits(jc.cache_values))
    assert tc.cache_values.dtype == tcache.ROW_DTYPES[dtype]
    assert (tc.capacity, tc.fully_cached) == (jc.capacity, jc.fully_cached)
    if dtype == "int8":
        np.testing.assert_array_equal(tc.dequant_scale, jc.dequant_scale)
        np.testing.assert_array_equal(tc.dequant_scale_dev.numpy(), jc.dequant_scale)
    else:
        assert tc.dequant_scale is None and tc.dequant_scale_dev is None

    cfg = pg.SamplerConfig(batch_size=128, fanout=3, num_hops=2, seed=5)
    sampler = JSampler(ds.graph, ds.train_nids, cfg, backend="numpy")
    for mb in list(sampler.epoch())[:3]:
        nids, mask = np.asarray(mb.input_nids), np.asarray(mb.input_mask)
        jp, tp = jc.fetch_plan(nids, mask), tc.fetch_plan(nids, mask)
        np.testing.assert_array_equal(_bits(tp.miss_feats), _bits(jp.miss_feats))
        want_src = np.where(jp.hit_mask, jp.cache_pos, -1 - np.asarray(jp.miss_slot))
        np.testing.assert_array_equal(tp.src_row[mask], want_src[mask])
        assert tp.src_row.dtype == np.int32 and not tp.src_row[~mask].any()
        want = jcache.dequantize_fused(jcache.assemble_features(jc.cache_values, jp),
                                       jc.dequant_scale)
        scale = tc.dequant_scale_dev
        got = tcache.assemble_features(tc.cache_values, torch.from_numpy(tp.src_row),
                                       tp.miss_feats, scale)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy()[mask], np.asarray(want)[mask])
        if dtype == "float32":
            np.testing.assert_array_equal(got.numpy()[mask], ds.features[nids[mask]])
    assert tc.miss_rate() == jc.miss_rate()


def test_dequant_scale_and_quantize_rows_match():
    """compute_dequant_scale (chunked pass, a zero-variance column gets
    scale 1) and quantize_rows (round to nearest, clipped at +-127) are
    bit-equal to the JAX package's on the same store and rows."""
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(700, 12)).astype(np.float32) * np.arange(1, 13, dtype=np.float32)
    feats[:, 4] = 0.0                   # zero variance
    feats[:, 7] = 2.5                   # constant, nonzero
    jstore, tstore = JStore({"features": feats}), TStore({"features": feats})
    js = jcache.compute_dequant_scale(jstore, ["features"], chunk=128)
    ts = tcache.compute_dequant_scale(tstore, ["features"], chunk=128)
    np.testing.assert_array_equal(ts, js)
    assert ts.dtype == np.float32 and ts[4] == 1.0
    rows = np.concatenate([feats[:50], 3.0 * feats[50:100]])   # x3 rows clip at +-127
    tq, jq = tcache.quantize_rows(rows, ts), jcache.quantize_rows(rows, js)
    np.testing.assert_array_equal(tq, jq)
    assert tq.dtype == np.int8 and tq.max() == 127 and tq.min() == -127
    assert not tq[:, 4].any()


@pytest.mark.parametrize("dtype", TIERS)
def test_auto_capacity_scales_with_tier(pair, monkeypatch, dtype):
    """capacity=None budgets with the tier's own row width, as the JAX
    package does: bf16 caches 2x the vertices of f32, int8 4x."""
    ds, jstore, tstore = pair
    reserve, room = 1 << 30, 32 * 4 * 400         # 400 f32 rows of the store's width
    _free_device_bytes(monkeypatch, lambda: reserve + room)
    monkeypatch.setattr(jplatform, "free_hbm_bytes", lambda device=None, reserve=0: room)
    tc = tcache.FeatureCache(tstore, ["features"], _tgraph(ds.graph), device="cpu",
                             dtype=dtype)
    jc = jcache.FeatureCache(jstore, ["features"], ds.graph, dtype=dtype)
    want = 400 * {"float32": 1, "bfloat16": 2, "int8": 4}[dtype]
    assert tc.auto_capacity(reserve_bytes=reserve) == jc.auto_capacity() == want
    tc.fill(None)
    assert tc.capacity == want and tc.cache_values.shape == (want, 32)


def test_unported_tiers_raise(pair):
    """The store holds f32 and int8 fields only (an int8 field needs its
    scale, as in the JAX package: tests/test_torch_store_int8.py)."""
    ds, _, tstore = pair
    with pytest.raises(NotImplementedError):
        TStore({"features": ds.features.astype(np.float64)})
    with pytest.raises(ValueError):
        TStore({"features": ds.features.astype(np.int8)})
    with pytest.raises(ValueError):      # capacity=None sizes from GPU memory
        tcache.FeatureCache(tstore, ["features"], _tgraph(ds.graph),
                            device="cpu").fill(None)


def _free_device_bytes(monkeypatch, free):
    """The cache sees a card with ``free()`` free bytes: its
    ``free_hbm_bytes`` (``utils/platform.py``) is that less the reserve, as
    the JAX package's arithmetic gives it."""
    monkeypatch.setattr(tcache, "free_hbm_bytes",
                        lambda device=None, reserve=1 << 30: max(0, free() - reserve))


def _charging_live_caches(monkeypatch, total):
    """The free bytes of a device with ``total`` bytes that every
    live cache table of a ``FeatureCache.fill`` uses (a table is live while
    anything references it), as ``mem_get_info`` sees a CUDA device."""
    live = weakref.WeakSet()
    fill = tcache.FeatureCache.fill

    def tracking_fill(self, *a, **kw):
        fill(self, *a, **kw)
        live.add(self.cache_values)

    monkeypatch.setattr(tcache.FeatureCache, "fill", tracking_fill)
    _free_device_bytes(monkeypatch, lambda: total - sum(t.nbytes for t in live))


def _host_cfg(**cache):
    return pt.Config(model=pt.ModelConfig(arch="graphsage", n_layers=1, hidden=8, feat_dim=32,
                                          n_classes=10, dropout=0.0),
                     sampler=pt.SamplerConfig(batch_size=256, fanout=3, num_hops=2, seed=1),
                     cache=pt.CacheConfig(**cache),
                     train=pt.TrainConfig(lr=1e-2))


def test_access_freq_refill_keeps_the_first_capacity(small_ds, monkeypatch):
    """``capacity=None`` with ``rank_by="access_freq"``: the refill after
    epoch 0 holds as many vertices as the first fill, on a device whose
    free memory counts every live cache table.  The old table is released
    before the new one is sized and copied, so a second ``fill(None)`` of
    the same cache sizes itself the same too."""
    from pagraph_tpu_torch.data.synthetic import synthetic_dataset
    ds = synthetic_dataset(num_nodes=2000, num_edges=16000, feat_dim=32, num_classes=10,
                           seed=3)
    reserve, room = 1 << 30, 32 * 4 * 700          # 700 f32 rows
    _charging_live_caches(monkeypatch, reserve + room)
    tr = Trainer.from_dataset(_host_cfg(capacity=None, rank_by="access_freq"), ds,
                              device="cpu")
    tr._maybe_fill_cache()
    first = (tr.cache.capacity, tr.cache.cache_values.shape)
    assert first == (700, (700, 32)) and not tr.cache.fully_cached
    before = tr.cache.cache_map.copy()
    tr.run_epoch(0)
    assert (tr.cache.capacity, tr.cache.cache_values.shape) == first
    assert not np.array_equal(tr.cache.cache_map, before)      # it did refill
    tr.cache.fill(None, rank_by="access_freq")
    assert tr.cache.capacity == 700


def test_hbm_reserve_bytes_sizes_a_none_fill(small_ds, monkeypatch):
    """``cache.hbm_reserve_bytes`` reaches the Trainer's cache: a
    ``capacity=None`` fill leaves that many bytes free (here 1 MiB, not the
    default 1 GiB); ``auto_capacity(reserve)`` still takes an explicit
    reserve."""
    from pagraph_tpu_torch.data.synthetic import synthetic_dataset
    ds = synthetic_dataset(num_nodes=2000, num_edges=16000, feat_dim=32, num_classes=10,
                           seed=3)
    reserve, room = 1 << 20, 32 * 4 * 900
    _free_device_bytes(monkeypatch, lambda: reserve + room)
    tr = Trainer.from_dataset(_host_cfg(capacity=None, hbm_reserve_bytes=reserve), ds,
                              device="cpu")
    tr._maybe_fill_cache()
    assert tr.cache.capacity == 900
    assert tr.cache.reserve_bytes == reserve
    assert tr.cache.auto_capacity(reserve_bytes=reserve + 32 * 4 * 100) == 800
    default = tcache.FeatureCache(tr.store, ["features"], _tgraph(ds.graph), device="cpu")
    assert default.reserve_bytes == pt.CacheConfig().hbm_reserve_bytes == 1 << 30
