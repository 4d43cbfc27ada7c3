"""The int8 store tier (pre-quantized fields) in the port against
``pagraph_tpu.storage``, on the CPU.

``quantize_store``, ``build_prequantized(preprocess=None)`` and both kinds of
gather are bit-equal to the JAX package's on the same numpy inputs.  An int8
cache over a pre-quantized store has the store's own scale (no pass over
the data) and, because ``quantize_store`` and the cache quantize with the
same per-column ``maxabs / 127`` scale, the same int8 rows, plans, miss
rate and shipped bytes as an int8 cache over the f32 store.  So training on
it is the same training, to the bit.
"""
import numpy as np
import pytest
import torch

import pagraph_tpu as pg
from pagraph_tpu.sampling.sampler import NeighborSampler as JSampler
from pagraph_tpu.storage import cache as jcache
from pagraph_tpu.storage import feature_store as jfs
import pagraph_tpu_torch as pt
from pagraph_tpu_torch.data.synthetic import synthetic_dataset as tsynthetic
from pagraph_tpu_torch.graph import CSRGraph as TGraph
from pagraph_tpu_torch.storage import cache as tcache
from pagraph_tpu_torch.storage import feature_store as tfs
from pagraph_tpu_torch.train.loop import Trainer as TTrainer


def _tgraph(g) -> TGraph:
    return TGraph(g.indptr, g.indices, g.out_degrees)


def _feats(n=700, d=12, seed=3) -> np.ndarray:
    """Columns of different scales, one all zero and one constant."""
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(n, d)).astype(np.float32) * np.arange(1, d + 1, dtype=np.float32)
    f[:, 4] = 0.0
    f[:, 7] = -2.5
    return f


def _assert_stores_equal(t, j) -> None:
    assert list(t.fields) == list(j.fields) and list(t.scales) == list(j.scales)
    for name in j.fields:
        assert t.fields[name].dtype == j.fields[name].dtype, name
        np.testing.assert_array_equal(t.fields[name], j.fields[name], err_msg=name)
    for name in j.scales:
        assert t.scales[name].dtype == np.float32
        np.testing.assert_array_equal(t.scales[name], j.scales[name], err_msg=name)


@pytest.mark.parametrize("field_names,chunk", [(None, 1 << 20), (None, 128),
                                               (["features", "extra"], 100)])
def test_quantize_store_matches_jax(field_names, chunk):
    """Default fields (every multi-column f32 field) and named ones, in one
    chunk or several: int8 rows and scales bit-equal, ``norm`` passed
    through; an all-zero column gets scale 1."""
    feats = _feats()
    extra = _feats(seed=4)[:, :5] * 100.0
    norm = np.random.default_rng(5).random((700, 1)).astype(np.float32)
    fields = {"features": feats, "extra": extra, "norm": norm}
    t = tfs.quantize_store(tfs.FeatureStore(dict(fields)), field_names, chunk=chunk)
    j = jfs.quantize_store(jfs.FeatureStore(dict(fields), native=False), field_names,
                           chunk=chunk)
    _assert_stores_equal(t, j)
    assert t.is_quantized(["features", "extra"]) and not t.is_quantized(["norm"])
    assert t.scales["features"][4] == 1.0 and not t.fields["features"][:, 4].any()
    assert t.fields["norm"] is norm


@pytest.mark.parametrize("scale", ["scalar", "per_column"])
def test_build_prequantized_matches_jax(small_ds, scale):
    """build_prequantized(preprocess=None): the int8 features with one scale
    (broadcast) or one a column, and the norm field, bit-equal."""
    rng = np.random.default_rng(8)
    feats_i8 = rng.integers(-127, 128, size=(small_ds.num_nodes, 32)).astype(np.int8)
    sc = 0.02 if scale == "scalar" else (rng.random(32).astype(np.float32) + 0.1) / 127
    t = tfs.build_prequantized(_tgraph(small_ds.graph), feats_i8, sc)
    j = jfs.build_prequantized(small_ds.graph, feats_i8, sc)
    _assert_stores_equal(t, j)
    assert t.scales["features"].shape == (32,)
    np.testing.assert_array_equal(t.fused_scale(["features"]), j.fused_scale(["features"]))


@pytest.mark.parametrize("preprocess", ["gcn", "graphsage"])
def test_build_prequantized_preprocess_raises(small_ds, preprocess):
    """The preprocess field is ported (tests/test_torch_preprocess.py); its
    int8 SpMM refuses features with fewer rows than the graph has vertices
    (it reads a row of every in-neighbor)."""
    feats_i8 = np.zeros((small_ds.num_nodes - 1, 8), np.int8)
    with pytest.raises(ValueError, match="rows"):
        tfs.build_prequantized(_tgraph(small_ds.graph), feats_i8, 0.1, preprocess=preprocess)


@pytest.mark.parametrize("names", [["features"], ["features", "norm"], ["norm", "features"]])
def test_gathers_match_jax(names):
    """gather(quantized=True) returns the stored int8 rows, with or without
    an ``out`` buffer; the default gather dequantizes int8 fields to f32
    (and leaves f32 ones); both bit-equal to the JAX package's."""
    fields = {"features": _feats(), "norm": np.random.default_rng(6).random(700).astype(np.float32)}
    t = tfs.quantize_store(tfs.FeatureStore(dict(fields)))
    j = jfs.quantize_store(jfs.FeatureStore(dict(fields), native=False))
    nids = np.random.default_rng(7).integers(0, 700, size=300)
    got, want = t.gather(names, nids), j.gather(names, nids)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if names == ["features"]:
        q = t.gather(names, nids, quantized=True)
        assert q.dtype == np.int8
        np.testing.assert_array_equal(q, j.gather(names, nids, quantized=True))
        out = np.zeros((400, 12), np.int8)
        t.gather(names, nids, out=out[:300], quantized=True)
        np.testing.assert_array_equal(out[:300], q)
        assert not out[300:].any()
    else:
        with pytest.raises(ValueError):
            t.gather(names, nids, quantized=True)


def test_store_validates_fields_like_jax():
    f = _feats()
    q = f.astype(np.int8)
    for bad in (dict(fields={"features": q}),                                  # no scale
                dict(fields={"features": f}, scales={"features": np.ones(12)}),  # f32 field
                dict(fields={"features": q}, scales={"features": np.ones(5)})):  # length
        with pytest.raises(ValueError):
            jfs.FeatureStore(**bad, native=False)
        with pytest.raises(ValueError):
            tfs.FeatureStore(**bad)
    with pytest.raises(NotImplementedError):                     # other dtypes stay refused
        tfs.FeatureStore({"features": f.astype(np.float64)})
    s = tfs.FeatureStore({"features": q}, scales={"features": np.full(12, 0.5)}, native=False)
    assert s.is_quantized(["features"]) and s.fused_scale(["features"]).dtype == np.float32


def test_compute_dequant_scale_short_circuits():
    """On a pre-quantized store the scale is the store's own fused scale (no
    pass over the data: the int8 rows are never read), equal to the JAX
    package's, and to the scale computed from the f32 store."""
    f32 = tfs.FeatureStore({"features": _feats()})
    t = tfs.quantize_store(f32)
    j = jfs.quantize_store(jfs.FeatureStore({"features": _feats()}, native=False))
    rows = t.fields["features"]
    t.fields["features"] = np.lib.stride_tricks.as_strided(rows, rows.shape, (0, 0))
    got = tcache.compute_dequant_scale(t, ["features"])
    np.testing.assert_array_equal(got, jcache.compute_dequant_scale(j, ["features"]))
    np.testing.assert_array_equal(got, tcache.compute_dequant_scale(f32, ["features"]))
    np.testing.assert_array_equal(got, t.scales["features"])


@pytest.fixture(scope="module")
def stores(small_ds):
    f32 = tfs.FeatureStore.build(_tgraph(small_ds.graph), small_ds.features)
    jf32 = jfs.FeatureStore.build(small_ds.graph, small_ds.features)
    return small_ds, f32, tfs.quantize_store(f32), jfs.quantize_store(jf32)


@pytest.mark.parametrize("frac", [0.0, 0.3, 1.0])
def test_int8_cache_from_prequantized_store(stores, frac):
    """FeatureCache(int8) over quantize_store(store): the same scale, cache
    rows, plans (int8 miss rows bit for bit, src_row), miss rate and shipped
    bytes as over the f32 store, and fill / fetch_plan equal to the JAX
    package's over its pre-quantized store."""
    ds, f32, q, jq = stores
    g = _tgraph(ds.graph)
    cap = int(ds.num_nodes * frac)
    a = tcache.FeatureCache(f32, ["features"], g, device="cpu", dtype="int8")
    b = tcache.FeatureCache(q, ["features"], g, device="cpu", dtype="int8")
    jc = jcache.FeatureCache(jq, ["features"], ds.graph, dtype="int8")
    for c in (a, b, jc):
        c.fill(capacity=cap)
    np.testing.assert_array_equal(b.dequant_scale, a.dequant_scale)
    np.testing.assert_array_equal(b.dequant_scale, jc.dequant_scale)
    assert b.cache_values.dtype == torch.int8
    np.testing.assert_array_equal(b.cache_values.numpy(), a.cache_values.numpy())
    np.testing.assert_array_equal(b.cache_values.numpy(), np.asarray(jc.cache_values))
    sampler = JSampler(ds.graph, ds.train_nids, pg.SamplerConfig(batch_size=128, fanout=3,
                                                                 num_hops=2, seed=5),
                       backend="numpy")
    for mb in list(sampler.epoch())[:3]:
        nids, mask = np.asarray(mb.input_nids), np.asarray(mb.input_mask)
        pa, pb, pj = a.fetch_plan(nids, mask), b.fetch_plan(nids, mask), jc.fetch_plan(nids, mask)
        assert pb.miss_feats.dtype == torch.int8
        np.testing.assert_array_equal(pb.miss_feats.numpy(), pa.miss_feats.numpy())
        np.testing.assert_array_equal(pb.miss_feats.numpy(), np.asarray(pj.miss_feats))
        np.testing.assert_array_equal(pb.src_row, pa.src_row)
        assert pb.miss_feats.numpy().nbytes == pa.miss_feats.numpy().nbytes
    assert b.miss_rate() == a.miss_rate() == jc.miss_rate()


@pytest.mark.parametrize("on_device,compute", [(False, "float32"), (False, "bfloat16"),
                                               (True, "bfloat16")])
def test_trainer_on_prequantized_store(on_device, compute):
    """Trainer(cfg, quantize_store(store), ...) at the int8 tier trains as
    Trainer.from_dataset does at that tier: equal losses, miss rates and
    shipped bytes, epoch by epoch, on the host path and the on-device path
    (which fills its full cache from the store too); a build_prequantized
    store of the same int8 rows and scale trains the same."""
    ds = tsynthetic(num_nodes=800, num_edges=6400, feat_dim=32, num_classes=6, seed=21,
                    learnable=True)
    cfg = pt.Config(model=pt.ModelConfig(arch="graphsage", n_layers=1, hidden=16, feat_dim=32,
                                         n_classes=6, dropout=0.0),
                    sampler=pt.SamplerConfig(batch_size=128, fanouts=(3, 2), num_hops=2,
                                             seed=7),
                    cache=pt.CacheConfig(capacity=None if on_device else 400, dtype="int8"),
                    train=pt.TrainConfig(lr=1e-2, dtype=compute, on_device_sampling=on_device))
    q = tfs.quantize_store(tfs.FeatureStore.build(ds.graph, ds.features))
    built = tfs.build_prequantized(ds.graph, q.fields["features"], q.scales["features"])
    runs = [TTrainer.from_dataset(cfg, ds, seed=0, device="cpu")]
    runs += [TTrainer(cfg, s, ds.graph, ds.train_nids, ds.labels, seed=0, device="cpu")
             for s in (q, built)]
    for tr in runs:
        tr.train(2)
    want = [(m.mean_loss, m.miss_rate, m.h2d_bytes, m.edges) for m in runs[0].epoch_metrics]
    for tr in runs[1:]:
        assert tr.cache._store_i8
        assert [(m.mean_loss, m.miss_rate, m.h2d_bytes, m.edges)
                for m in tr.epoch_metrics] == want
    assert want[1][0] < want[0][0]
