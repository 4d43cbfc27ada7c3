"""The port's host sampler, synthetic data and config against
``pagraph_tpu``: the same seed must give identical arrays."""
import dataclasses

import numpy as np
import pytest

import pagraph_tpu as pg
import pagraph_tpu_torch as pt
from pagraph_tpu.data import synthetic as jsyn
from pagraph_tpu.sampling.sampler import NeighborSampler as JSampler
from pagraph_tpu_torch.data import synthetic as tsyn
from pagraph_tpu_torch.sampling.sampler import NeighborSampler as TSampler


def _assert_same_batch(tm, jm):
    for a, b in zip(tm.layer_nids + tm.layer_mask + (tm.labels,),
                    jm.layer_nids + jm.layer_mask + (jm.labels,)):
        np.testing.assert_array_equal(a, np.asarray(b))
        assert a.dtype == np.asarray(b).dtype
    for tb, jb in zip(tm.blocks, jm.blocks):
        for f in ("neigh_pos", "neigh_mask", "self_pos"):
            np.testing.assert_array_equal(getattr(tb, f), np.asarray(getattr(jb, f)))
        assert tb.prefix_layout is False
    assert tm.num_sampled_edges() == jm.num_sampled_edges()
    assert tm.num_loaded_vertices() == jm.num_loaded_vertices()


def _pair_graph(ds):
    return pt.CSRGraph(ds.graph.indptr, ds.graph.indices, ds.graph.out_degrees)


@pytest.mark.parametrize("kind,learnable", [("uniform", False), ("rmat", True)])
def test_synthetic_dataset_identical(kind, learnable):
    kw = dict(num_nodes=600, num_edges=4000, feat_dim=12, num_classes=5,
              kind=kind, seed=4, learnable=learnable)
    jd, td = jsyn.synthetic_dataset(**kw), tsyn.synthetic_dataset(**kw)
    for f in ("indptr", "indices", "out_degrees"):
        np.testing.assert_array_equal(getattr(td.graph, f), getattr(jd.graph, f))
    for f in ("features", "labels", "train_mask", "val_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(td, f), getattr(jd, f))
    np.testing.assert_array_equal(pt.gcn_norm(td.graph), pg.gcn_norm(jd.graph))


def test_config_matches():
    for cfg in (pg.SamplerConfig(), pg.SamplerConfig(fanouts=(5, 3), cap_factor=0.5)):
        tcfg = pt.SamplerConfig(**dataclasses.asdict(cfg))
        assert tcfg.layer_capacities(5000) == cfg.layer_capacities(5000)
        assert tcfg.block_fanouts() == cfg.block_fanouts()
    assert (dataclasses.asdict(pt.Config())
            == dataclasses.asdict(pg.Config()))
    # one JSON config drives either package
    jcfg = pg.Config(model=pg.ModelConfig(arch="graphsage", n_layers=2),
                     sampler=pg.SamplerConfig(num_hops=3, fanouts=(4, 3, 2)))
    tcfg = pt.Config.from_json(jcfg.to_json())
    assert tcfg.to_json() == jcfg.to_json()
    tcfg.partition.num_hops = 1
    assert tcfg.sync_hops().partition.num_hops == jcfg.sync_hops().partition.num_hops == 3
    for bad in (dict(model=pt.ModelConfig(n_layers=2)),
                dict(train=pt.TrainConfig(dtype="float16"))):
        with pytest.raises(ValueError):
            pt.Config(**bad)


@pytest.mark.parametrize("fanout,auto_caps", [(3, False), (2, True)])
def test_epochs_identical(small_ds, fanout, auto_caps):
    """Two epochs of batches, including calibrate_caps and the per-epoch
    shuffle, are identical to pagraph_tpu's numpy sampler."""
    kw = dict(batch_size=96, fanout=fanout, num_hops=2, seed=9, backend="numpy")
    jcfg, tcfg = pg.SamplerConfig(**kw), pt.SamplerConfig(**kw)
    js = JSampler(small_ds.graph, small_ds.train_nids, jcfg, labels=small_ds.labels, seed=2)
    ts = TSampler(_pair_graph(small_ds), small_ds.train_nids, tcfg,
                  labels=small_ds.labels, seed=2)
    if auto_caps:
        assert ts.calibrate_caps() == js.calibrate_caps()
    assert ts.caps == js.caps
    for _ in range(2):
        jb, tb = list(js.epoch()), list(ts.epoch())
        assert len(tb) == len(jb) == ts.num_batches
        for t, j in zip(tb, jb):
            _assert_same_batch(t, j)


def test_overflow_and_unsorted_seeds(small_ds):
    """Capacity overflow (edges to dropped vertices masked) matches too."""
    kw = dict(batch_size=64, fanout=4, num_hops=2, seed=1)
    caps = (96, 80, 64)
    js = JSampler(small_ds.graph, small_ds.train_nids, pg.SamplerConfig(**kw),
                  backend="numpy", caps=caps)
    ts = TSampler(_pair_graph(small_ds), small_ds.train_nids, pt.SamplerConfig(**kw),
                  backend="numpy", caps=caps)
    seeds = small_ds.train_nids[::-7][:64]
    _assert_same_batch(ts.sample(seeds), js.sample(seeds))


def test_zero_in_degree_tail_vertex():
    """A seed with no in-edges whose CSR row starts at E: the reference's
    numpy sampler raises IndexError there (ROADMAP "Faults"); the port
    masks all its slots.  Seeds before it still match the reference."""
    g = pt.CSRGraph(indptr=np.array([0, 2, 3, 3, 3]), indices=np.array([1, 2, 0]),
                    out_degrees=np.array([1, 1, 1, 0]))
    cfg = pt.SamplerConfig(batch_size=2, fanout=2, num_hops=1, seed=0)
    mb = TSampler(g, np.arange(4), cfg, backend="numpy", caps=(8, 2)).sample(np.array([3, 2]))
    assert not mb.blocks[0].neigh_mask[:2].any()
    jg = pg.CSRGraph(g.indptr, g.indices, g.out_degrees)
    jcfg = pg.SamplerConfig(batch_size=2, fanout=2, num_hops=1, seed=0)
    with pytest.raises(IndexError):
        JSampler(jg, np.arange(4), jcfg, backend="numpy", caps=(8, 2)).sample(np.array([3]))
    seeds = np.array([0, 1])
    _assert_same_batch(
        TSampler(g, np.arange(4), cfg, backend="numpy", caps=(8, 2)).sample(seeds),
        JSampler(jg, np.arange(4), jcfg, backend="numpy", caps=(8, 2)).sample(seeds))


def test_native_backend_not_ported(small_ds):
    """``backend="native"`` samples with the port's native sampler, says so
    in ``backend_name``, and gives pagraph_tpu's native batches (the name
    is kept from when the port refused this backend)."""
    cfg = pt.SamplerConfig(backend="native", batch_size=64, seed=3)
    ts = TSampler(_pair_graph(small_ds), small_ds.train_nids, cfg, labels=small_ds.labels)
    assert ts.backend_name == "native"
    js = JSampler(small_ds.graph, small_ds.train_nids, pg.SamplerConfig(**dataclasses.asdict(cfg)),
                  labels=small_ds.labels)
    for t, j in zip(ts.epoch(), js.epoch(), strict=True):
        _assert_same_batch(t, j)
    assert TSampler(_pair_graph(small_ds), small_ds.train_nids, cfg,
                    backend="numpy").backend_name == "numpy"
