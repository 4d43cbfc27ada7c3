"""The port's packed batch transfer (``pagraph_tpu_torch/sampling/pack.py``
and the loader's packed host items and groups) against
``pagraph_tpu.sampling.pack``'s lean layout (``device_plan=True``): the
sections the two layouts share are byte-equal on the same MiniBatch, the
miss-row buffer equals JAX's at every tier (bf16 as its bits), and
``unpack`` gives back what was packed.  Every comparison is exact."""
import numpy as np
import pytest
import torch

import pagraph_tpu as pg
import pagraph_tpu_torch as pt
from pagraph_tpu.sampling import pack as jpack
from pagraph_tpu.sampling.sampler import NeighborSampler as JSampler
from pagraph_tpu.storage import cache as jcache
from pagraph_tpu.storage.feature_store import FeatureStore as JStore
from pagraph_tpu_torch.sampling import pack as tpack
from pagraph_tpu_torch.sampling.loader import PrefetchLoader
from pagraph_tpu_torch.sampling.sampler import NeighborSampler as TSampler
from pagraph_tpu_torch.storage import cache as tcache
from pagraph_tpu_torch.storage.feature_store import FeatureStore as TStore

TIERS = ("float32", "bfloat16", "int8")


def _tgraph(g):
    return pt.CSRGraph(g.indptr, g.indices, g.out_degrees)


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def _caches(ds, dtype, capacity):
    jc = jcache.FeatureCache(JStore.build(ds.graph, ds.features), ["features"], ds.graph,
                             dtype=dtype)
    tc = tcache.FeatureCache(TStore.build(_tgraph(ds.graph), ds.features), ["features"],
                             _tgraph(ds.graph), device="cpu", dtype=dtype)
    jc.fill(capacity=capacity)
    tc.fill(capacity=capacity)
    return jc, tc


def _batches(ds, fanouts, batch=96, n=3):
    cfg = pg.SamplerConfig(batch_size=batch, fanouts=fanouts, num_hops=len(fanouts), seed=2)
    s = JSampler(ds.graph, ds.train_nids, cfg, backend="numpy")
    s.calibrate_caps(pad=8)
    return cfg, s.caps, list(s.epoch())[:n]


@pytest.mark.parametrize("dtype", TIERS)
@pytest.mark.parametrize("fanouts", [(3, 2), (2, 2, 1)])
def test_pack_shared_sections_equal_jax(small_ds, dtype, fanouts):
    """Caps divisible by 8 (JAX's lean layout needs it): labels, self_pos
    and neigh_pos, and all three bit-packed mask sections, are byte-equal
    at the same offsets; the port's first int32 section is its plan's
    ``src_row`` where JAX's holds ``layer0_nids``; the miss rows are JAX's
    third buffer."""
    cfg, caps, mbs = _batches(small_ds, fanouts)
    assert all(c % 8 == 0 for c in caps)
    jc, tc = _caches(small_ds, dtype, small_ds.num_nodes // 3)
    for mb in mbs:
        nids, mask = np.asarray(mb.input_nids), np.asarray(mb.input_mask)
        jp, tp = jc.fetch_plan(nids, mask), tc.fetch_plan(nids, mask)
        bucket = tp.miss_feats.shape[0]
        jl = jpack.make_layout(caps, cfg.block_fanouts(), jc.total_dim,
                               bucket, device_plan=True)
        tl = tpack.make_layout(caps, cfg.block_fanouts(), tc.total_dim, bucket)
        ji32, ju8, jmiss = jpack.pack(mb, jp, jl)
        ti32, tu8, tmiss = tpack.pack(mb, tp.src_row, tp.miss_feats, tl)
        assert (ti32.dtype, tu8.dtype) == (torch.int32, torch.uint8)
        assert [n for _, n in tl.i32_sections()] == [n for _, n in jl.i32_sections()]
        assert tl.u8_sections() == jl.u8_sections()
        np.testing.assert_array_equal(ti32.numpy()[caps[0]:], ji32[caps[0]:])
        np.testing.assert_array_equal(ti32.numpy()[:caps[0]], tp.src_row)
        np.testing.assert_array_equal(tu8.numpy(), ju8)
        np.testing.assert_array_equal(_bits(tmiss), _bits(jmiss))
        assert tmiss.dtype == tcache.ROW_DTYPES[dtype]


@pytest.mark.parametrize("fanouts,batch", [((3, 2), 96), ((7,), 21)])
def test_unpack_round_trip(small_ds, fanouts, batch):
    """``unpack`` of ``pack`` gives the labels, the blocks, the input and
    seed masks, ``src_row`` and the miss rows back, also at caps that are
    not multiples of 8 (each mask section ends in a zero-padded byte);
    inner-layer ids are zeros and inner masks all true, as in JAX."""
    cfg = pt.SamplerConfig(batch_size=batch, fanouts=fanouts, num_hops=len(fanouts), seed=4)
    caps = (171, 21) if batch % 8 else None     # config caps are multiples of 8
    s = TSampler(_tgraph(small_ds.graph), small_ds.train_nids, cfg, labels=small_ds.labels,
                 caps=caps)
    _, tc = _caches(small_ds, "float32", small_ds.num_nodes // 2)
    for mb in list(s.epoch())[:2]:
        plan = tc.fetch_plan(mb.input_nids, mb.input_mask)
        layout = tpack.make_layout(s.caps, cfg.block_fanouts(), tc.total_dim,
                                   plan.miss_feats.shape[0])
        i32, u8, miss = tpack.pack(mb, plan.src_row, plan.miss_feats, layout)
        assert tuple(i32.shape) == (layout.i32_size,) and tuple(u8.shape) == (layout.u8_size,)
        got, src_row, got_miss = tpack.unpack(layout, i32, u8, miss)
        np.testing.assert_array_equal(src_row.numpy(), plan.src_row)
        assert got_miss is miss
        np.testing.assert_array_equal(got.labels.numpy(), mb.labels)
        for i in (0, -1):
            np.testing.assert_array_equal(got.layer_mask[i].numpy(), mb.layer_mask[i])
        for i in range(1, len(s.caps) - 1):
            assert got.layer_mask[i].all() and got.layer_mask[i].shape[0] == s.caps[i]
        for ids, cap in zip(got.layer_nids, s.caps):
            assert ids.shape == (cap,) and not ids.any()
        for gb, b in zip(got.blocks, mb.blocks, strict=True):
            for f, dt in (("neigh_pos", torch.int32), ("neigh_mask", torch.bool),
                          ("self_pos", torch.int32)):
                t = getattr(gb, f)
                assert t.dtype == dt and t.is_contiguous()
                np.testing.assert_array_equal(t.numpy(), getattr(b, f))
        assert got.num_sampled_edges() == mb.num_sampled_edges()


def test_stack_pads_to_the_largest_bucket(small_ds):
    """A group stacks its batches ``[K, ...]``, each batch's miss rows
    first and zeros after, to the largest bucket (JAX's padding), in new
    buffers, a group of one too; ``nbytes`` counts the three buffers."""
    cfg, caps, mbs = _batches(small_ds, (3, 2), n=3)
    layout = jpack.make_layout(caps, cfg.block_fanouts(), 16, 0, device_plan=True)
    rng = np.random.default_rng(0)
    items = []
    for mb, bucket in zip(mbs, (512, 0, 1024)):
        lay = tpack.make_layout(caps, layout.fanouts, 16, bucket)
        miss = torch.from_numpy(rng.normal(size=(bucket, 16)).astype(np.float32))
        src = rng.integers(-bucket, 50, size=caps[0]).astype(np.int32)
        items.append((lay, *tpack.pack(mb, src, miss, lay)))
    g = tpack.stack(items)
    assert g.k == 3 and g.layout.bucket == 1024
    assert tuple(g.miss.shape) == (3, 1024, 16)
    for j, (lay, i32, u8, miss) in enumerate(items):
        assert torch.equal(g.i32[j], i32) and torch.equal(g.u8[j], u8)
        assert torch.equal(g.miss[j, :lay.bucket], miss)
        assert not g.miss[j, lay.bucket:].any()
    assert g.nbytes == 3 * (4 * g.layout.i32_size + g.layout.u8_size + 1024 * 16 * 4)
    one = tpack.stack(items[:1])
    assert one.k == 1 and one.i32.data_ptr() != items[0][1].data_ptr()
    assert torch.equal(one.i32[0], items[0][1]) and torch.equal(one.miss[0], items[0][3])


@pytest.mark.parametrize("k", [None, 4])
def test_loader_items_equal_sampler_and_plan(small_ds, k):
    """The loader's packed host items (``k=None``: ``epoch()``; else its
    groups of ``k``, the last one partial), unpacked, carry a same-seed
    sampler's batches in order, their cache plans' ``src_row`` and miss
    rows (zeros after them in a group), and the edge and vertex counts."""
    cfg = pt.SamplerConfig(batch_size=64, fanout=3, num_hops=2, seed=6)

    def sampler():
        return TSampler(_tgraph(small_ds.graph), small_ds.train_nids, cfg,
                        labels=small_ds.labels, seed=1)
    _, tc = _caches(small_ds, "bfloat16", small_ds.num_nodes // 3)
    loader = PrefetchLoader(sampler(), tc, device="cpu", workers=3)
    if k is None:
        items = list(loader.epoch())
    else:
        groups = list(loader.groups(k))
        assert [g.k for g in groups[:-1]] == [k] * (len(groups) - 1) and groups[-1].k < k
        items = [(g.layout, g.i32[j], g.u8[j], g.miss[j]) for g in groups for j in range(g.k)]
    want = list(sampler().epoch())
    assert len(items) == len(want) > 4
    for (layout, i32, u8, miss), mb in zip(items, want):
        plan = tc.fetch_plan(mb.input_nids, mb.input_mask)
        got, got_src, got_miss = tpack.unpack(layout, i32, u8, miss)
        b = plan.miss_feats.shape[0]
        assert layout.bucket >= b and got_miss.shape[0] == layout.bucket
        np.testing.assert_array_equal(got_src.numpy(), plan.src_row)
        assert torch.equal(got_miss[:b], plan.miss_feats) and not got_miss[b:].any()
        np.testing.assert_array_equal(got.labels.numpy(), mb.labels)
        np.testing.assert_array_equal(got.layer_mask[0].numpy(), mb.layer_mask[0])
        for gb, bl in zip(got.blocks, mb.blocks, strict=True):
            for f in ("neigh_pos", "neigh_mask", "self_pos"):
                np.testing.assert_array_equal(getattr(gb, f).numpy(), getattr(bl, f))
    assert (loader.epoch_edges, loader.epoch_vertices) == (
        sum(mb.num_sampled_edges() for mb in want),
        sum(mb.num_loaded_vertices() for mb in want))
