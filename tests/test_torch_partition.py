"""The port's partition pipeline against ``pagraph_tpu``'s, on the same
numpy graphs (the JAX package's ``tests/test_partition.py``,
``test_kl_part.py``, ``test_native_pipeline.py`` and
``test_edge_balance.py``, held against the JAX functions instead of
re-derived):

* ``hop_closure``, ``extract_partition``, ``dg_assign`` (numpy and native,
  vertex and edge balance), ``hash_partition``, ``kl_bisect``,
  ``kl_assign``, ``reorder_map`` / ``apply_reordering`` and
  ``partition_stats`` equal to the JAX package's, array for array;
* the native helpers (``hop_closure_native``, ``map_rows_native``,
  ``histogram_i32_native``, ``dg_assign_native``) equal to the JAX
  package's native ones;
* partitions and datasets written by either package load in the other;
* ``Trainer.from_partition`` in lockstep with JAX's for 2 epochs on both
  single-device paths: losses within 1e-4, equal batches and miss rates.

Everything here is exact but the lockstep's losses (float32 training).
"""
import jax
import numpy as np
import pytest
import scipy.sparse as spsp

import pagraph_tpu as pg
import pagraph_tpu.partition as jpart
import pagraph_tpu_torch as pt
import pagraph_tpu_torch.partition as tpart
from pagraph_tpu.data import formats as jfmt
from pagraph_tpu.data.synthetic import synthetic_dataset as jsynthetic
from pagraph_tpu.graph import CSRGraph as JGraph
from pagraph_tpu.partition.kl_part import train_affinity as jaffinity
from pagraph_tpu.sampling import native as jnative
from pagraph_tpu.storage.feature_store import FeatureStore as JStore
from pagraph_tpu.train.loop import Trainer as JTrainer
from pagraph_tpu_torch.convert import params_from_jax
from pagraph_tpu_torch.data import formats as tfmt
from pagraph_tpu_torch.data.synthetic import synthetic_dataset as tsynthetic
from pagraph_tpu_torch.graph import CSRGraph as TGraph
from pagraph_tpu_torch.partition.kl_part import train_affinity as taffinity
from pagraph_tpu_torch.sampling import native as tnative
from pagraph_tpu_torch.storage.feature_store import FeatureStore as TStore
from pagraph_tpu_torch.train.loop import Trainer as TTrainer
from tests.test_torch_device_epoch import _jax_epoch_randomness

DATA = dict(num_nodes=700, num_edges=5600, feat_dim=12, num_classes=4, seed=5,
            learnable=True)


@pytest.fixture(scope="module")
def datasets():
    return jsynthetic(**DATA), tsynthetic(**DATA)


def _tg(g: JGraph) -> TGraph:
    return TGraph(g.indptr, g.indices, g.out_degrees)


def assert_parts_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for k in ("indptr", "indices", "out_degrees"):
            np.testing.assert_array_equal(getattr(a.graph, k), getattr(b.graph, k), err_msg=k)
        for k in ("train_nids", "local2full", "labels"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)


def hub_heavy_graph(n=900, hubs=5, hub_deg=200, base_edges=3000, seed=3):
    """Random edges plus a few in-hubs (the edge-balance case)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, base_edges)
    dst = rng.integers(0, n, base_edges)
    for h in range(hubs):
        src = np.concatenate([src, rng.choice(n, hub_deg, replace=False)])
        dst = np.concatenate([dst, np.full(hub_deg, h)])
    keep = src != dst
    return JGraph.from_coo(spsp.coo_matrix((np.ones(keep.sum(), np.float32),
                                            (dst[keep], src[keep])), shape=(n, n)))


@pytest.mark.parametrize("backend", ["numpy", "native"])
@pytest.mark.parametrize("hops", [0, 1, 2, 3])
def test_hop_closure_and_extract_match_jax(datasets, backend, hops):
    jds, tds = datasets
    seeds = jds.train_nids[::7]
    want = jpart.hop_closure(jds.graph, seeds, hops, backend=backend)
    got = tpart.hop_closure(tds.graph, seeds, hops, backend=backend)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)
    if hops:
        assert_parts_equal(
            [tpart.extract_partition(tds.graph, seeds, tds.labels, hops, backend=backend)],
            [jpart.extract_partition(jds.graph, seeds, jds.labels, hops, backend=backend)])


def test_hop_closure_exhausted_early():
    """A path 0 <- 1 <- 2: the BFS from {0} ends before hops - 1 levels."""
    g = JGraph.from_coo(spsp.coo_matrix((np.ones(2, np.float32), ([0, 1], [1, 2])),
                                        shape=(4, 4)))
    for backend in ("numpy", "native"):
        want = jpart.hop_closure(g, np.array([0]), 5, backend=backend)
        got = tpart.hop_closure(_tg(g), np.array([0]), 5, backend=backend)
        for a, b in zip(got, want, strict=True):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("edge_balance", [False, True])
@pytest.mark.parametrize("backend", ["numpy", "native"])
@pytest.mark.parametrize("num_parts,hops", [(2, 1), (4, 2), (3, 3)])
def test_dg_assign_matches_jax(backend, edge_balance, num_parts, hops):
    """The greedy stream, vertex- or edge-balanced, bit for bit: on a
    hub-heavy graph, whose ties and weights exercise the tie rule."""
    g = hub_heavy_graph()
    train = np.sort(np.random.default_rng(num_parts).choice(g.num_nodes, 500, replace=False))
    want = jpart.dg_assign(g, train, num_parts, hops, backend=backend,
                           edge_balance=edge_balance)
    got = tpart.dg_assign(_tg(g), train, num_parts, hops, backend=backend,
                          edge_balance=edge_balance)
    np.testing.assert_array_equal(got, want)
    # the port's two backends agree with each other as well
    other = "numpy" if backend == "native" else "native"
    np.testing.assert_array_equal(
        tpart.dg_assign(_tg(g), train, num_parts, hops, backend=other,
                        edge_balance=edge_balance), got)


def test_dg_assign_train_frac_matches_jax(datasets):
    jds, tds = datasets
    for backend in ("numpy", "native"):
        np.testing.assert_array_equal(
            tpart.dg_assign(tds.graph, tds.train_nids, 4, 2, train_frac=0.65, backend=backend),
            jpart.dg_assign(jds.graph, jds.train_nids, 4, 2, train_frac=0.65, backend=backend))


@pytest.mark.parametrize("method", ["dg", "hash", "kl"])
def test_partitions_match_jax(datasets, method):
    """Whole partitionings and their stats equal to the JAX package's."""
    jds, tds = datasets
    fn = {"dg": "dg_partition", "hash": "hash_partition", "kl": "kl_partition"}[method]
    want = getattr(jpart, fn)(jds.graph, jds.train_nids, jds.labels, 3, 2)
    got = getattr(tpart, fn)(tds.graph, tds.train_nids, tds.labels, 3, 2)
    assert_parts_equal(got, want)
    assert tpart.partition_stats(got, tds.num_nodes) == \
        jpart.partition_stats(want, jds.num_nodes)
    covered = np.sort(np.concatenate([p.local2full[p.train_nids] for p in got]))
    np.testing.assert_array_equal(covered, tds.train_nids)


def test_kl_matches_jax(datasets):
    """The affinity graph, one bisection and the recursive assignment."""
    jds, tds = datasets
    wa = jaffinity(jds.graph, jds.train_nids, 2)
    wb = taffinity(tds.graph, tds.train_nids, 2)
    assert (wa != wb).nnz == 0
    np.testing.assert_array_equal(tpart.kl_bisect(wb, target0=200, seed=3),
                                  jpart.kl_bisect(wa, target0=200, seed=3))
    for parts in (2, 5):
        np.testing.assert_array_equal(tpart.kl_assign(tds.graph, tds.train_nids, parts, 1),
                                      jpart.kl_assign(jds.graph, jds.train_nids, parts, 1))


@pytest.mark.parametrize("cluster", [False, True])
def test_reordering_matches_jax(datasets, cluster):
    jds, tds = datasets
    vmap = tpart.reorder_map(tds.graph, cluster=cluster)
    np.testing.assert_array_equal(vmap, jpart.reorder_map(jds.graph, cluster=cluster))
    a, b = tpart.apply_reordering(tds, vmap), jpart.apply_reordering(jds, vmap)
    for k in ("indptr", "indices", "out_degrees"):
        np.testing.assert_array_equal(getattr(a.graph, k), getattr(b.graph, k))
    for k in ("features", "labels", "train_mask", "val_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


def test_graph_helpers_match_jax(datasets):
    jds, tds = datasets
    for v in (0, 5, 699):
        np.testing.assert_array_equal(tds.graph.in_neighbors(v), jds.graph.in_neighbors(v))
    assert (tds.graph.to_coo() != jds.graph.to_coo()).nnz == 0
    nodes = np.random.default_rng(1).choice(700, 250, replace=False)
    (ts, tmap), (js, jmap) = tds.graph.subgraph(nodes), jds.graph.subgraph(nodes)
    np.testing.assert_array_equal(tmap, jmap)
    for k in ("indptr", "indices", "out_degrees"):
        np.testing.assert_array_equal(getattr(ts, k), getattr(js, k))


def test_native_helpers_match_jax(datasets):
    """The port's host library against the JAX package's, call for call."""
    jds, tds = datasets
    g = tds.graph
    seeds = tds.train_nids[::5]
    for hops in (1, 2):
        for a, b in zip(tnative.hop_closure_native(g, seeds, hops),
                        jnative.hop_closure_native(jds.graph, seeds, hops), strict=True):
            np.testing.assert_array_equal(a, b)
    closure, interior = tnative.hop_closure_native(g, seeds, 2)
    full2sub = np.full(g.num_nodes, -1, np.int64)
    full2sub[closure] = np.arange(len(closure))
    lens = g.indptr[interior + 1] - g.indptr[interior]
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    got = tnative.map_rows_native(g, full2sub, interior, starts, int(lens.sum()))
    np.testing.assert_array_equal(
        got, jnative.map_rows_native(jds.graph, full2sub, interior, starts, int(lens.sum())))
    np.testing.assert_array_equal(tnative.histogram_i32_native(got, len(closure)),
                                  jnative.histogram_i32_native(got, len(closure)))
    holed = full2sub.copy()
    holed[got[0]] = -1                  # an interior row's neighbor outside the map
    with pytest.raises(ValueError, match="closure"):
        tnative.map_rows_native(g, holed, interior, starts, int(lens.sum()))
    w = g.in_degrees[tds.train_nids].astype(np.float64) + 1.0
    for weights, avg in ((None, 100.0), (w, float(w.sum()) / 3)):
        np.testing.assert_array_equal(
            tnative.dg_assign_native(g, tds.train_nids, 3, 2, avg, weights),
            jnative.dg_assign_native(jds.graph, jds.train_nids, 3, 2, avg, weights))
    with pytest.raises(ValueError, match="pg_dg_assign"):
        tnative.dg_assign_native(g, np.array([g.num_nodes]), 3, 2, 1.0)


def test_artifacts_load_across_packages(tmp_path, datasets):
    """A partition written by either package loads in the other, equal;
    the reference's train-labels-only layout is scattered to the whole
    local space by both; a dataset directory round-trips both ways."""
    jds, tds = datasets
    parts = tpart.dg_partition(tds.graph, tds.train_nids, tds.labels, 2, 2)
    for writer, reader, name in ((tfmt, jfmt, "from_port"), (jfmt, tfmt, "from_jax")):
        d = tfmt.partition_dir(str(tmp_path), 2, name)
        assert d == jfmt.partition_dir(str(tmp_path), 2, name)
        for r, p in enumerate(parts):
            writer.save_partition(d, r, writer.PartitionArtifact(p.graph, p.train_nids,
                                                                 p.local2full, p.labels))
        assert_parts_equal([reader.load_partition(d, r) for r in range(2)], parts)
    d = str(tmp_path / "ref")
    p = parts[0]
    tfmt.save_partition(d, 0, tfmt.PartitionArtifact(p.graph, p.train_nids, p.local2full,
                                                     p.labels[p.train_nids]))
    assert_parts_equal([tfmt.load_partition(d, 0)], [jfmt.load_partition(d, 0)])
    np.testing.assert_array_equal(tfmt.load_partition(d, 0).labels[p.train_nids],
                                  p.labels[p.train_nids])
    for writer, reader, name in ((tfmt, jfmt, "ds_port"), (jfmt, tfmt, "ds_jax")):
        path = str(tmp_path / name)
        writer.save_dataset(path, tds if writer is tfmt else jds)
        back = reader.load_dataset(path)
        for k in ("indptr", "indices", "out_degrees"):
            np.testing.assert_array_equal(getattr(back.graph, k), getattr(tds.graph, k))
        for k in ("features", "labels", "train_mask", "val_mask", "test_mask"):
            np.testing.assert_array_equal(getattr(back, k), getattr(tds, k))


@pytest.mark.parametrize("device", [False, True])
def test_from_partition_lockstep_with_jax(device):
    """``Trainer.from_partition`` over part 0 of a 2-way dg partition (of a
    sparser graph) and the full store, against JAX's from the same parameters for 2 epochs
    (the host path at the JAX package's defaults; the device path with
    JAX's random integers): equal batches, edges and miss rates, losses
    within 1e-4, and the cache reading the full store through
    ``local2full``."""
    sparse = {**DATA, "num_edges": 1400}          # 2-hop closures smaller than the graph
    jds, tds = jsynthetic(**sparse), tsynthetic(**sparse)
    part = tpart.dg_partition(tds.graph, tds.train_nids, tds.labels, 2, 2)[0]
    assert part.num_nodes < tds.num_nodes
    kw = dict(
        model=dict(arch="graphsage", n_layers=1, hidden=8, feat_dim=12, n_classes=4,
                   dropout=0.0),
        sampler=dict(batch_size=32, fanouts=(3, 2), num_hops=2, seed=7),
        cache=dict(capacity=None if device else part.num_nodes * 2 // 5),
        train=dict(lr=1e-2, on_device_sampling=device))
    jcfg, tcfg = (mod.Config(model=mod.ModelConfig(**kw["model"]),
                             sampler=mod.SamplerConfig(**kw["sampler"]),
                             cache=mod.CacheConfig(**kw["cache"]),
                             train=mod.TrainConfig(**kw["train"])) for mod in (pg, pt))
    jp = jfmt.PartitionArtifact(JGraph(part.graph.indptr, part.graph.indices,
                                       part.graph.out_degrees), part.train_nids,
                                part.local2full, part.labels)
    jtr = JTrainer.from_partition(jcfg, jp, JStore.build(jds.graph, jds.features), seed=0)
    ttr = TTrainer.from_partition(tcfg, part, TStore.build(tds.graph, tds.features), seed=0,
                                  device="cpu")
    ttr.state.model.load_state_dict(params_from_jax(jax.device_get(jtr.state.params)))
    if device:
        n_train = len(part.train_nids)
        ttr.epoch_randomness = lambda e, out=None: _jax_epoch_randomness(0, e, n_train, tcfg)
    jtr.train(2)
    ttr.train(2)
    for jm, tm in zip(jtr.epoch_metrics, ttr.epoch_metrics, strict=True):
        assert (tm.num_batches, tm.edges, tm.vertices) == (jm.num_batches, jm.edges,
                                                             jm.vertices)
        assert tm.miss_rate == jm.miss_rate
        assert abs(tm.mean_loss - jm.mean_loss) < 1e-4, (tm.mean_loss, jm.mean_loss)
    if device:        # the full cache: local vertex i holds the store's row local2full[i]
        np.testing.assert_array_equal(ttr.cache.cache_values.numpy(),
                                      tds.features[part.local2full])
