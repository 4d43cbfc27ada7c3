"""The port's host library (``pagraph_tpu_torch/csrc/host_native.cpp``,
``sampling/native.py``) against ``pagraph_tpu``'s native library: the
sampler's batches bit-equal from the same seed, the row gathers byte-equal,
the ``auto`` backend's epochs and calibrated caps equal, and the build safe
when processes start it at once.  Every comparison is exact (tolerance 0):
the C arithmetic is the same, and a gather copies bytes."""
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import pagraph_tpu as pg
import pagraph_tpu_torch as pt
from pagraph_tpu.data.synthetic import synthetic_dataset as jsynthetic
from pagraph_tpu.sampling import native as jnative
from pagraph_tpu.sampling.sampler import NeighborSampler as JSampler
from pagraph_tpu.storage.feature_store import FeatureStore as JStore
from pagraph_tpu.storage.feature_store import quantize_store as jquantize
from pagraph_tpu_torch.ops import _build
from pagraph_tpu_torch.sampling import native as tnative
from pagraph_tpu_torch.sampling.sampler import NeighborSampler as TSampler
from pagraph_tpu_torch.storage.feature_store import FeatureStore as TStore
from pagraph_tpu_torch.storage.feature_store import quantize_store as tquantize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAIL = 5    # trailing vertices with no in-edges


@pytest.fixture(scope="module", autouse=True)
def jax_native_lib():
    """pagraph_tpu builds its library in place at first use, without a
    lock across processes: test workers that start together may find it
    half written, so wait until it loads."""
    for _ in range(60):
        try:
            return jnative.get_lib()
        except (OSError, subprocess.CalledProcessError):
            time.sleep(2)
    return jnative.get_lib()


@pytest.fixture(scope="module")
def graphs():
    """An RMAT graph with TAIL vertices after the last edge row (their
    ``indptr`` is E), as (pagraph_tpu graph, port graph, features, labels)."""
    ds = jsynthetic(num_nodes=1500, num_edges=12000, feat_dim=24, num_classes=5,
                    kind="rmat", seed=13)
    g = ds.graph
    e = g.indptr[-1]
    indptr = np.concatenate([g.indptr, np.full(TAIL, e, dtype=g.indptr.dtype)])
    out_deg = np.concatenate([g.out_degrees, np.zeros(TAIL, dtype=g.out_degrees.dtype)])
    feats = np.concatenate([ds.features, np.ones((TAIL, ds.features.shape[1]), np.float32)])
    labels = np.concatenate([ds.labels, np.zeros(TAIL, dtype=ds.labels.dtype)])
    return (pg.CSRGraph(indptr, g.indices, out_deg), pt.CSRGraph(indptr, g.indices, out_deg),
            feats, labels)


def _assert_same_batch(tm, jm):
    for a, b in zip(tm.layer_nids + tm.layer_mask + (tm.labels,),
                    jm.layer_nids + jm.layer_mask + (jm.labels,), strict=True):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    for tb, jb in zip(tm.blocks, jm.blocks, strict=True):
        for f in ("neigh_pos", "neigh_mask", "self_pos"):
            np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f))
            assert getattr(tb, f).dtype == getattr(jb, f).dtype


@pytest.mark.parametrize("fanouts", [(1,), (7,), (2, 7), (7, 2), (1, 2, 7), (2, 2, 2)])
@pytest.mark.parametrize("overflow", [False, True], ids=["fits", "overflow"])
def test_native_sampler_bit_equal(graphs, fanouts, overflow):
    """Batches of the two native samplers from the same seeds: fan-outs 1,
    2 and 7 over 1-3 hops, caps that fit or overflow (edges to dropped
    vertices masked), seeds that include the trailing zero-in-degree
    vertices, four calls on one sampler (its scratch reused), and a repeat
    of the first seed giving the first batch again."""
    jg, tg, _, labels = graphs
    hops, batch = len(fanouts), 48
    kw = dict(batch_size=batch, fanouts=fanouts, num_hops=hops, seed=0)
    jcfg, tcfg = pg.SamplerConfig(**kw), pt.SamplerConfig(**kw)
    caps = list(jcfg.layer_capacities(tg.num_nodes))
    if overflow:
        caps = [batch + 8 * (hops - i) for i in range(hops)] + [batch]
    js, ts = jnative.NativeSampler(jg, jcfg, caps), tnative.NativeSampler(tg, tcfg, caps)
    rng = np.random.default_rng(sum(fanouts))
    n = tg.num_nodes
    seed_sets = [np.concatenate([np.arange(n - TAIL, n), rng.choice(n - TAIL, batch - TAIL,
                                                                   replace=False)])]
    seed_sets += [rng.choice(n, batch - 3 * i, replace=False) for i in range(3)]
    seeds_of_call = [7, 2**31 - 2, 0, 12345]
    got = []
    for seeds, s in zip(seed_sets, seeds_of_call):
        got.append(ts.sample(seeds, labels, s))
        _assert_same_batch(got[-1], js.sample(seeds, labels, s))
    first = got[0]
    assert not first.blocks[-1].neigh_mask[:TAIL].any()     # the tail seeds: no in-edges
    _assert_same_batch(ts.sample(seed_sets[0], labels, 7), first)
    if overflow:
        assert int(first.layer_mask[0].sum()) == caps[0]
    assert (ts._pos_of == -1).all()


@pytest.mark.parametrize("fanout,auto_caps", [(2, True), (3, False)])
def test_auto_backend_epochs_equal_jax(graphs, fanout, auto_caps):
    """``backend="auto"`` takes the native sampler on both sides: equal
    calibrated caps and two epochs of equal batches (the per-batch seed is
    drawn from the sampler's generator as JAX's is)."""
    jg, tg, _, labels = graphs
    kw = dict(batch_size=100, fanout=fanout, num_hops=2, seed=9)
    nids = np.arange(tg.num_nodes - 300, tg.num_nodes)
    js = JSampler(jg, nids, pg.SamplerConfig(**kw), labels=labels, seed=4)
    ts = TSampler(tg, nids, pt.SamplerConfig(**kw), labels=labels, seed=4)
    assert js._native is not None and ts.backend_name == "native"
    if auto_caps:
        assert ts.calibrate_caps() == js.calibrate_caps()
        assert ts.backend_name == "native"
    assert ts.caps == js.caps
    for _ in range(2):
        jb, tb = list(js.epoch()), list(ts.epoch())
        assert len(tb) == len(jb) == ts.num_batches
        for t, j in zip(tb, jb):
            _assert_same_batch(t, j)


def test_auto_falls_back_only_without_the_library(graphs, monkeypatch):
    """``auto`` samples with numpy, and says so, only when the library
    cannot be built; ``native`` then raises."""
    _, tg, _, _ = graphs
    cfg = pt.SamplerConfig(batch_size=16, seed=1)

    def no_compiler():
        raise RuntimeError("g++ not found")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(_build, "build_host", no_compiler)
    with pytest.warns(RuntimeWarning, match="falls back to numpy"):
        assert TSampler(tg, np.arange(50), cfg).backend_name == "numpy"
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        TSampler(tg, np.arange(50), cfg, backend="native")


@pytest.mark.parametrize("dtype", [np.float32, np.int8])
def test_gather_rows_equal_jax(dtype):
    """The f32 and int8 row gathers against pagraph_tpu's and ``np.take``,
    with repeated ids and into a given output."""
    rng = np.random.default_rng(3)
    src = (rng.normal(size=(400, 100)).astype(np.float32) if dtype == np.float32
           else rng.integers(-127, 128, size=(400, 100)).astype(np.int8))
    ids = rng.integers(0, 400, size=1000)
    t_fn, j_fn = ((tnative.gather_rows_f32, jnative.gather_rows_f32) if dtype == np.float32
                  else (tnative.gather_rows_i8, jnative.gather_rows_i8))
    got = t_fn(src, ids)
    np.testing.assert_array_equal(got, j_fn(src, ids))
    np.testing.assert_array_equal(got, np.take(src, ids, axis=0))
    out = np.empty((len(ids), 100), dtype=dtype)
    assert t_fn(src, ids, out) is out
    np.testing.assert_array_equal(out, got)
    with pytest.raises(IndexError):
        t_fn(src, np.array([400]))
    with pytest.raises(ValueError):
        t_fn(src[:, :50], ids)


@pytest.mark.parametrize("native", [True, False])
def test_feature_store_gathers_equal_jax(graphs, native):
    """FeatureStore gathers (f32; int8 as stored; int8 dequantized; both
    fields together) equal pagraph_tpu's store with its native gathers."""
    jg, tg, feats, _ = graphs
    jstore = JStore.build(jg, feats)
    tstore = TStore({"features": feats, "norm": pt.gcn_norm(tg)}, native=native)
    ids = np.random.default_rng(5).integers(0, tg.num_nodes, size=700)
    for names in (["features"], ["features", "norm"]):
        np.testing.assert_array_equal(tstore.gather(names, ids), jstore.gather(names, ids))
    jq, tq = jquantize(jstore), tquantize(tstore)
    tq.native = native
    np.testing.assert_array_equal(tq.gather(["features"], ids, quantized=True),
                                  jq.gather(["features"], ids, quantized=True))
    np.testing.assert_array_equal(tq.gather(["features"], ids), jq.gather(["features"], ids))


def test_concurrent_first_build(tmp_path):
    """Two processes that load the library at once into an empty build
    directory: both load it, one build lands (no temporary file is left),
    and both sample the same batch."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import pagraph_tpu_torch as pt\n"
        "from pagraph_tpu_torch.ops import _build\n"
        "_build.BUILD_DIR = sys.argv[1]\n"
        "from pagraph_tpu_torch.sampling import native\n"
        "native.get_lib()\n"
        "g = pt.CSRGraph(np.array([0, 1, 3, 4]), np.array([2, 0, 2, 1]), np.array([1, 2, 1]))\n"
        "cfg = pt.SamplerConfig(batch_size=2, fanout=1, num_hops=1)\n"
        "mb = native.NativeSampler(g, cfg, (4, 2)).sample(np.array([1, 2]), None, 3)\n"
        "print(mb.layer_nids[0].tolist(), mb.blocks[0].neigh_pos.ravel().tolist())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert outs[0][0] == outs[1][0] != ""
    names = sorted(os.listdir(tmp_path))
    assert [n for n in names if n.endswith(".so")] == [os.path.basename(
        _build._target(_build.HOST_SRC, _build.CXX_FLAGS))]
    assert not [n for n in names if n.endswith(".tmp")], names


def test_numpy_phantoms_native_none(graphs):
    """The numpy sampler (pagraph_tpu's and the port's alike) puts the
    vertex its masked slots read, for a destination with no in-edges, into
    the next layer, where no valid edge reaches it (ROADMAP section 3); the
    native sampler leaves it out."""
    jg, tg, _, labels = graphs
    nids = np.arange(tg.num_nodes)
    kw = dict(batch_size=200, fanout=2, num_hops=1, seed=0)

    def phantoms(mb):
        blk = mb.blocks[0]
        n_src, n_dst = int(mb.layer_mask[0].sum()), int(mb.layer_mask[1].sum())
        reached = np.zeros(n_src, dtype=bool)
        reached[:n_dst] = True
        reached[blk.neigh_pos[blk.neigh_mask]] = True
        return int((~reached).sum())

    deg = np.diff(tg.indptr)
    seeds = np.concatenate([np.nonzero(deg[:-TAIL] == 0)[0][:100],   # no in-edges, not the tail
                            np.nonzero(deg > 0)[0][:100]])
    caps = (2048, 200)
    t_np = TSampler(tg, nids, pt.SamplerConfig(**kw), backend="numpy", caps=caps).sample(seeds)
    j_np = JSampler(jg, nids, pg.SamplerConfig(**kw), backend="numpy", caps=caps).sample(seeds)
    _assert_same_batch(t_np, j_np)
    assert phantoms(t_np) > 0
    assert phantoms(TSampler(tg, nids, pt.SamplerConfig(**kw), caps=caps).sample(seeds)) == 0
