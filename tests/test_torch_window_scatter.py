"""The window reduction (``gather_kernels.gather_reduce`` at a fan-out with no
unrolled instantiation) and ``scatter_add_rows``: their launch plans, and
their plain versions against the JAX package.

* ``window_plan`` and ``scatter_grid`` pick each kernel's geometry in
  Python from the shapes alone; here, on every window table of an RMAT-16
  graph's ``_BucketedNeighborhoods`` and at the chip shapes
  (``chip_smoke.py``'s RMAT-20 tables and block-1 backward), the window plan
  keeps shared memory within its limit and covers every output row and every
  slot exactly once, and the scatter grid every item and every table cell,
  as the kernels read them.
* ``gather_reduce`` (its plain version on the CPU) against the JAX
  package's ``bucketed_aggregate`` at fan-outs 32 and up, with hubs split at
  a small ``f_cap`` (hub windows of 48 slots, not a power of two), f32 and
  bf16 rows, and against ``_window_reduce`` on rows with no valid slot:
  f32 sums within 1e-5 (another summation order), bf16 sums within 1e-2 of
  the row scale (JAX sums bf16 rows in its own order and rounding), max
  exact.
* ``scatter_add_rows`` against ``jax.vjp`` of ``jnp.take`` with repeated
  ids, one table row, no ids and D = 30: f32 within 1e-5, bf16 within 1e-2.
* On the card each wrapper makes exactly one launch through its own C entry
  (checked here with the library replaced by a recorder).
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as spsp
import torch

from pagraph_tpu.graph import CSRGraph as JGraph
from pagraph_tpu.models import inference as jinf
from pagraph_tpu_torch.data import synthetic
from pagraph_tpu_torch.graph import CSRGraph as TGraph
from pagraph_tpu_torch.models import inference as tinf
from pagraph_tpu_torch.ops import gather_kernels as gk


WIN_BATCH = 8      # slots a window worker loads before it reduces (kWinBatch)


def _covered_once(spans, n):
    """True if the half-open ``spans`` cover ``range(n)`` exactly once."""
    hits = np.zeros(n, dtype=np.int64)
    for lo, hi in spans:
        assert 0 <= lo <= hi <= n, (lo, hi, n)
        hits[lo:hi] += 1
    return bool((hits == 1).all())


def _check_window_plan(rows, fanout, d, vec):
    plan = gk.window_plan(rows, fanout, d, vec)
    if fanout in gk.UNROLLED_FANOUTS:
        assert plan is None
        return
    assert plan.smem <= 48 * 1024       # pg_window_reduce refuses more (no opt-in)
    # rows: row b * R + r of CTA b, warp group r
    r_cta = plan.rows_per_cta
    assert plan.grid * r_cta >= rows > (plan.grid - 1) * r_cta or rows == plan.grid == 0
    assert _covered_once([(b * r_cta, min(rows, b * r_cta + r_cta)) for b in range(plan.grid)],
                         rows)
    # slots: tiles of `tile`, and in each tile the workers' chunks of kWinBatch
    assert 1 <= plan.tile <= gk.WINDOW_TILE // r_cta
    tiles = [(t0, min(fanout, t0 + plan.tile)) for t0 in range(0, fanout, plan.tile)]
    assert _covered_once(tiles, fanout)
    batch, w = WIN_BATCH, plan.workers
    for t0, t1 in tiles:
        n = t1 - t0
        chunks = [(c, min(n, c + batch)) for k in range(w)
                  for c in range(k * batch, n, w * batch)]
        assert _covered_once(chunks, n)
    # units: unit i = pass base + lane sub, a worker's 1 << lanes_log2 lanes
    units = d // 4 if vec else d
    lanes = 1 << plan.lanes_log2
    assert lanes == min(32, 1 << max(0, (units - 1).bit_length()))
    assert _covered_once([(b, min(units, b + lanes)) for b in range(0, units, lanes)], units)
    # the layout window_smem_bytes allots: mbarrier, staged slots, partials, counts
    stride = -(-plan.tile // 16) * 16
    assert plan.smem == 16 + 5 * r_cta * stride + gk.THREADS * 16 + gk.WARPS * 4


CU_SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "pagraph_tpu_torch", "csrc", "gather_kernels.cu")


def _cu_constant(src, name):
    """The value of ``constexpr int <name> = <expr>;`` in the kernel source,
    its expression evaluated over the constants before it."""
    expr = re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)
    names = re.findall(r"\bk[A-Z]\w*", expr)
    return eval(expr, {}, {n: _cu_constant(src, n) for n in names})


def test_window_geometry_matches_the_kernel_source():
    """The Python side's copies of the kernel source's choices: the fan-outs
    PG_FANOUT_SWITCH unrolls (any other takes the window kernel), the CTA's
    threads and warps, the window tile and batch, and window_smem_bytes
    (which pg_window_reduce holds ``smem`` to) -- so neither can drift."""
    with open(CU_SOURCE) as f:
        src = f.read()
    switch = re.search(r"#define PG_FANOUT_SWITCH\(.*?default:", src, re.S).group(0)
    assert tuple(int(c) for c in re.findall(r"case (\d+):", switch)) == gk.UNROLLED_FANOUTS
    assert (_cu_constant(src, "kThreads"), _cu_constant(src, "kWarpsPerBlock")) == (
        gk.THREADS, gk.WARPS)
    assert _cu_constant(src, "kWinTile") == gk.WINDOW_TILE
    assert _cu_constant(src, "kWinBatch") == WIN_BATCH
    body = re.search(r"inline int window_smem_bytes\(int rows_per_cta, int tile\) \{"
                     r"\s*const int stride = ([^;]+);\s*return ([^;]+);\s*\}", src)
    consts = {n: _cu_constant(src, n) for n in ("kThreads", "kWarpsPerBlock")}
    for rows, fanout in CHIP_WINDOWS:
        plan = gk.window_plan(rows, fanout, 100, True)
        if plan is None:
            continue
        scope = dict(consts, rows_per_cta=plan.rows_per_cta, tile=plan.tile)
        scope["stride"] = eval(body.group(1), {}, scope)
        assert plan.smem == eval(body.group(2), {}, scope), (rows, fanout)


@pytest.fixture(scope="module")
def rmat16_tables():
    coo = synthetic.rmat_coo(16, 16, seed=42)
    g = TGraph.from_coo(coo)
    bn = tinf._BucketedNeighborhoods(g, "cpu")
    return [(lv, tuple(p.shape)) for lv, p, _ in bn.tables()]


@pytest.mark.parametrize("d,vec", [(100, True), (16, True), (32, True), (30, False),
                                   (600, True)])
def test_window_plan_on_rmat16_tables(rmat16_tables, d, vec):
    """Every table of the RMAT-16 graph (buckets F = 8 .. 4096, hubs, second
    levels), at the feature width, the hidden widths and D = 30 / 600."""
    levels = {lv for lv, _ in rmat16_tables}
    assert {"bucket", "hubs", "level2"} <= levels
    assert any(f >= gk.WINDOW_CTA_FANOUT for _, (_, f) in rmat16_tables)
    for _, (rows, fanout) in rmat16_tables:
        _check_window_plan(rows, fanout, d, vec)


# the RMAT-20 window tables of chip_smoke.py's inference phase (rows, F: the
# buckets, the hubs' 470 windows, the second levels), at D = 100 and 16; and
# the window_branches cases
CHIP_WINDOWS = [(377_124, 8), (41_814, 16), (66_361, 32), (13_462, 64), (26_369, 128),
                (15_463, 256), (41, 512), (4845, 1024), (811, 2048), (329, 4096),
                (470, 4096), (190, 2), (20, 4), (1, 16), (300, 9), (300, 40), (40, 1001),
                (9, 4100), (9, 8192), (1, 4096), (0, 64)]


@pytest.mark.parametrize("rows,fanout", CHIP_WINDOWS)
@pytest.mark.parametrize("d,vec", [(100, True), (16, True), (30, False)])
def test_window_plan_at_chip_shapes(rows, fanout, d, vec):
    _check_window_plan(rows, fanout, d, vec)
    plan = gk.window_plan(rows, fanout, d, vec)
    if plan is not None:
        assert plan.warps_log2 == (3 if fanout >= gk.WINDOW_CTA_FANOUT else 0)


@pytest.mark.parametrize("n_ids,num_src,d,vec,sms", [
    (6000, 12_544, 32, True, 132), (6000, 21_760, 32, True, 132),
    (18_000, 12_544, 32, True, 132), (18_000, 21_760, 32, True, 132),
    (200_000, 1 << 20, 16, True, 132), (0, 70, 16, True, 132), (5, 1, 30, False, 132),
    (300, 7, 30, False, 4), (1000, 100_000, 100, True, 4), (0, 1, 1, False, 132)])
def test_scatter_grid_covers_every_item_and_cell_once(n_ids, num_src, d, vec, sms):
    """The cooperative grid: at least one CTA, at most SCATTER_CTAS_PER_SM a
    SM, no more than a thread a unit of work; thread t takes items t + k x
    (threads of the grid), its first kCoopItems before the barrier and the
    rest after, and zeroes cells the same way: every (id, unit) item and
    every table cell exactly once."""
    grid = gk.scatter_grid(n_ids, num_src, d, vec, sms)
    units = d // 4 if vec else d
    items, cells = n_ids * units, num_src * units
    assert 1 <= grid <= gk.SCATTER_CTAS_PER_SM * sms
    assert (grid - 1) * gk.THREADS < max(items, cells, 1)
    stride = grid * gk.THREADS
    first, later = 8, []
    hits = np.zeros(items, dtype=np.int64)
    for t in range(stride):
        for w in range(t, min(items, t + first * stride), stride):
            hits[w] += 1
        later.extend(range(t + first * stride, items, stride))
    np.add.at(hits, np.asarray(later, dtype=np.int64), 1)
    assert (hits == 1).all()
    zeroed = np.zeros(cells, dtype=np.int64)
    for t in range(min(stride, cells)):
        zeroed[t::stride] += 1
    assert (zeroed == 1).all()


def _hub_graph(n, e, hubs, seed):
    """Random edges, ``hubs`` in-hubs (vertex i of in-degree hubs[i]), and
    the highest ids without in-edges."""
    rng = np.random.default_rng(seed)
    src, dst = [rng.integers(0, n, e)], [rng.integers(len(hubs), n - n // 10, e)]
    for v, deg in enumerate(hubs):
        src.append(rng.choice(np.arange(len(hubs), n), deg, replace=False))
        dst.append(np.full(deg, v))
    src, dst = np.concatenate(src), np.concatenate(dst)
    keep = src != dst
    return JGraph.from_coo(spsp.coo_matrix((np.ones(keep.sum(), np.float32),
                                            (dst[keep], src[keep])), shape=(n, n)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["sum", "max"])
@pytest.mark.parametrize("f_min,f_cap", [(32, 4096), (32, 48), (64, 100)])
def test_gather_reduce_matches_bucketed_aggregate(f_min, f_cap, kind, dtype):
    """Windows of 32 slots and more; f_cap 48 and 100 split the hubs into
    windows of a width that is not a power of two, reduced again by a
    second level."""
    g = _hub_graph(3000, 30_000, [300, 130, 97], seed=f_cap)
    h = np.random.default_rng(5).normal(size=(3000, 12)).astype(np.float32)
    jbn = jinf._BucketedNeighborhoods(g, f_min=f_min, f_cap=f_cap)
    bn = tinf._BucketedNeighborhoods(TGraph(g.indptr, g.indices, g.out_degrees), "cpu",
                                     f_min=f_min, f_cap=f_cap)
    widths = {lv: [p.shape[1] for lv_, p, _ in bn.tables() if lv_ == lv]
              for lv in ("bucket", "hubs", "level2")}
    assert min(widths["bucket"]) >= 32
    assert widths["hubs"] == ([f_cap] if f_cap < 4096 else [])
    tdtype, jdtype = getattr(torch, dtype), getattr(jnp, dtype)
    got = bn.aggregate(torch.from_numpy(h).to(tdtype), kind).float().numpy()
    want = np.asarray(jinf.bucketed_aggregate(jbn.device_args(), jbn.static_meta(),
                                              jnp.asarray(h, dtype=jdtype), kind),
                      dtype=np.float32)
    if kind == "max":
        np.testing.assert_array_equal(got, want)
    elif dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        scale = np.abs(want).max(axis=1, keepdims=True) + 1.0
        assert (np.abs(got - want) / scale).max() <= 1e-2
    assert not got[g.in_degrees == 0].any()


@pytest.mark.parametrize("kind", ["sum", "max"])
@pytest.mark.parametrize("fanout", [32, 48, 4096])
def test_gather_reduce_rows_with_no_valid_slot(kind, fanout):
    """Rows whose every slot is masked give zeros, as the JAX window
    reduction gives for rows of padding (index = the appended zero row)."""
    rng = np.random.default_rng(fanout)
    n_src, rows = 200, 6
    h = rng.normal(size=(n_src, 10)).astype(np.float32)
    pos = rng.integers(0, n_src, size=(rows, fanout)).astype(np.int32)
    mask = rng.random((rows, fanout)) < 0.5
    mask[[0, 3]] = False
    idx = np.where(mask, pos, n_src).astype(np.int32)
    h_pad = np.concatenate([h, np.zeros((1, 10), np.float32)])
    want = np.asarray(jinf._window_reduce(jnp.asarray(h_pad), jnp.asarray(idx[None]), kind))
    got = gk.gather_reduce(torch.from_numpy(h), torch.from_numpy(np.where(mask, pos, 0)),
                           torch.from_numpy(mask), kind).numpy()
    if kind == "max":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert not got[[0, 3]].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["duplicates", "one row", "no ids", "D=30"])
def test_scatter_add_rows_matches_vjp(case, dtype):
    """scatter_add_rows (the plain version on the CPU) against jax.vjp of
    jnp.take: f32 within 1e-5 (sums of repeated ids in another order).  A
    bf16 table is the f32 sum of the bf16 gradients rounded once, so it is
    held to the f32 vjp of those gradients cast to bf16, within 1e-2 (JAX's
    own bf16 vjp rounds every add: 200 repeats of one id move it by 3%)."""
    rng = np.random.default_rng(len(case))
    n, num_src, d = {"duplicates": (400, 50, 32), "one row": (40, 1, 16),
                     "no ids": (0, 30, 32), "D=30": (300, 120, 30)}[case]
    ids = rng.integers(0, num_src, size=n).astype(np.int32)
    if case == "duplicates":
        ids[: n // 2] = ids[0]
    g = rng.normal(size=(n, d)).astype(np.float32)
    jdtype, tdtype = getattr(jnp, dtype), getattr(torch, dtype)
    g = np.array(jnp.asarray(g, dtype=jdtype), dtype=np.float32)
    _, vjp = jax.vjp(lambda s: jnp.take(s, jnp.asarray(ids), axis=0),
                     jnp.zeros((num_src, d), jnp.float32))
    want = np.asarray(jnp.asarray(vjp(jnp.asarray(g))[0], dtype=jdtype), dtype=np.float32)
    got = gk.scatter_add_rows(torch.from_numpy(g).to(tdtype), torch.from_numpy(ids), num_src)
    assert got.dtype == tdtype and tuple(got.shape) == (num_src, d)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2 * (np.abs(want).max() + 1))
    if case == "no ids":
        assert not got.any()


class _Recorder:
    """Stands in for the CUDA library: records each entry point's arguments
    and returns success without touching memory."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def recorded(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(gk, "_lib", lambda: rec)
    monkeypatch.setattr(gk, "_use_kernel", lambda *ts: True)
    monkeypatch.setattr(gk, "_stream", lambda dev: 0)
    monkeypatch.setattr(gk, "_sm_count", lambda dev: 132)
    gk.reset_launch_counts()
    yield rec
    gk.reset_launch_counts()


@pytest.mark.parametrize("fanout", [8, 25, 32, 48, 4096])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_reduce_takes_one_entry(recorded, fanout, dtype):
    """An unrolled fan-out runs the block forward with its self half
    absent; any other runs pg_window_reduce with window_plan's geometry;
    either is one launch under gather_reduce_<kind>."""
    rows, d = 10, 100
    src = torch.zeros((50, d), dtype=getattr(torch, dtype))
    pos = torch.zeros((rows, fanout), dtype=torch.int32)
    mask = torch.ones((rows, fanout), dtype=torch.bool)
    gk.gather_reduce(src, pos, mask, "max")
    ((name, args),) = recorded.calls
    key = "gather_reduce_max" + ("" if dtype == "float32" else "_bf16")
    assert {k: v for k, v in gk.LAUNCHES.items() if v} == {key: 1}
    if fanout in gk.UNROLLED_FANOUTS:
        assert name == "pg_block_gather_fwd"
        return
    assert name == "pg_window_reduce"
    plan = gk.window_plan(rows, fanout, d, bool(args[8]))
    assert args[3:5] == (rows, fanout) and args[10:14] == (plan.warps_log2, plan.lanes_log2,
                                                            plan.tile, plan.smem)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scatter_add_rows_is_one_launch(recorded, dtype):
    """One pg_scatter_add_rows call of scatter_grid CTAs: no memset entry
    and, at bf16, no grad_to_bf16 launch; an empty id list still writes the
    zeroed table (one launch)."""
    for n in (600, 0):
        recorded.calls.clear()
        gk.reset_launch_counts()
        g = torch.zeros((n, 32), dtype=getattr(torch, dtype))
        ids = torch.zeros(n, dtype=torch.int32)
        out = gk.scatter_add_rows(g, ids, 12_544)
        assert tuple(out.shape) == (12_544, 32) and out.dtype == g.dtype
        ((name, args),) = recorded.calls
        assert name == "pg_scatter_add_rows"
        assert args[2] == n and args[5:7] == (12_544, 32)
        assert (args[4] is None) == (dtype == "float32")     # the f32 scratch at bf16
        assert args[9] == gk.scatter_grid(n, 12_544, 32, bool(args[7]), 132)
        key = "scatter_add_rows" + ("" if dtype == "float32" else "_bf16")
        assert {k: v for k, v in gk.LAUNCHES.items() if v} == {key: 1}
