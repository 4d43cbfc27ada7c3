"""The port's gather kernels (plain versions, as run on the CPU) and block
aggregations against the JAX package.

On the CPU every wrapper of ``pagraph_tpu_torch.ops.gather_kernels`` runs its
plain version; the CUDA kernels are held against those same plain versions on
the card by ``chip_smoke.py``.  Here the plain versions and the autograd
Functions around them are held against the Pallas kernels in interpret mode,
``jnp.take``, ``pagraph_tpu.ops.aggregate`` and ``jax.vjp``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pagraph_tpu as pg
import pagraph_tpu_torch as pt
from pagraph_tpu.ops import aggregate as jagg
from pagraph_tpu.ops.pallas_gather import gather_mean_pallas, gather_rows_pallas
from pagraph_tpu.sampling.block import Block as JBlock
from pagraph_tpu.sampling.sampler import NeighborSampler as JSampler
from pagraph_tpu.storage import cache as jcache
from pagraph_tpu_torch.models import get_model
from pagraph_tpu_torch.ops import aggregate as tagg
from pagraph_tpu_torch.ops import gather_kernels as gk
from pagraph_tpu_torch.sampling.block import Block as TBlock
from pagraph_tpu_torch.sampling.block import MiniBatch as TMiniBatch


def _t(x):
    return torch.from_numpy(np.array(x))


def _tblock(b) -> TBlock:
    return TBlock(neigh_pos=np.asarray(b.neigh_pos), neigh_mask=np.asarray(b.neigh_mask),
                  self_pos=np.asarray(b.self_pos),
                  prefix_layout=b.prefix_layout).to("cpu")


@pytest.mark.parametrize("d", [128, 100, 32])
def test_gather_rows_matches_jax(d):
    """Exact: a gather copies values.  D=128 also runs the Pallas kernel
    (it needs 128-lane rows); D=100 and 32 are the main path's widths."""
    rng = np.random.default_rng(d)
    src = rng.normal(size=(500, d)).astype(np.float32)
    ids = rng.integers(0, 500, size=300).astype(np.int32)
    got = gk.gather_rows(_t(src), _t(ids)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.take(src, ids, axis=0)))
    if d % 128 == 0:
        want = gather_rows_pallas(jnp.asarray(src), jnp.asarray(ids), tile=64,
                                  interpret=True)
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("fanout", [2, 4])
def test_gather_mean_matches_pallas(fanout):
    """rtol 1e-5: the Pallas kernel sums the fan-out in its own order."""
    rng = np.random.default_rng(fanout)
    src = rng.normal(size=(400, 128)).astype(np.float32)
    pos = rng.integers(0, 400, size=(200, fanout)).astype(np.int32)
    mask = rng.random((200, fanout)) > 0.3
    want = gather_mean_pallas(jnp.asarray(src), jnp.asarray(pos), jnp.asarray(mask),
                              fanout=fanout, tile=64, interpret=True)
    got = gk.gather_reduce(_t(src), _t(pos), _t(mask), "mean").numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["mean", "sum"])
@pytest.mark.parametrize("d", [100, 32])
def test_gather_reduce_matches_formula(kind, d):
    """rtol 1e-6: float32 sums of at most 3 terms; empty rows give zeros."""
    rng = np.random.default_rng(7)
    src = rng.normal(size=(300, d)).astype(np.float32)
    pos = rng.integers(0, 300, size=(150, 3)).astype(np.int32)
    mask = rng.random((150, 3)) > 0.4
    mask[:5] = False
    want = (src[pos] * mask[..., None]).sum(1)
    if kind == "mean":
        want = want / np.maximum(mask.sum(1, keepdims=True), 1)
    got = gk.gather_reduce(_t(src), _t(pos), _t(mask), kind).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert not got[:5].any()


@pytest.fixture(scope="module")
def sampled(small_ds):
    cfg = pg.SamplerConfig(batch_size=64, fanout=3, num_hops=2, seed=3)
    s = JSampler(small_ds.graph, small_ds.train_nids, cfg, backend="numpy")
    return s.sample(small_ds.train_nids[:64])


@pytest.mark.parametrize("kind", ["mean", "sum"])
@pytest.mark.parametrize("bi", [0, 1])
def test_block_ops_match_jax(sampled, kind, bi):
    """Values and gradients of block_aggregate and block_self against the
    JAX functions and jax.grad on a host-sampled (non-prefix) block.
    rtol 1e-5 / atol 1e-6: float32 reassociation of short sums."""
    jb = jax.tree.map(np.asarray, sampled.blocks[bi])
    n_src = sampled.layer_nids[bi].shape[0]
    rng = np.random.default_rng(bi)
    h = rng.normal(size=(n_src, 24)).astype(np.float32)
    w_agg = rng.normal(size=(jb.neigh_pos.shape[0], 24)).astype(np.float32)
    w_self = rng.normal(size=(jb.neigh_pos.shape[0], 24)).astype(np.float32)

    def jloss(hh):
        a = jagg.block_aggregate(hh, jb, kind)
        s = jagg.block_self(hh, jb)
        return jnp.sum(a * w_agg) + jnp.sum(s * w_self), (a, s)

    (_, (ja, js)), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(h))
    th = _t(h).requires_grad_(True)
    tb = _tblock(jb)
    ta = tagg.block_aggregate(th, tb, kind)
    ts = tagg.block_self(th, tb)
    ((ta * _t(w_agg)).sum() + (ts * _t(w_self)).sum()).backward()
    np.testing.assert_allclose(ta.detach().numpy(), np.asarray(ja), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ts.detach().numpy(), np.asarray(js))
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["mean", "sum"])
def test_prefix_layout_matches_jax(kind):
    """Prefix layout: self rows and neighbor messages are contiguous slices."""
    rng = np.random.default_rng(11)
    n, f, d = 40, 3, 16
    h = rng.normal(size=(n + n * f, d)).astype(np.float32)
    mask = rng.random((n, f)) > 0.3
    jb = JBlock(neigh_pos=(n + np.arange(n * f, dtype=np.int32)).reshape(n, f),
                neigh_mask=mask, self_pos=np.arange(n, dtype=np.int32),
                prefix_layout=True)
    tb = _tblock(jb)
    np.testing.assert_allclose(
        tagg.block_aggregate(_t(h), tb, kind).numpy(),
        np.asarray(jagg.block_aggregate(jnp.asarray(h), jb, kind)), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tagg.block_self(_t(h), tb).numpy(),
                                  np.asarray(jagg.block_self(jnp.asarray(h), jb)))


@pytest.mark.parametrize("kind", ["mean", "sum"])
def test_backward_scatter_adds_match_vjp(kind):
    """The autograd Functions' backwards (plain scatter-adds on the CPU)
    against jax.vjp of jnp.take and of the masked reduction.  rtol 1e-5:
    scatter-adds sum repeated indices in another order."""
    rng = np.random.default_rng(5)
    src = rng.normal(size=(80, 20)).astype(np.float32)
    ids = rng.integers(0, 80, size=200).astype(np.int32)      # repeats
    pos = rng.integers(0, 80, size=(120, 4)).astype(np.int32)
    mask = rng.random((120, 4)) > 0.3
    g_rows = rng.normal(size=(200, 20)).astype(np.float32)
    g_red = rng.normal(size=(120, 20)).astype(np.float32)

    _, vjp_rows = jax.vjp(lambda s: jnp.take(s, ids, axis=0), jnp.asarray(src))
    jb = JBlock(neigh_pos=pos, neigh_mask=mask, self_pos=np.zeros(120, np.int32))
    _, vjp_red = jax.vjp(lambda s: jagg.block_aggregate(s, jb, kind), jnp.asarray(src))

    ts = _t(src).requires_grad_(True)
    gk.GatherRows.apply(ts, _t(ids)).backward(_t(g_rows))
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(vjp_rows(jnp.asarray(g_rows))[0]),
                               rtol=1e-5, atol=1e-6)
    ts.grad = None
    gk.GatherReduce.apply(ts, _t(pos), _t(mask), kind).backward(_t(g_red))
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(vjp_red(jnp.asarray(g_red))[0]),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["mean", "sum"])
@pytest.mark.parametrize("bi", [0, 1])
def test_block_gather_matches_jax(sampled, kind, bi):
    """block_gather's two outputs and its one fused backward against
    jax.value_and_grad of block_aggregate + block_self on a host-sampled
    block.  rtol 1e-5 / atol 1e-6: float32 sums run in another order."""
    jb = jax.tree.map(np.asarray, sampled.blocks[bi])
    n_src = sampled.layer_nids[bi].shape[0]
    rng = np.random.default_rng(10 + bi)
    h = rng.normal(size=(n_src, 24)).astype(np.float32)
    w_agg = rng.normal(size=(jb.neigh_pos.shape[0], 24)).astype(np.float32)
    w_self = rng.normal(size=(jb.neigh_pos.shape[0], 24)).astype(np.float32)

    def jloss(hh):
        a = jagg.block_aggregate(hh, jb, kind)
        s = jagg.block_self(hh, jb)
        return jnp.sum(a * w_agg) + jnp.sum(s * w_self), (a, s)

    (_, (ja, js)), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(h))
    th = _t(h).requires_grad_(True)
    ts, ta = tagg.block_gather(th, _tblock(jb), kind)
    ((ta * _t(w_agg)).sum() + (ts * _t(w_self)).sum()).backward()
    np.testing.assert_allclose(ta.detach().numpy(), np.asarray(ja), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ts.detach().numpy(), np.asarray(js))
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)


def _bwd_case(seed: int, d: int = 20, f: int = 3):
    """Self and neighbor positions that overlap and repeat, and 10 padded
    rows at the end (self_pos 0, no valid slot, zero gradient)."""
    rng = np.random.default_rng(seed)
    n_src, n = 60, 120
    self_pos = rng.integers(0, n_src, size=n).astype(np.int32)
    pos = rng.integers(0, n_src, size=(n, f)).astype(np.int32)
    pos[::2, 0] = self_pos[::2]                  # a row's neighbor is its self row
    mask = rng.random((n, f)) > 0.3
    g_self = rng.normal(size=(n, d)).astype(np.float32)
    g_neigh = rng.normal(size=(n, d)).astype(np.float32)
    self_pos[-10:], pos[-10:], mask[-10:] = 0, 0, False
    g_self[-10:], g_neigh[-10:] = 0.0, 0.0
    return n_src, d, self_pos, pos, mask, g_self, g_neigh


@pytest.mark.parametrize("kind", ["mean", "sum"])
@pytest.mark.parametrize("halves", ["both", "self", "neigh"])
def test_block_gather_bwd_plain_matches_vjp(kind, halves):
    """block_gather_bwd (the plain version on the CPU) against jax.vjp of
    (jnp.take, block_aggregate) with the absent half's cotangent zero, and
    BlockGather's backward when only the present half's output is used.
    rtol 1e-5: scatter-adds sum repeated indices in another order."""
    n_src, d, self_pos, pos, mask, g_self, g_neigh = _bwd_case(3)
    src = np.random.default_rng(4).normal(size=(n_src, d)).astype(np.float32)
    jb = JBlock(neigh_pos=pos, neigh_mask=mask, self_pos=self_pos)
    use_self, use_neigh = halves in ("both", "self"), halves in ("both", "neigh")
    _, vjp = jax.vjp(lambda s: (jagg.block_self(s, jb), jagg.block_aggregate(s, jb, kind)),
                     jnp.asarray(src))
    want = np.asarray(vjp((jnp.asarray(g_self if use_self else 0 * g_self),
                           jnp.asarray(g_neigh if use_neigh else 0 * g_neigh)))[0])
    gs, gn = (_t(g_self) if use_self else None), (_t(g_neigh) if use_neigh else None)
    for got in (gk.block_gather_bwd(gs, _t(self_pos), gn, _t(pos), _t(mask), n_src, kind),
                gk.block_gather_bwd_plain(gs, _t(self_pos), gn, _t(pos), _t(mask), n_src,
                                          kind)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    ts = _t(src).requires_grad_(True)
    h_self, h_neigh = gk.BlockGather.apply(ts, _t(self_pos), _t(pos), _t(mask), kind)
    loss = (h_self * gs).sum() if use_self else 0.0
    loss = loss + ((h_neigh * gn).sum() if use_neigh else 0.0)
    loss.backward()
    np.testing.assert_allclose(ts.grad.numpy(), want, rtol=1e-5, atol=1e-6)
    if halves == "self":
        np.testing.assert_allclose(gk.scatter_add_rows(gs, _t(self_pos), n_src).numpy(),
                                   want, rtol=1e-5, atol=1e-6)
    if halves == "neigh":
        np.testing.assert_allclose(
            gk.gather_reduce_bwd(gn, _t(pos), _t(mask), n_src, kind).numpy(),
            want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["mean", "sum"])
@pytest.mark.parametrize("halves", ["both", "self", "neigh"])
@pytest.mark.parametrize("d,fanout", [(100, 2), (32, 2), (30, 7)])
def test_block_gather_fwd_matches_jax(kind, halves, d, fanout):
    """block_gather_fwd against jnp.take and block_aggregate (on CPU
    tensors it runs its plain version, block_gather_fwd_plain), on
    overlapping and repeated positions, 10 padded rows and other rows with no
    valid slot; an absent half gives None.  The main path's widths (D = 100
    and 32 at fan-out 2), and D = 30 at fan-out 7 (the kernel's scalar and
    runtime-fan-out branches).  Self rows exact; neighbor rows rtol 1e-6 /
    atol 1e-6 (float32 sums of at most 7 terms in another order)."""
    n_src, _, self_pos, pos, mask, _, _ = _bwd_case(13, d, fanout)
    mask[20:25] = False
    src = np.random.default_rng(14).normal(size=(n_src, d)).astype(np.float32)
    jb = JBlock(neigh_pos=pos, neigh_mask=mask, self_pos=self_pos)
    want_self = np.asarray(jnp.take(jnp.asarray(src), self_pos, axis=0))
    want_neigh = np.asarray(jagg.block_aggregate(jnp.asarray(src), jb, kind))
    use_self, use_neigh = halves in ("both", "self"), halves in ("both", "neigh")
    sp = _t(self_pos) if use_self else None
    p, m = (_t(pos), _t(mask)) if use_neigh else (None, None)
    h_self, h_neigh = gk.block_gather_fwd(_t(src), sp, p, m, kind)
    if use_self:
        np.testing.assert_array_equal(h_self.numpy(), want_self)
    else:
        assert h_self is None
    if use_neigh:
        np.testing.assert_allclose(h_neigh.numpy(), want_neigh, rtol=1e-6, atol=1e-6)
        assert not h_neigh.numpy()[20:25].any()
    else:
        assert h_neigh is None


def test_block_gather_forward_is_one_block_gather_fwd_a_block(sampled, monkeypatch):
    """GraphSAGE's forward runs each block's two gathers through one
    block_gather_fwd call (one launch on the card), not gather_rows and
    gather_reduce."""
    calls = []
    real = gk.block_gather_fwd

    def counting(*args, **kwargs):
        calls.append(args[1].shape[0])
        return real(*args, **kwargs)

    def refuse(*args, **kwargs):
        raise AssertionError("a single-half gather ran on the main path")

    monkeypatch.setattr(gk, "block_gather_fwd", counting)
    monkeypatch.setattr(gk, "gather_rows", refuse)
    monkeypatch.setattr(gk, "gather_reduce", refuse)
    mb = jax.tree.map(np.asarray, sampled)
    tmb = TMiniBatch(layer_nids=tuple(mb.layer_nids), layer_mask=tuple(mb.layer_mask),
                     blocks=tuple(_tblock(b) for b in mb.blocks),
                     labels=mb.labels).to("cpu")
    model = get_model(pt.ModelConfig(arch="graphsage", n_layers=1, hidden=8,
                                     feat_dim=24, n_classes=5, dropout=0.0))
    feats = _t(np.random.default_rng(0).normal(
        size=(mb.layer_nids[0].shape[0], 24)).astype(np.float32)).requires_grad_(True)
    model(tmb, feats).sum().backward()
    assert calls == [b.self_pos.shape[0] for b in mb.blocks]
    assert feats.grad is not None


def test_launch_counters_have_the_fused_forward():
    """The fused forward's keys sit beside every other key (the assembly
    has one a cache tier, and one a tier for its bf16 output; each block
    kernel one for bf16 rows, and the bf16 backward's rounding launch one;
    and the max kind one a block kernel; the fused dropout block one a way
    and a kind, mean and sum; GAT's attention pair one a way, f32 only),
    and reset_launch_counts zeroes them all."""
    block = {"block_gather_fwd_mean", "block_gather_fwd_sum", "gather_rows",
             "scatter_add_rows", "gather_reduce_mean",
             "gather_reduce_sum", "gather_reduce_bwd_mean", "gather_reduce_bwd_sum",
             "block_gather_bwd_mean", "block_gather_bwd_sum",
             "block_gather_fwd_max", "block_gather_bwd_max", "gather_reduce_max",
             "gather_reduce_bwd_max", "dropout_block_fwd_mean", "dropout_block_fwd_sum",
             "dropout_block_bwd_mean", "dropout_block_bwd_sum"}
    assemble = {"assemble_f32", "assemble_bf16", "assemble_int8"}
    keys = block | {k + "_bf16" for k in block} | assemble | {k + "_to_bf16" for k in assemble}
    assert set(gk.LAUNCHES) == keys | {"grad_to_bf16", "gat_attention_fwd",
                                       "gat_attention_bwd"}
    gk.LAUNCHES["block_gather_fwd_mean"] += 1
    gk.reset_launch_counts()
    assert set(gk.launch_counts().values()) == {0}


@pytest.mark.parametrize("kind", ["mean", "sum"])
def test_block_gather_prefix_layout_matches_jax(kind):
    """Prefix layout through block_gather: contiguous slices, values and
    gradient against the JAX functions."""
    rng = np.random.default_rng(12)
    n, f, d = 40, 3, 16
    h = rng.normal(size=(n + n * f, d)).astype(np.float32)
    mask = rng.random((n, f)) > 0.3
    w = rng.normal(size=(2, n, d)).astype(np.float32)
    jb = JBlock(neigh_pos=(n + np.arange(n * f, dtype=np.int32)).reshape(n, f),
                neigh_mask=mask, self_pos=np.arange(n, dtype=np.int32),
                prefix_layout=True)

    def jloss(hh):
        s, a = jagg.block_self(hh, jb), jagg.block_aggregate(hh, jb, kind)
        return jnp.sum(s * w[0]) + jnp.sum(a * w[1]), (s, a)

    (_, (js, ja)), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(h))
    th = _t(h).requires_grad_(True)
    ts, ta = tagg.block_gather(th, _tblock(jb), kind)
    ((ts * _t(w[0])).sum() + (ta * _t(w[1])).sum()).backward()
    np.testing.assert_array_equal(ts.detach().numpy(), np.asarray(js))
    np.testing.assert_allclose(ta.detach().numpy(), np.asarray(ja), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)


def test_wrappers_refuse_bad_input():
    """An unknown kind raises at every entry; the max kind's backward
    without its source table raises (it finds the maxima there)."""
    src = torch.zeros(10, 4)
    pos = torch.zeros(3, 2, dtype=torch.int32)
    mask = torch.ones(3, 2, dtype=torch.bool)
    with pytest.raises(ValueError, match="kind"):
        tagg.block_aggregate(src, TBlock(pos, mask, pos[:, 0].contiguous()), "median")
    with pytest.raises(ValueError, match="kind"):
        tagg.block_gather(src, TBlock(pos, mask, pos[:, 0].contiguous()), "median")
    with pytest.raises(ValueError, match="source table"):
        gk.block_gather_bwd(None, None, torch.zeros(3, 4), pos, mask, 10, "max")
    with pytest.raises(ValueError):
        gk.gather_reduce(src, pos, mask, "median")
    with pytest.raises(ValueError):     # no incoming gradient at all
        gk.block_gather_bwd(None, None, None, None, None, 10, "mean")
    with pytest.raises(ValueError):     # no half to gather
        gk.block_gather_fwd(src, None, None, None, "mean")
    # neither CPU nor CUDA: no plain version, no kernel
    with pytest.raises(ValueError):
        gk.gather_rows(src.to("meta"), pos[:, 0].to("meta"))
    # the assembly: int8 needs its scale, f32 and bf16 take none, no f64 tier
    rows, scale = torch.zeros(3, dtype=torch.int32), torch.ones(4)
    with pytest.raises(ValueError):
        gk.assemble(src.to(torch.int8), rows, src[:0].to(torch.int8))
    with pytest.raises(ValueError):
        gk.assemble(src, rows, src[:0], scale)
    with pytest.raises(TypeError):
        gk.assemble(src.double(), rows, src[:0].double())


def _assemble_case(case: str, dtype: str, seed: int):
    """Cache and miss tables in a tier's dtype (the same values for JAX and
    the port), the JAX plan, and the port's one index a row: 10 padded rows
    at the end.  Cases: the main path's D = 100 and a scalar D = 30 with
    hits and misses mixed, no miss rows at all, every valid row a miss, and
    every valid row a hit beside a shipped miss bucket."""
    rng = np.random.default_rng(seed)
    d = 30 if case == "D=30" else 100
    n, cap, bucket = 300, 80, 0 if case == "no misses" else 512
    hit = {"all misses": np.zeros(n, bool), "all hits": np.ones(n, bool),
           "no misses": np.ones(n, bool)}.get(case, rng.random(n) < 0.6)
    valid = np.arange(n) < n - 10
    miss = ~hit & valid
    cache_pos = np.where(hit & valid, rng.integers(0, cap, n), 0).astype(np.int32)
    miss_slot = np.zeros(n, np.int32)
    miss_slot[miss] = np.arange(miss.sum(), dtype=np.int32)
    src_row = np.where(miss, -1 - miss_slot, cache_pos).astype(np.int32)
    if dtype == "int8":
        cv = rng.integers(-127, 128, size=(cap, d)).astype(np.int8)
        mf = rng.integers(-127, 128, size=(bucket, d)).astype(np.int8)
        scale = rng.random(d).astype(np.float32) / 127.0 + 1e-3
    else:
        cv = rng.normal(size=(cap, d)).astype(np.float32)
        mf = rng.normal(size=(bucket, d)).astype(np.float32)
        scale = None
    jplan = jcache.FetchPlan(hit_mask=jnp.asarray(hit & valid), cache_pos=jnp.asarray(cache_pos),
                             miss_slot=jnp.asarray(miss_slot), miss_feats=jnp.asarray(mf))
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}[dtype]
    jplan = dataclasses.replace(jplan, miss_feats=jplan.miss_feats.astype(jdt))
    want = jcache.dequantize_fused(jcache.assemble_features(jnp.asarray(cv).astype(jdt), jplan),
                                   scale)
    port = (_t(cv).to(tdt), _t(src_row), _t(mf).to(tdt),
            None if scale is None else _t(scale))
    return valid, np.asarray(want), port


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("case", ["D=100", "D=30", "no misses", "all misses", "all hits"])
def test_assemble_matches_jax(case, dtype):
    """assemble (its plain version on the CPU) against the JAX package's
    dequantize_fused(assemble_features(cache_values, plan), scale), exact on
    every valid row at every tier; f32 out; the launch counters untouched
    (the CPU runs no kernel)."""
    valid, want, (cv, src_row, mf, scale) = _assemble_case(case, dtype, seed=len(case))
    gk.reset_launch_counts()
    got = gk.assemble(cv, src_row, mf, scale)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy()[valid], want[valid])
    np.testing.assert_array_equal(gk.assemble_plain(cv, src_row, mf, scale).numpy(), got.numpy())
    assert set(gk.launch_counts().values()) == {0}
