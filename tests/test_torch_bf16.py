"""bf16 compute (``train.dtype="bfloat16"``) in the port against
``pagraph_tpu``, on CPU tensors.

The Pallas kernels compute at their source's dtype, and so do the port's
block kernels: on the CPU their plain versions run here on bf16 tensors, and
``chip_smoke.py`` holds the CUDA kernels against those plain versions on the
card.  Inputs are made with numpy from a seed and rounded to bf16 once, so
both packages see the same bf16 values.  Tolerances:

* gathered rows and the assembly to bf16: bit-equal (a copy, and the f32
  assembly rounded to nearest even, as ``cast_apply`` casts it);
* reductions and gradient tables: ``rtol=1e-2``, ``atol=1e-2 * max|ref|``
  (bf16 keeps 8 bits of mantissa, and the sums round in another order);
* one train step: the loss within 1e-2 relative and each parameter's
  gradient within ``||g - g_ref|| <= 2e-2 ||g_ref||``.  Parameters after
  Adam are not compared: a first Adam step moves every weight by about
  +-lr, so a sign flip of a near-zero bf16 gradient is a 2 x lr difference
  that means nothing;
* three host-path epochs in lockstep: epoch-mean losses within 3e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pagraph_tpu as pg
import pagraph_tpu_torch as pt
from pagraph_tpu.data.synthetic import synthetic_dataset as jsynthetic
from pagraph_tpu.models import get_model as jget_model
from pagraph_tpu.ops import aggregate as jagg
from pagraph_tpu.ops.gather import chunked_take
from pagraph_tpu.ops.pallas_gather import gather_mean_pallas, gather_rows_pallas
from pagraph_tpu.sampling.block import Block as JBlock
from pagraph_tpu.sampling.device_sampler import sample_minibatch_device
from pagraph_tpu.sampling.sampler import NeighborSampler as JSampler
from pagraph_tpu.storage import cache as jcache
from pagraph_tpu.train import state as jstate
from pagraph_tpu.train.device_epoch import _make_batch_body
from pagraph_tpu.train.loop import Trainer as JTrainer
from pagraph_tpu.train.objective import masked_cross_entropy
from pagraph_tpu_torch.convert import params_from_jax
from pagraph_tpu_torch.data.synthetic import synthetic_dataset as tsynthetic
from pagraph_tpu_torch.ops import aggregate as tagg
from pagraph_tpu_torch.ops import gather_kernels as gk
from pagraph_tpu_torch.ops.gather import take_rows
from pagraph_tpu_torch.sampling.block import Block as TBlock
from pagraph_tpu_torch.sampling.block import MiniBatch as TMiniBatch
from pagraph_tpu_torch.sampling.device_sampler import draw_width, hop_sizes
from pagraph_tpu_torch.train import device_epoch as tde
from pagraph_tpu_torch.train.loop import Trainer as TTrainer
from pagraph_tpu_torch.train.state import compute_dtype, train_step

BF16 = torch.bfloat16
TIERS = ("float32", "bfloat16", "int8")
DATA = dict(num_nodes=800, num_edges=6400, feat_dim=32, num_classes=6, seed=21,
            learnable=True)


def _bf16(x: np.ndarray):
    """The same bf16 values for both packages: ``(jax array, torch tensor)``."""
    j = jnp.asarray(x).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(BF16)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x) -> np.ndarray:
    """A bf16 (or f32) array or tensor as f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want) -> None:
    """``|got - want| <= 1e-2 |want| + 1e-2 max|want|``."""
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2 * max(np.abs(want).max(), 1e-30))


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _tblock(b) -> TBlock:
    return TBlock(neigh_pos=np.asarray(b.neigh_pos), neigh_mask=np.asarray(b.neigh_mask),
                  self_pos=np.asarray(b.self_pos), prefix_layout=b.prefix_layout).to("cpu")


def _port_mb(mb) -> TMiniBatch:
    a = np.asarray
    return TMiniBatch(layer_nids=tuple(a(x) for x in mb.layer_nids),
                      layer_mask=tuple(a(x) for x in mb.layer_mask),
                      blocks=tuple(_tblock(b) for b in mb.blocks),
                      labels=a(mb.labels)).to("cpu")


# -- the plain bf16 versions against the Pallas kernels ----------------------

@pytest.mark.parametrize("kind,fanout", [("mean", 2), ("mean", 5), ("sum", 3)])
def test_plain_bf16_gathers_match_pallas(kind, fanout):
    """gather_rows on bf16 against gather_rows_pallas (bit-equal: a copy);
    gather_reduce on bf16 against gather_mean_pallas (mean; the Pallas
    kernel has no sum kind, so sum against block_aggregate), both in
    interpret mode on bf16 input, within the bf16 tolerance."""
    rng = np.random.default_rng(fanout)
    js, ts = _bf16(rng.normal(size=(400, 128)).astype(np.float32))
    ids = rng.integers(0, 400, size=300).astype(np.int32)
    pos = rng.integers(0, 400, size=(200, fanout)).astype(np.int32)
    mask = rng.random((200, fanout)) > 0.3
    got_rows = gk.gather_rows(ts, _t(ids))
    want_rows = gather_rows_pallas(js, jnp.asarray(ids), tile=64, interpret=True)
    assert got_rows.dtype == BF16 and want_rows.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_bits(got_rows), _bits(want_rows))
    got = gk.gather_reduce(ts, _t(pos), _t(mask), kind)
    if kind == "mean":
        want = gather_mean_pallas(js, jnp.asarray(pos), jnp.asarray(mask), fanout=fanout,
                                  tile=64, interpret=True)
    else:
        want = jagg.block_aggregate(js, JBlock(neigh_pos=pos, neigh_mask=mask,
                                               self_pos=ids[:200]), kind)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    _close(got, want)


@pytest.fixture(scope="module")
def sampled(small_ds):
    cfg = pg.SamplerConfig(batch_size=64, fanout=3, num_hops=2, seed=3)
    s = JSampler(small_ds.graph, small_ds.train_nids, cfg, backend="numpy")
    return jax.tree.map(np.asarray, s.sample(small_ds.train_nids[:64]))


@pytest.mark.parametrize("kind", ["mean", "sum"])
@pytest.mark.parametrize("halves", ["both", "self", "neigh"])
@pytest.mark.parametrize("bi", [0, 1])
def test_block_gather_bf16_matches_vjp(sampled, kind, halves, bi):
    """A host-sampled block's gathers on bf16 rows: forward (block_gather
    and block_gather_fwd, with either half absent) and backward
    (BlockGather's, and block_gather_bwd with the absent half's gradient
    None) against block_self / block_aggregate under jax.vjp on bf16.  Self
    rows bit-equal; the neighbor reduction and the gradient table within the
    bf16 tolerance, in bf16."""
    jb = sampled.blocks[bi]
    n_src, n = sampled.layer_nids[bi].shape[0], jb.neigh_pos.shape[0]
    rng = np.random.default_rng(20 + bi)
    jh, th = _bf16(rng.normal(size=(n_src, 24)).astype(np.float32))
    (jgs, tgs), (jgn, tgn) = (_bf16(rng.normal(size=(n, 24)).astype(np.float32))
                              for _ in range(2))
    use_self, use_neigh = halves in ("both", "self"), halves in ("both", "neigh")
    (js, ja), vjp = jax.vjp(lambda s: (jagg.block_self(s, jb), jagg.block_aggregate(s, jb, kind)),
                            jh)
    (jgrad,) = vjp((jgs if use_self else jnp.zeros_like(jgs),
                    jgn if use_neigh else jnp.zeros_like(jgn)))
    tb = _tblock(jb)
    sp = tb.self_pos if use_self else None
    p, m = (tb.neigh_pos, tb.neigh_mask) if use_neigh else (None, None)
    h_self, h_neigh = gk.block_gather_fwd(th, sp, p, m, kind)
    if use_self:
        assert h_self.dtype == BF16
        np.testing.assert_array_equal(_bits(h_self), _bits(js))
    else:
        assert h_self is None
    if use_neigh:
        assert h_neigh.dtype == BF16
        _close(h_neigh, ja)
    else:
        assert h_neigh is None
    table = gk.block_gather_bwd(tgs if use_self else None, tb.self_pos,
                                tgn if use_neigh else None, tb.neigh_pos, tb.neigh_mask,
                                n_src, kind)
    assert table.dtype == BF16
    _close(table, jgrad)
    th = th.clone().requires_grad_(True)
    if halves == "both":
        ts, ta = tagg.block_gather(th, tb, kind)
    else:
        ts, ta = gk.BlockGather.apply(th, tb.self_pos, tb.neigh_pos, tb.neigh_mask, kind)
    loss = (ts * tgs).sum() if use_self else 0.0
    loss = loss + ((ta * tgn).sum() if use_neigh else 0.0)
    loss.backward()
    assert th.grad.dtype == BF16
    _close(th.grad, jgrad)


@pytest.mark.parametrize("kind", ["mean", "sum"])
@pytest.mark.parametrize("halves", ["both", "self", "neigh"])
def test_bf16_backward_adds_in_f32_and_rounds_once(kind, halves):
    """The bf16 gradient table is the f32 table of the widened gradients,
    rounded once (what the kernel computes: f32 reductions, then one
    rounding launch), bit for bit."""
    rng = np.random.default_rng(41)
    n_src, n, f, d = 30, 400, 4, 12
    g_self, g_neigh = (torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(BF16)
                       for _ in range(2))
    self_pos = _t(rng.integers(0, n_src, size=n).astype(np.int32))
    pos = _t(rng.integers(0, n_src, size=(n, f)).astype(np.int32))
    mask = _t(rng.random((n, f)) > 0.3)
    gs, gn = (g_self if halves != "neigh" else None), (g_neigh if halves != "self" else None)
    got = gk.block_gather_bwd(gs, self_pos, gn, pos, mask, n_src, kind)
    want = gk.block_gather_bwd(None if gs is None else gs.float(), self_pos,
                               None if gn is None else gn.float(), pos, mask, n_src, kind)
    assert got.dtype == BF16 and want.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got), _bits(want.to(BF16)))


@pytest.mark.parametrize("kind", ["mean", "sum"])
def test_prefix_layout_bf16_matches_jax(kind):
    """Prefix-layout blocks (the on-device path's) reduce slices in plain
    torch, in bf16."""
    rng = np.random.default_rng(31)
    n, f, d = 40, 3, 16
    jh, th = _bf16(rng.normal(size=(n + n * f, d)).astype(np.float32))
    mask = rng.random((n, f)) > 0.3
    jb = JBlock(neigh_pos=(n + np.arange(n * f, dtype=np.int32)).reshape(n, f),
                neigh_mask=mask, self_pos=np.arange(n, dtype=np.int32), prefix_layout=True)
    ts, ta = tagg.block_gather(th, _tblock(jb), kind)
    assert ts.dtype == ta.dtype == BF16
    np.testing.assert_array_equal(_bits(ts), _bits(jagg.block_self(jh, jb)))
    _close(ta, jagg.block_aggregate(jh, jb, kind))


# -- the assembly and the on-device fetch to bf16 --------------------------------

@pytest.mark.parametrize("dtype", TIERS)
@pytest.mark.parametrize("d", [100, 30])
def test_assemble_to_bf16_matches_jax(dtype, d):
    """assemble(out_dtype=bf16) and take_rows(out_dtype=bf16) against
    dequantize_fused(...).astype(bf16): bit-equal on every valid row at
    every tier; assemble_plain(...) to bf16 equals the f32 assembly cast."""
    rng = np.random.default_rng(d)
    n, cap, bucket = 300, 80, 512
    hit = rng.random(n) < 0.6
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
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}[dtype]
    jcv, jmf = jnp.asarray(cv).astype(jdt), jnp.asarray(mf).astype(jdt)
    plan = jcache.FetchPlan(hit_mask=jnp.asarray(hit & valid), cache_pos=jnp.asarray(cache_pos),
                            miss_slot=jnp.asarray(miss_slot), miss_feats=jmf)
    want = jcache.dequantize_fused(jcache.assemble_features(jcv, plan), scale).astype(jnp.bfloat16)
    tcv = torch.from_numpy(np.array(jcv.astype(jnp.float32))).to(
        {"float32": torch.float32, "bfloat16": BF16, "int8": torch.int8}[dtype])
    tmf = torch.from_numpy(np.array(jmf.astype(jnp.float32))).to(tcv.dtype)
    tsc = None if scale is None else _t(scale)
    gk.reset_launch_counts()
    got = gk.assemble(tcv, _t(src_row), tmf, tsc, out_dtype=BF16)
    assert got.dtype == BF16 and got.shape == (n, d)
    np.testing.assert_array_equal(_bits(got)[valid], _bits(want)[valid])
    np.testing.assert_array_equal(
        _bits(got), _bits(gk.assemble(tcv, _t(src_row), tmf, tsc).to(BF16)))
    ids = rng.integers(0, cap, size=200).astype(np.int32)
    want_full = jcache.dequantize_fused(chunked_take(jcv, jnp.asarray(ids)), scale)
    np.testing.assert_array_equal(_bits(take_rows(tcv, _t(ids), tsc, out_dtype=BF16)),
                                  _bits(want_full.astype(jnp.bfloat16)))
    assert set(gk.launch_counts().values()) == {0}       # the CPU runs no kernel


def test_bf16_wrappers_refuse_mixed_and_other_dtypes():
    """Every table of one call shares one dtype, f32 or bf16 (TypeError
    otherwise), on the CPU as on the card; the assembly writes f32 or
    bf16 only."""
    src = torch.zeros(10, 4)
    pos = torch.zeros(3, 2, dtype=torch.int32)
    mask = torch.ones(3, 2, dtype=torch.bool)
    g = torch.zeros(3, 4)
    with pytest.raises(TypeError):
        gk.block_gather_bwd(g, pos[:, 0].contiguous(), g.to(BF16), pos, mask, 10, "mean")
    with pytest.raises(TypeError):
        gk.block_gather_fwd(src.double(), pos[:, 0].contiguous(), pos, mask, "mean")
    with pytest.raises(TypeError):
        gk.gather_reduce(src.half(), pos, mask, "sum")
    with pytest.raises(TypeError):
        gk.assemble(src, pos[:, 0].contiguous(), src[:0], out_dtype=torch.float16)
    for t in (gk.block_gather_fwd(src.to(BF16), pos[:, 0].contiguous(), pos, mask, "mean")
              + (gk.block_gather_bwd(g.to(BF16), pos[:, 0].contiguous(), g.to(BF16), pos,
                                     mask, 10, "sum"),)):
        assert t.dtype == BF16


# -- one train step ---------------------------------------------------------------

def _cfgs(cache_dtype, on_device=False, capacity=None, paired=False, batch=128):
    kw = dict(
        model=dict(arch="graphsage", n_layers=1, hidden=16, feat_dim=32, n_classes=6,
                   aggregator="mean", dropout=0.0),
        sampler=dict(batch_size=batch, fanouts=(3, 2), num_hops=2, seed=7, auto_caps=False,
                     backend="numpy", paired_draws=paired),
        cache=dict(capacity=capacity, dtype=cache_dtype),
        train=dict(lr=1e-2, dtype="bfloat16", on_device_sampling=on_device,
                   steps_per_dispatch=1),
    )
    return tuple(mod.Config(model=mod.ModelConfig(**kw["model"]),
                            sampler=mod.SamplerConfig(**kw["sampler"]),
                            cache=mod.CacheConfig(**kw["cache"]),
                            train=mod.TrainConfig(**kw["train"]))
                 for mod in (pg, pt))


@pytest.fixture(scope="module")
def datasets():
    return jsynthetic(**DATA), tsynthetic(**DATA)


def _trainers(datasets, jcfg, tcfg):
    jds, tds = datasets
    jtr = JTrainer.from_dataset(jcfg, jds, seed=0)
    jtr._maybe_fill_cache()
    ttr = TTrainer.from_dataset(tcfg, tds, seed=0, device="cpu")
    ttr._maybe_fill_cache()
    ttr.state.model.load_state_dict(params_from_jax(jax.device_get(jtr.state.params)))
    return jtr, ttr


def _jax_loss_and_grads(jcfg, params, mb, feats):
    """Loss and gradients of the JAX package's bf16 step on ``feats`` (f32,
    as its steps hand them to cast_apply); dropout 0.  Compiled apart from
    the step, so its loss may round in other places than the step's: the
    port is held to both."""
    _, apply_fn = jget_model(jcfg.model)
    apply_fn = jstate.cast_apply(apply_fn, jstate.compute_dtype(jcfg))

    def loss_fn(p, mb, feats):
        logits = apply_fn(p, jcfg.model, mb, feats, train=True,
                          dropout_rng=jax.random.PRNGKey(0))
        assert logits.dtype == jnp.float32
        return masked_cross_entropy(logits, mb.labels, mb.seed_mask)

    return jax.jit(jax.value_and_grad(loss_fn))(params, mb, feats)


def _assert_step_close(ttr, loss, jloss, jgrads):
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-2)
    want = params_from_jax(jax.device_get(jgrads))
    for name, p in ttr.state.model.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, name   # master params stay f32
        g, w = p.grad.numpy(), want[name].numpy()
        assert np.linalg.norm(g - w) <= 2e-2 * np.linalg.norm(w), name


@pytest.mark.parametrize("cache_dtype", TIERS)
def test_train_step_bf16_matches_jax(datasets, cache_dtype):
    """One host-path train_step at bf16 compute and half the vertices
    cached against make_cached_train_step (its loss) and jax.grad of the
    same cast_apply step (its gradients), from the same parameters and
    MiniBatch; the assembly hands the model bf16 features."""
    jcfg, tcfg = _cfgs(cache_dtype, capacity=DATA["num_nodes"] // 2)
    jtr, ttr = _trainers(datasets, jcfg, tcfg)
    assert ttr.state.dtype == compute_dtype(tcfg) == BF16
    mb = jax.tree.map(np.asarray, jtr.sampler.sample(datasets[0].train_nids[:128]))
    nids, mask = np.asarray(mb.input_nids), np.asarray(mb.input_mask)
    jplan = jtr.cache.fetch_plan(nids, mask)
    step = jstate.make_cached_train_step(jcfg, jtr._tx, jtr.cache.field_offsets,
                                         jtr.cache.dequant_scale)
    _, jm = step(jtr.state, mb, jplan, jtr.cache.cache_values)
    feats = jcache.dequantize_fused(jcache.assemble_features(jtr.cache.cache_values, jplan),
                                    jtr.cache.dequant_scale)
    jloss, jgrads = _jax_loss_and_grads(jcfg, jtr.state.params, mb, feats)
    tplan = ttr.cache.fetch_plan(nids, mask)
    m = train_step(ttr.state, _port_mb(mb), tplan.miss_feats, _t(tplan.src_row),
                   ttr.cache.cache_values, ttr.cache.dequant_scale_dev)
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-2)
    _assert_step_close(ttr, m["loss"].item(), jloss, jgrads)
    assert ttr.state.step == 1


@pytest.mark.parametrize("cache_dtype,paired", [("float32", False), ("bfloat16", True),
                                                ("int8", True)])
def test_device_batch_step_bf16_matches_jax(datasets, cache_dtype, paired):
    """One on-device step at bf16 compute against _make_batch_body (its
    loss, edges and vertices) and jax.grad of the same cast_apply step on
    the same device-sampled batch (its gradients), with JAX's random
    integers handed to the port."""
    jcfg, tcfg = _cfgs(cache_dtype, on_device=True, paired=paired, batch=64)
    jtr, ttr = _trainers(datasets, jcfg, tcfg)
    jds = datasets[0]
    s = tcfg.sampler
    seeds = jds.train_nids[:64].astype(np.int32)
    smask = np.arange(64) < 55
    skey = jax.random.PRNGKey(13)
    body = _make_batch_body(jcfg, jtr._tx, jtr.cache.field_offsets,
                            jtr.cache.dequant_scale_padded)
    _, jacc = jax.jit(body)(jtr.state, jnp.zeros(5, jnp.float32), jnp.asarray(seeds),
                            jnp.asarray(smask), skey, jtr._dev_labels, jtr._dev_csr,
                            jtr.cache.cache_values)
    jmb = sample_minibatch_device(jtr._dev_csr, jnp.asarray(seeds), jnp.asarray(smask),
                                  s.num_hops, s.hop_fanouts(), skey, labels=jtr._dev_labels,
                                  paired=paired)
    feats = jcache.dequantize_fused(chunked_take(jtr.cache.cache_values, jmb.input_nids),
                                    jtr.cache.dequant_scale_padded)[:, :32]
    jloss, jgrads = _jax_loss_and_grads(jcfg, jtr.state.params, jmb, feats)
    want = dict(zip(tde.METRIC_NAMES, np.asarray(jacc).tolist()))
    keys = jax.random.split(skey, s.num_hops)
    draws = [_t(jax.random.randint(keys[h], (n, draw_width(f, paired)), 0,
                                   jnp.int32(2**31 - 1), dtype=jnp.int32))
             for h, (n, f) in enumerate(zip(hop_sizes(64, s.hop_fanouts()), s.hop_fanouts()))]
    step_in = (_t(seeds), _t(smask), draws, ttr._dev_labels, ttr._dev_csr,
               ttr.cache.cache_values, ttr.cache.dequant_scale_dev)
    assert tde.fetch_batch(tcfg, *step_in)[1].dtype == BF16
    acc = tde.EpochAccumulator.zeros("cpu")
    tde.device_batch_step(tcfg, ttr.state, acc, *step_in)
    got = acc.values()
    assert (got["edges"], got["vertices"]) == (want["edges"], want["vertices"])
    np.testing.assert_allclose(got["loss_sum"], want["loss_sum"], rtol=1e-2)
    _assert_step_close(ttr, got["loss_sum"], jloss, jgrads)


# -- three epochs in lockstep ---------------------------------------------------

@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_host_epochs_bf16_lockstep_with_jax(datasets, cache_dtype):
    """Three host-path epochs at bf16 compute, half the vertices cached,
    from the same parameters on the same batch stream: epoch-mean losses
    within 3e-2 of the JAX Trainer's and falling; miss rates and edges
    equal."""
    jcfg, tcfg = _cfgs(cache_dtype, capacity=DATA["num_nodes"] // 2)
    jtr, ttr = _trainers(datasets, jcfg, tcfg)
    jtr.train(3)
    ttr.train(3)
    for jm, tm in zip(jtr.epoch_metrics, ttr.epoch_metrics, strict=True):
        assert (tm.num_batches, tm.edges, tm.miss_rate) == (jm.num_batches, jm.edges,
                                                            jm.miss_rate)
        assert abs(tm.mean_loss - jm.mean_loss) < 3e-2, (tm.mean_loss, jm.mean_loss)
    losses = [m.mean_loss for m in ttr.epoch_metrics]
    assert losses[2] < losses[1] < losses[0], losses
