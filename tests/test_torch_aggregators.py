"""The pool (max) and lstm aggregators of the port against ``pagraph_tpu``.

* The max kind's plain versions (what the CPU runs; the card holds its
  kernels to them) against ``block_aggregate(kind="max")`` and its
  ``jax.vjp``, on ReLU'd inputs with many exact zeros (ties), repeated
  positions within a row and all-masked rows, on host-sampled and
  prefix-layout blocks, at f32 (values exact, gradients within 1e-6) and
  bf16 (values exact: a max does not round; gradients within 1e-2 of the
  larger, bf16 rounding the tie shares in other places).
* ``block_aggregate_lstm`` against JAX's, values and gradients within 1e-5.
* GraphSAGE with ``pool`` and ``lstm``, logits and gradients against
  ``jax.value_and_grad`` within 1e-5.
* Two lockstep Trainer epochs against JAX's, for pool and for lstm, on the
  host path at the JAX package's defaults and on the on-device path (the
  JAX random integers injected): losses and parameters within 1e-4 at f32,
  3e-2 at bf16 compute.  The max kind's gradient jumps where a ReLU'd
  input crosses 0 next to tied zeros (as mean's does at ReLU's kink), so a
  float32 reassociation that moves a pre-activation within ~1e-6 of 0
  across it sends one step's gradient elsewhere, and Adam carries that
  on: with trainer seed 3 the host path does so at its fourth step (1.5e-3
  apart after two epochs, while each step's gradient from equal parameters
  agrees within 1e-7).  The lockstep runs use seed 0, as the host-dispatch
  lockstep does; seeds 0-5 on both paths stay within 2.5e-6 but for that
  one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pagraph_tpu as pg
import pagraph_tpu_torch as pt
from pagraph_tpu.data.synthetic import synthetic_dataset as jsynthetic
from pagraph_tpu.models import sage as jsage
from pagraph_tpu.ops import aggregate as jagg
from pagraph_tpu.sampling.block import Block as JBlock
from pagraph_tpu.sampling.sampler import NeighborSampler as JSampler
from pagraph_tpu.train.loop import Trainer as JTrainer
from pagraph_tpu.train.objective import masked_cross_entropy as jxent
from pagraph_tpu_torch.convert import params_from_jax, params_to_jax
from pagraph_tpu_torch.data.synthetic import synthetic_dataset as tsynthetic
from pagraph_tpu_torch.models import get_model
from pagraph_tpu_torch.ops import aggregate as tagg
from pagraph_tpu_torch.ops import gather_kernels as gk
from pagraph_tpu_torch.sampling.block import Block as TBlock
from pagraph_tpu_torch.sampling.block import MiniBatch as TMiniBatch
from pagraph_tpu_torch.train import objective as tobj
from pagraph_tpu_torch.train.loop import Trainer as TTrainer

BF16 = torch.bfloat16


def _t(x):
    return torch.from_numpy(np.array(x))


def _blocks(layout, n=24, f=5, s=40, seed=0):
    """``(h [S, D] relu'd with many zeros, jax block, port block)``: a
    host-sampled block with repeated positions in rows and all-masked rows,
    or a prefix-layout one."""
    rng = np.random.default_rng(seed)
    mask = rng.random((n, f)) < 0.7
    mask[:3] = False                                   # all-masked rows
    if layout == "prefix":
        s = n + n * f
        pos = (n + np.arange(n * f)).reshape(n, f).astype(np.int32)
        self_pos = np.arange(n, dtype=np.int32)
    else:
        pos = rng.integers(0, s, size=(n, f)).astype(np.int32)
        pos[:, 1] = pos[:, 0]                          # a repeated position
        pos = np.where(mask, pos, 0).astype(np.int32)
        self_pos = rng.integers(0, s, size=n).astype(np.int32)
    h = np.maximum(rng.normal(size=(s, 12)), 0).astype(np.float32)
    h[rng.random(h.shape) < 0.3] = 0.0
    kw = dict(prefix_layout=layout == "prefix")
    return (h, JBlock(neigh_pos=pos, neigh_mask=mask, self_pos=self_pos, **kw),
            TBlock(pos, mask, self_pos, **kw).to("cpu"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["host", "prefix"])
def test_max_matches_jax_vjp(layout, dtype):
    """block_aggregate and the fused block_gather, kind max: values and the
    gradient (ties split equally) against jax.vjp."""
    h, jb, tb = _blocks(layout)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, BF16)
    g = np.random.default_rng(1).normal(size=(jb.neigh_pos.shape[0], 12)).astype(np.float32)
    jh = jnp.asarray(h, jdt)
    want, vjp = jax.vjp(lambda x: jagg.block_aggregate(x, jb, "max"), jh)
    (want_g,) = vjp(jnp.asarray(g, jdt))
    tol = 1e-6 if dtype == "float32" else 1e-2
    for fused in (False, True):
        th = _t(h).to(tdt).requires_grad_(True)
        got = tagg.block_gather(th, tb, "max")[1] if fused else tagg.block_aggregate(th, tb, "max")
        got.backward(_t(g).to(tdt))
        np.testing.assert_array_equal(got.detach().float().numpy(),
                                      np.asarray(want, np.float32))
        wg = np.asarray(want_g, np.float32)
        np.testing.assert_allclose(th.grad.float().numpy(), wg, rtol=0,
                                   atol=tol * max(1.0, np.abs(wg).max()))
    # the ties are there: several valid slots of one row reach a max of 0
    assert (np.asarray(want, np.float32)[3:] == 0).any()


def test_max_backward_plain_splits_ties():
    """A row [1, 1, 0.5] (max 1, tied twice) and a repeated position: the
    gradient is g / 2 at each tied slot, added twice at the repeated row."""
    src = torch.tensor([[1.0], [1.0], [0.5]])
    pos = torch.tensor([[0, 1, 2], [0, 0, 2]], dtype=torch.int32)
    mask = torch.ones(2, 3, dtype=torch.bool)
    got = gk.gather_reduce_bwd(torch.tensor([[1.0], [3.0]]), pos, mask, 3, "max", src)
    np.testing.assert_array_equal(got.numpy(), [[0.5 + 3.0], [0.5], [0.0]])
    with pytest.raises(ValueError, match="source table"):
        gk.gather_reduce_bwd(torch.ones(2, 1), pos, mask, 3, "max")


@pytest.mark.parametrize("layout", ["host", "prefix"])
def test_block_aggregate_lstm_matches_jax(layout):
    h, jb, tb = _blocks(layout, seed=2)
    jp = jax.device_get(jagg.init_lstm_params(jax.random.PRNGKey(0), 12, 12))
    g = np.random.default_rng(3).normal(size=(jb.neigh_pos.shape[0], 12)).astype(np.float32)

    def f(x, p):
        return jnp.sum(jagg.block_aggregate_lstm(x, jb, p) * g)

    want = jagg.block_aggregate_lstm(jnp.asarray(h), jb, jp)
    gh, gp = jax.grad(f, argnums=(0, 1))(jnp.asarray(h), jp)
    th = _t(h).requires_grad_(True)
    tp = {k: _t(v).requires_grad_(True) for k, v in jp.items()}
    got = tagg.block_aggregate_lstm(th, tb, tp)
    (got * _t(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(gh), rtol=1e-5, atol=1e-6)
    for k in tp:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(gp[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    init = tagg.init_lstm_params(12, 12, generator=torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in init.items()} == {k: v.shape for k, v in jp.items()}
    assert init["w_ih"].abs().max() <= 1 / np.sqrt(12) and not init["b"].any()


def _port_mb(mb) -> TMiniBatch:
    a = np.asarray
    return TMiniBatch(
        layer_nids=tuple(a(x) for x in mb.layer_nids),
        layer_mask=tuple(a(x) for x in mb.layer_mask),
        blocks=tuple(TBlock(a(b.neigh_pos), a(b.neigh_mask), a(b.self_pos)) for b in mb.blocks),
        labels=a(mb.labels)).to("cpu")


@pytest.mark.parametrize("agg,n_layers,preprocess", [("pool", 1, False), ("pool", 2, True),
                                                     ("lstm", 1, False), ("lstm", 2, True)])
def test_sage_logits_and_grads_match_jax(small_ds, agg, n_layers, preprocess):
    kw = dict(arch="graphsage", n_layers=n_layers, hidden=8, feat_dim=32, n_classes=10,
              aggregator=agg, dropout=0.0, preprocess=preprocess)
    jcfg, tcfg = pg.ModelConfig(**kw), pt.ModelConfig(**kw)
    scfg = pg.SamplerConfig(batch_size=48, fanout=3, num_hops=jcfg.num_sampled_hops, seed=2)
    s = JSampler(small_ds.graph, small_ds.train_nids, scfg, labels=small_ds.labels,
                 backend="numpy")
    mb = jax.tree.map(np.asarray, s.sample(small_ds.train_nids[:48]))
    rng = np.random.default_rng(n_layers)
    feats = np.maximum(rng.normal(scale=0.3, size=(mb.input_nids.shape[0], 32)), 0
                       ).astype(np.float32)
    neigh = rng.normal(scale=0.3, size=feats.shape).astype(np.float32) if preprocess else None
    jp = jsage.init_params(jax.random.PRNGKey(5), jcfg)

    def loss(p):
        logits = jsage.apply(p, jcfg, mb, jnp.asarray(feats), train=False,
                             neigh_feats=None if neigh is None else jnp.asarray(neigh))
        return jxent(logits, mb.labels, mb.seed_mask), logits

    (jl, jlogits), jg = jax.value_and_grad(loss, has_aux=True)(jp)
    model = get_model(tcfg)
    model.load_state_dict(params_from_jax(jax.device_get(jp)))
    tmb = _port_mb(mb)
    logits = model(tmb, _t(feats), neigh_feats=None if neigh is None else _t(neigh))
    tl = tobj.masked_cross_entropy(logits, tmb.labels, tmb.seed_mask)
    tl.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), rtol=1e-5,
                               atol=1e-5)
    assert abs(tl.item() - float(jl)) < 1e-5
    want = params_from_jax(jax.device_get(jg))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    assert set(params_to_jax(model.state_dict())) == set(jp)


DATA = dict(num_nodes=600, num_edges=4800, feat_dim=16, num_classes=5, seed=21,
            learnable=True)


@pytest.fixture(scope="module")
def datasets():
    return jsynthetic(**DATA), tsynthetic(**DATA)


def _cfgs(agg, device, compute="float32"):
    kw = dict(
        model=dict(arch="graphsage", n_layers=1, hidden=8, feat_dim=16, n_classes=5,
                   aggregator=agg, dropout=0.0),
        sampler=dict(batch_size=64, fanout=3, num_hops=2, seed=7),
        cache=dict(capacity=None if device else 300),
        train=dict(lr=1e-2, dtype=compute, on_device_sampling=device),
    )
    return tuple(mod.Config(model=mod.ModelConfig(**kw["model"]),
                            sampler=mod.SamplerConfig(**kw["sampler"]),
                            cache=mod.CacheConfig(**kw["cache"]),
                            train=mod.TrainConfig(**kw["train"]))
                 for mod in (pg, pt))


def _jax_epoch_randomness(cfg, seed, epoch, n_train):
    """The permutation and draws JAX's on-device Trainer derives (the
    helper of tests/test_torch_device_epoch.py)."""
    from tests.test_torch_device_epoch import _jax_epoch_randomness as f
    return f(seed, epoch, n_train, cfg)


def run_lockstep(jtr, ttr, epochs, tol):
    """Both trainers from JAX's parameters for ``epochs`` epochs: equal
    batches, losses and parameters within ``tol``; the loss falls."""
    ttr.state.model.load_state_dict(params_from_jax(jax.device_get(jtr.state.params)))
    if ttr.cfg.train.on_device_sampling:
        n_train = len(ttr._dev_train_nids)
        ttr.epoch_randomness = lambda e, out=None: _jax_epoch_randomness(
            ttr.cfg, 0, e, n_train)
    jtr.train(epochs)
    ttr.train(epochs)
    for jm, tm in zip(jtr.epoch_metrics, ttr.epoch_metrics, strict=True):
        assert (tm.num_batches, tm.edges, tm.vertices) == (jm.num_batches, jm.edges,
                                                             jm.vertices)
        assert tm.miss_rate == jm.miss_rate
        assert abs(tm.mean_loss - jm.mean_loss) < tol, (tm.mean_loss, jm.mean_loss)
    want = params_from_jax(jax.device_get(jtr.state.params))
    for name, p in ttr.state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0,
                                   atol=tol, err_msg=name)
    assert ttr.epoch_metrics[-1].mean_loss < ttr.epoch_metrics[0].mean_loss


@pytest.mark.parametrize("agg,device,compute,tol", [
    ("pool", False, "float32", 1e-4), ("pool", True, "float32", 1e-4),
    ("lstm", False, "float32", 1e-4), ("lstm", True, "float32", 1e-4),
    ("pool", False, "bfloat16", 3e-2)])
def test_trainer_lockstep_with_jax(datasets, agg, device, compute, tol):
    """Two epochs; the host path at the JAX defaults (native sampler,
    ``steps_per_dispatch=8``, ``auto_caps``), the device path with JAX's
    random integers injected."""
    jds, tds = datasets
    jcfg, tcfg = _cfgs(agg, device, compute)
    jtr = JTrainer.from_dataset(jcfg, jds, seed=0)
    ttr = TTrainer.from_dataset(tcfg, tds, seed=0, device="cpu")
    if not device:
        assert ttr.sampler.backend_name == "native" and ttr.steps_per_dispatch == 8
        assert ttr.sampler.caps == jtr.sampler.caps
    run_lockstep(jtr, ttr, 2, tol)
