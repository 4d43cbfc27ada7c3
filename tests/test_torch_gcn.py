"""The port's GCN against ``pagraph_tpu.models.gcn``, and the helpers that
``tests/test_torch_gin.py`` and ``test_torch_gat.py`` share.

* Forward and parameter gradients on one sampled ``MiniBatch`` (host
  layout, and the prefix layout the on-device sampler makes) against the
  JAX ``apply`` and ``jax.grad`` from the same parameters
  (``params_from_jax``): logits within 1e-5, gradients within 1e-4; with
  and without the skip, with and without preprocess (the ``dense`` layer),
  and the inference form (``norm_layers``: sum times the destination's
  norm).
* One host train step calls the wrappers the launch counts promise: the
  assembly, one ``gather_reduce`` (mean) a block, one ``gather_reduce_bwd``
  for each block whose source needs a gradient (not block 0's features).
* At bf16 compute (``cast_apply``), one step's gradients against JAX's
  from the same parameters: no farther apart than bf16 rounding moves
  either package's from the f32 gradient (:func:`check_bf16_grads`).
* Lockstep ``Trainer`` epochs against JAX's from the same parameters: the
  host path at the JAX package's defaults (native sampler, K = 8) and the
  on-device path (the JAX random integers injected), losses (and at f32
  parameters) within 1e-4 at f32 and losses within 3e-2 at bf16 compute
  (:func:`lockstep` says why bf16 parameters are not held), with and
  without preprocess (``from_dataset`` builds the store's ``gcn``
  aggregate, which replaces ``features``); at f32 ``train.eval_every``'s
  validation accuracies equal JAX's.
* ``full_graph_logits`` on both backends against the JAX package's host
  backend within 1e-4 of each row's largest logit, on a graph with a hub
  above ``f_cap`` and zero-degree vertices; ``evaluate`` equal.
* ``convert.py`` round trips of the GCN tree.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pagraph_tpu as pg
import pagraph_tpu_torch as pt
from pagraph_tpu.data.synthetic import synthetic_dataset as jsynthetic
from pagraph_tpu.models import gcn as jgcn
from pagraph_tpu.models import inference as jinf
from pagraph_tpu.sampling.block import Block as JBlock
from pagraph_tpu.sampling.block import MiniBatch as JMiniBatch
from pagraph_tpu.sampling.sampler import NeighborSampler as JSampler
from pagraph_tpu.train.loop import Trainer as JTrainer
from pagraph_tpu.train.state import cast_apply as jcast
from pagraph_tpu.train.objective import masked_cross_entropy as jxent
from pagraph_tpu_torch.convert import params_from_jax, params_to_jax
from pagraph_tpu_torch.data.synthetic import synthetic_dataset as tsynthetic
from pagraph_tpu_torch.models import get_model
from pagraph_tpu_torch.models import inference as tinf
from pagraph_tpu_torch.ops import gather_kernels as gk
from pagraph_tpu_torch.sampling.block import Block as TBlock
from pagraph_tpu_torch.sampling.block import MiniBatch as TMiniBatch
from pagraph_tpu_torch.train import objective as tobj
from pagraph_tpu_torch.train.loop import Trainer as TTrainer
from pagraph_tpu_torch.train.state import cast_apply as tcast
from pagraph_tpu_torch.train.state import create_state, train_step
from tests.test_torch_device_epoch import _jax_epoch_randomness
from tests.test_torch_inference import _assert_rows_close, _graph, _tgraph

FEAT, CLASSES = 16, 5


def _t(x):
    return torch.from_numpy(np.array(x))


def model_cfgs(arch, **kw):
    kw = {**dict(arch=arch, n_layers=1, hidden=16, feat_dim=FEAT, n_classes=10,
                 dropout=0.0), **kw}
    return pg.ModelConfig(**kw), pt.ModelConfig(**kw)


def sample_pair(ds, jcfg, layout, seed=2, batch=48, fanout=3):
    """``(jax MiniBatch, port MiniBatch, layer-0 features)``: one batch of
    the JAX numpy sampler over ``ds`` (``layout="host"``), or a batch of
    the prefix layout that the on-device sampler makes (layer i+1 the first
    rows of layer i, each block's neighbor slots the rows after them),
    random masks, some seeds padded."""
    a = np.asarray
    rng = np.random.default_rng(seed)
    hops = jcfg.num_sampled_hops
    if layout == "host":
        scfg = pg.SamplerConfig(batch_size=batch, fanout=fanout, num_hops=hops, seed=seed)
        s = JSampler(ds.graph, ds.train_nids, scfg, labels=ds.labels, backend="numpy")
        mb = jax.tree.map(np.asarray, s.sample(ds.train_nids[:batch]))
        nids, lmask = [a(x) for x in mb.layer_nids], [a(x) for x in mb.layer_mask]
        labels = a(mb.labels)
        blocks = [(a(b.neigh_pos), a(b.neigh_mask), a(b.self_pos)) for b in mb.blocks]
        kw = {}
    else:
        caps = [batch]
        for _ in range(hops):
            caps.insert(0, caps[0] * (1 + fanout))
        blocks = [((n + np.arange(n * fanout)).reshape(n, fanout).astype(np.int32),
                   rng.random((n, fanout)) < 0.7, np.arange(n, dtype=np.int32))
                  for n in caps[1:]]
        nids = [rng.integers(0, ds.num_nodes, c).astype(np.int32) for c in caps]
        lmask = [rng.random(c) < 0.9 for c in caps]
        labels = rng.integers(0, jcfg.n_classes, batch).astype(np.int32)
        kw = dict(prefix_layout=True)
    jmb = JMiniBatch(layer_nids=tuple(nids), layer_mask=tuple(lmask),
                     blocks=tuple(JBlock(neigh_pos=p, neigh_mask=m, self_pos=sp, **kw)
                                  for p, m, sp in blocks), labels=labels)
    tmb = TMiniBatch(layer_nids=tuple(nids), layer_mask=tuple(lmask),
                     blocks=tuple(TBlock(p, m, sp, **kw) for p, m, sp in blocks),
                     labels=labels).to("cpu")
    feats = rng.normal(scale=0.5, size=(len(nids[0]), jcfg.feat_dim)).astype(np.float32)
    return jmb, tmb, feats


def check_forward_and_grads(japply, jcfg, tcfg, jp, jmb, tmb, feats, **apply_kw):
    """Logits within 1e-5 and every parameter's gradient within 1e-4 of the
    JAX ``apply``'s and ``jax.grad``'s (the masked cross-entropy)."""
    tkw = {k: tuple(_t(x) for x in v) if isinstance(v, tuple) else v
           for k, v in apply_kw.items()}

    def loss(p):
        logits = japply(p, jcfg, jmb, jnp.asarray(feats), train=False, **apply_kw)
        return jxent(logits, jmb.labels, jmb.seed_mask), logits

    (jl, jlogits), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(jp)
    model = get_model(tcfg)
    model.load_state_dict(params_from_jax(jax.device_get(jp)))
    logits = model(tmb, _t(feats), **tkw)
    tl = tobj.masked_cross_entropy(logits, tmb.labels, tmb.seed_mask)
    tl.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), rtol=1e-5,
                               atol=1e-5)
    assert abs(tl.item() - float(jl)) < 1e-5
    want = params_from_jax(jax.device_get(jg))
    assert set(want) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def check_convert_round_trip(jp, tcfg):
    """JAX tree -> state_dict -> JAX tree: the same paths and values; the
    state_dict loads strictly into the port's model and back."""
    jp = jax.device_get(jp)
    sd = params_from_jax(jp)
    model = get_model(tcfg)
    model.load_state_dict(sd, strict=True)
    back = params_to_jax(model.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))
    fresh = get_model(tcfg, generator=torch.Generator().manual_seed(3))
    assert {k: tuple(v.shape) for k, v in fresh.state_dict().items()} == {
        k: tuple(v.shape) for k, v in sd.items()}


DATA = dict(num_nodes=600, num_edges=4800, feat_dim=FEAT, num_classes=CLASSES, seed=21,
            learnable=True)


@pytest.fixture(scope="module")
def datasets():
    return jsynthetic(**DATA), tsynthetic(**DATA)


def trainer_cfgs(model_kw, device=False, compute="float32", fanouts=(3, 2)):
    """The lockstep configuration: 600 vertices, batch 64, per-hop fan-outs
    ``fanouts``, lr 1e-2, dropout 0, the host evaluation after every epoch;
    the host path at the JAX package's defaults with the cache at half the
    vertices, the device path with all of them."""
    kw = dict(
        model={**dict(n_layers=1, hidden=16, feat_dim=FEAT, n_classes=CLASSES, dropout=0.0),
               **model_kw},
        sampler=dict(batch_size=64, fanouts=fanouts, num_hops=len(fanouts), seed=7),
        cache=dict(capacity=None if device else 300),
        train=dict(lr=1e-2, dtype=compute, on_device_sampling=device, eval_every=1,
                   eval_backend="host"),
    )
    return tuple(mod.Config(model=mod.ModelConfig(**kw["model"]),
                            sampler=mod.SamplerConfig(**kw["sampler"]),
                            cache=mod.CacheConfig(**kw["cache"]),
                            train=mod.TrainConfig(**kw["train"]))
                 for mod in (pg, pt))


def lockstep(datasets, model_kw, device, compute, tol, fanouts=(3, 2), epochs=2):
    """Both trainers from JAX's parameters for ``epochs`` epochs: equal
    batches, edges, vertices and miss rates, every epoch's loss within
    ``tol`` and the loss falling; at f32 every parameter within ``tol``
    and each epoch's ``val_acc`` (``train.eval_every``) equal too.  At
    bf16 compute the parameters are not held: one step's gradients from
    equal parameters agree within their own bf16 rounding
    (:func:`check_bf16_grads`), but Adam's normalized update turns such a
    difference on a near-zero gradient entry into a whole step of lr, so
    single entries drift apart over the epochs while the losses agree."""
    jds, tds = datasets
    jcfg, tcfg = trainer_cfgs(model_kw, device, compute, fanouts)
    jtr = JTrainer.from_dataset(jcfg, jds, seed=0)
    ttr = TTrainer.from_dataset(tcfg, tds, seed=0, device="cpu")
    if not device:
        assert ttr.sampler.backend_name == "native" and ttr.steps_per_dispatch == 8
        assert ttr.sampler.caps == jtr.sampler.caps
    ttr.state.model.load_state_dict(params_from_jax(jax.device_get(jtr.state.params)))
    if device:
        n_train = len(ttr._dev_train_nids)
        ttr.epoch_randomness = lambda e, out=None: _jax_epoch_randomness(0, e, n_train, tcfg)
    jtr.train(epochs)
    ttr.train(epochs)
    for jm, tm in zip(jtr.epoch_metrics, ttr.epoch_metrics, strict=True):
        assert (tm.num_batches, tm.edges, tm.vertices) == (jm.num_batches, jm.edges,
                                                             jm.vertices)
        assert tm.miss_rate == jm.miss_rate
        assert abs(tm.mean_loss - jm.mean_loss) < tol, (tm.mean_loss, jm.mean_loss)
    assert ttr.epoch_metrics[-1].mean_loss < ttr.epoch_metrics[0].mean_loss
    if compute == "float32":
        # train.eval_every: the same validation accuracy after every epoch
        got = [m.val_acc for m in ttr.epoch_metrics]
        assert got == [m.val_acc for m in jtr.epoch_metrics] and None not in got
        want = params_from_jax(jax.device_get(jtr.state.params))
        for name, p in ttr.state.model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0,
                                       atol=tol, err_msg=name)
    return jtr, ttr


def check_bf16_grads(japply, jcfg, tcfg, jp, jmb, tmb, feats):
    """One bf16-compute gradient (``cast_apply`` in both packages) against
    JAX's from the same parameters: each parameter's difference, relative to
    the norm of the f32 gradient, is no larger than 1.5 times the larger of
    the two packages' own bf16 errors (each bf16 gradient against the f32
    one), plus 1e-6."""
    def jloss(p, dtype):
        logits = jcast(japply, dtype)(p, jcfg, jmb, jnp.asarray(feats), train=False)
        return jxent(logits, jmb.labels, jmb.seed_mask)

    jg = {dt: params_from_jax(jax.device_get(jax.jit(jax.grad(jloss), static_argnums=1)(
        jp, dt))) for dt in (jnp.float32, jnp.bfloat16)}
    model = get_model(tcfg)
    model.load_state_dict(params_from_jax(jax.device_get(jp)))
    logits = tcast(model, torch.bfloat16)(tmb, _t(feats))
    assert logits.dtype == torch.float32
    tobj.masked_cross_entropy(logits, tmb.labels, tmb.seed_mask).backward()
    for name, p in model.named_parameters():
        exact = jg[jnp.float32][name]
        scale = float(exact.norm()) + 1e-30
        port_err = float((p.grad - exact).norm()) / scale
        jax_err = float((jg[jnp.bfloat16][name] - exact).norm()) / scale
        apart = float((p.grad - jg[jnp.bfloat16][name]).norm()) / scale
        assert apart <= 1.5 * max(port_err, jax_err) + 1e-6, (name, apart, port_err, jax_err)


WRAPPERS = ("assemble", "gather_rows", "gather_reduce", "block_gather_fwd",
            "scatter_add_rows", "gather_reduce_bwd", "block_gather_bwd")


def count_step_calls(datasets, model_kw, monkeypatch, compute="float32", fanouts=None):
    """The gather-kernel wrappers one host train step calls (on the CPU each
    runs its plain version; on the card each call is one launch); CV-GCN's
    step with the batch's (zero) history slices."""
    _, tds = datasets
    if fanouts is None:
        fanouts = (3, 2, 2) if model_kw.get("n_layers") == 2 else (3, 2)
    tcfg = trainer_cfgs(model_kw, compute=compute, fanouts=fanouts)[1]
    tr = TTrainer.from_dataset(tcfg, tds, seed=0, device="cpu")
    tr._maybe_fill_cache()
    mb = tr.sampler.sample(tr.sampler.train_nids[:64])
    plan = tr.cache.fetch_plan(mb.input_nids, mb.input_mask)
    calls = dict.fromkeys(WRAPPERS, 0)

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    from pagraph_tpu_torch.storage import cache as tcache
    for name in WRAPPERS:
        monkeypatch.setattr(gk, name, counted(name, getattr(gk, name)))
    monkeypatch.setattr(tcache, "assemble", gk.assemble)
    state = create_state(tcfg, seed=0, device="cpu")
    hists = tr.cv_history.gather(mb, "cpu") if tr.cv_history is not None else None
    m = train_step(state, mb.to("cpu"), plan.miss_feats, torch.from_numpy(plan.src_row),
                   tr.cache.cache_values, hists=hists)
    assert torch.isfinite(m["loss"])
    return {k: v for k, v in calls.items() if v}


# -- GCN ---------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["host", "prefix"])
@pytest.mark.parametrize("n_layers,skip,preprocess", [(1, True, False), (2, False, False),
                                                      (2, True, True), (1, True, True)])
def test_gcn_forward_and_grads_match_jax(small_ds, layout, n_layers, skip, preprocess):
    jcfg, tcfg = model_cfgs("gcn", n_layers=n_layers, skip_connection=skip,
                            preprocess=preprocess)
    jmb, tmb, feats = sample_pair(small_ds, jcfg, layout)
    jp = jgcn.init_params(jax.random.PRNGKey(5), jcfg)
    check_forward_and_grads(jgcn.apply, jcfg, tcfg, jp, jmb, tmb, feats)


@pytest.mark.parametrize("preprocess", [False, True])
def test_gcn_bf16_grads_within_bf16_rounding_of_jax(small_ds, preprocess):
    jcfg, tcfg = model_cfgs("gcn", n_layers=2, preprocess=preprocess)
    jmb, tmb, feats = sample_pair(small_ds, jcfg, "host")
    check_bf16_grads(jgcn.apply, jcfg, tcfg, jgcn.init_params(jax.random.PRNGKey(5), jcfg),
                     jmb, tmb, feats)


def test_gcn_inference_form_matches_jax(small_ds):
    """``norm_layers``: the sum times each destination's norm, no dropout."""
    jcfg, tcfg = model_cfgs("gcn", n_layers=2)
    jmb, tmb, feats = sample_pair(small_ds, jcfg, "host")
    rng = np.random.default_rng(9)
    norms = tuple(rng.uniform(0.1, 1.0, size=len(n)).astype(np.float32)
                  for n in jmb.layer_nids)
    jp = jgcn.init_params(jax.random.PRNGKey(6), jcfg)
    check_forward_and_grads(jgcn.apply, jcfg, tcfg, jp, jmb, tmb, feats, norm_layers=norms)


@pytest.mark.parametrize("preprocess", [False, True])
def test_gcn_convert_round_trip(preprocess):
    jcfg, tcfg = model_cfgs("gcn", n_layers=2, preprocess=preprocess)
    check_convert_round_trip(jgcn.init_params(jax.random.PRNGKey(1), jcfg), tcfg)


def test_gcn_host_step_calls(datasets, monkeypatch):
    """3 blocks: 1 assembly, 3 gather_reduce (mean), 2 gather_reduce_bwd."""
    calls = count_step_calls(datasets, dict(arch="gcn", n_layers=2), monkeypatch)
    assert calls == {"assemble": 1, "gather_reduce": 3, "gather_reduce_bwd": 2}


@pytest.mark.parametrize("device,compute,tol", [(False, "float32", 1e-4),
                                                (True, "float32", 1e-4),
                                                (False, "bfloat16", 3e-2),
                                                (True, "bfloat16", 3e-2)])
def test_gcn_trainer_lockstep_with_jax(datasets, device, compute, tol):
    lockstep(datasets, dict(arch="gcn"), device, compute, tol)


@pytest.mark.parametrize("device", [False, True])
def test_gcn_preprocess_trainer_lockstep_with_jax(datasets, device):
    """n_layers 2 under preprocess samples 2 hops; the store's features are
    the full-graph mean aggregate (equal to the JAX store's)."""
    jtr, ttr = lockstep(datasets, dict(arch="gcn", n_layers=2, preprocess=True), device,
                        "float32", 1e-4)
    assert list(ttr.store.fields) == list(jtr.store.fields)
    np.testing.assert_allclose(ttr.store.fields["features"], jtr.store.fields["features"],
                               rtol=1e-6, atol=1e-6)
    assert ttr.cache.field_names == ["features"]


@pytest.fixture(scope="module")
def hub_graph():
    g = _graph(4400, 15000, 4200, seed=3)
    x = np.random.default_rng(4).normal(size=(4400, 12)).astype(np.float32)
    return g, x


def check_full_graph(init, jcfg, tcfg, g, x, jax_device=True):
    """Both of the port's backends against the JAX package's host backend,
    and (``jax_device``) its device backend; ``evaluate`` equal."""
    jp = jax.device_get(init(jax.random.PRNGKey(7), jcfg))
    model = get_model(tcfg)
    model.load_state_dict(params_from_jax(jp))
    want = np.asarray(jinf.full_graph_logits(jp, jcfg, g, x, backend="host"))
    tg = _tgraph(g)
    for backend in ("host", "device"):
        got = tinf.full_graph_logits(model, tcfg, tg, x, backend=backend)
        assert got.shape == want.shape and got.dtype == np.float32
        _assert_rows_close(got, want, backend)
    if jax_device:
        _assert_rows_close(got, np.asarray(jinf.full_graph_logits(jp, jcfg, g, x,
                                                                   backend="device")),
                           "jax device")
    labels = np.random.default_rng(5).integers(0, jcfg.n_classes, g.num_nodes)
    mask = np.random.default_rng(6).random(g.num_nodes) < 0.3
    acc = jinf.evaluate(jp, jcfg, g, x, labels, mask, backend="host")
    assert tinf.evaluate(model, tcfg, tg, x, labels, mask, backend="device") == acc


@pytest.mark.parametrize("skip,preprocess", [(True, False), (False, True)])
def test_gcn_full_graph_logits_match_jax(hub_graph, skip, preprocess):
    g, x = hub_graph
    kw = dict(arch="gcn", n_layers=2, hidden=8, feat_dim=12, n_classes=5, dropout=0.0,
              skip_connection=skip, preprocess=preprocess)
    check_full_graph(jgcn.init_params, pg.ModelConfig(**kw), pt.ModelConfig(**kw), g, x)


def check_resume(datasets, model_kw, device, tmp_path, dispatch="scan"):
    """Two epochs (dropout 0.5) with a checkpoint after each, against a fresh
    Trainer resumed from epoch 0's and run for epoch 1: every tensor of the
    train state, the dropout generator and the losses equal bit for bit."""
    from tests.test_torch_checkpoint import _snapshot

    _, tds = datasets
    tcfg = trainer_cfgs({**model_kw, "dropout": 0.5}, device)[1]
    tcfg.train.ckpt_dir, tcfg.train.ckpt_every = str(tmp_path), 1
    if device:
        tcfg.train.epoch_dispatch = dispatch
    a = TTrainer.from_dataset(tcfg, tds, seed=2, device="cpu")
    a.train(2)
    b = TTrainer.from_dataset(tcfg, tds, seed=2, device="cpu")
    assert b.resume(epoch=0) == 1
    b.train(2, start_epoch=1)
    (ta, ga, la), (tb, gb, lb) = _snapshot(a), _snapshot(b)
    assert set(ta) == set(tb)
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k
    assert torch.equal(ga, gb) and la[1:] == lb
