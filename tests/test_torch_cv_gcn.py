"""The port's CV-GCN against ``pagraph_tpu``'s, on the same numpy inputs.

* ``apply``: logits, fresh histories and parameter gradients against
  ``jax.value_and_grad`` of ``gcn_cv.apply`` with random nonzero histories,
  1-3 layers: f32 within 1e-5; bf16 compute (``cast_cv_apply`` in both
  packages) within 3e-2 of each output's scale.  Zero histories give the
  plain mean aggregation of a preprocess GCN.
* ``CVHistory``'s gather, scatter and refresh against the JAX class: equal
  slices and histories, aggregates within 1e-6 (the host SpMM's order).
* Lockstep Trainers for 2 epochs at dropout 0 from JAX's parameters: the
  host path (the numpy sampler on both sides, so the batches are the same)
  and the on-device path (JAX's random integers injected): losses within
  1e-4, histories and aggregates within 1e-5.
* The device path's history scatter: the last occurrence of a repeated id
  in a layer wins, masked rows go nowhere; the JAX package's
  ``.at[ids].set(mode="drop")`` gives the same on the CPU, so the lockstep
  compares every row.
* ``steps`` and ``pipelined`` refuse gcn_cv with the JAX package's
  ``ValueError``; a resume with the ``.aux`` sidecar equals the
  uninterrupted run, one without it warns and zeroes the histories.
* ``full_graph_logits`` for gcn_cv on both backends against the JAX
  package's host backend within 1e-4 of each row's largest logit.
"""
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pagraph_tpu as pg
import pagraph_tpu_torch as pt
from pagraph_tpu.data.synthetic import synthetic_dataset as jsynthetic
from pagraph_tpu.models import gcn_cv as jcv
from pagraph_tpu.models import inference as jinf
from pagraph_tpu.train.loop import Trainer as JTrainer
from pagraph_tpu.train.objective import masked_cross_entropy as jxent
from pagraph_tpu.train.state import cast_cv_apply as jcast_cv
from pagraph_tpu_torch.convert import params_from_jax
from pagraph_tpu_torch.data.synthetic import synthetic_dataset as tsynthetic
from pagraph_tpu_torch.models import gcn_cv as tcv
from pagraph_tpu_torch.models import get_model
from pagraph_tpu_torch.models import inference as tinf
from pagraph_tpu_torch.train import objective as tobj
from pagraph_tpu_torch.train.device_epoch import scatter_last
from pagraph_tpu_torch.train.loop import Trainer as TTrainer
from pagraph_tpu_torch.train.state import cast_cv_apply as tcast_cv
from tests.test_torch_device_epoch import _jax_epoch_randomness
from tests.test_torch_gcn import (check_convert_round_trip, count_step_calls, model_cfgs,
                                  sample_pair)
from tests.test_torch_inference import _assert_rows_close, _graph, _tgraph

FEAT, CLASSES = 16, 5
DATA = dict(num_nodes=500, num_edges=4000, feat_dim=FEAT, num_classes=CLASSES, seed=21,
            learnable=True)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def datasets():
    return jsynthetic(**DATA), tsynthetic(**DATA)


def cv_cfgs(n_layers=2, device=False, compute="float32", dispatch="scan", **train_kw):
    """gcn_cv at hidden 12, batch 64, fan-out 2 (``n_layers`` hops), the
    numpy sampler on the host path (the JAX package's host CV path takes
    unpacked numpy batches), dropout 0, lr 1e-2."""
    out = []
    for mod in (pg, pt):
        m = mod.ModelConfig(arch="gcn_cv", n_layers=n_layers, hidden=12, feat_dim=FEAT,
                            n_classes=CLASSES, preprocess=True, dropout=0.0)
        out.append(mod.Config(
            model=m,
            sampler=mod.SamplerConfig(batch_size=64, fanout=2, num_hops=n_layers, seed=7,
                                      backend="numpy"),
            cache=mod.CacheConfig(capacity=None if device else 250),
            train=mod.TrainConfig(lr=1e-2, dtype=compute, on_device_sampling=device,
                                  epoch_dispatch=dispatch, **train_kw)))
    return tuple(out)


def _histories(jmb, widths, seed):
    """Random nonzero ``(h_hist, agg_hist)`` at the batch's layers."""
    rng = np.random.default_rng(seed)
    h = [rng.normal(size=(len(jmb.layer_nids[b]), w)).astype(np.float32)
         for b, w in enumerate(widths)]
    a = [rng.normal(size=(len(jmb.layer_nids[b + 1]), w)).astype(np.float32)
         for b, w in enumerate(widths)]
    return h, a


def _jax_value_and_grad(japply, jcfg, jp, jmb, feats, h, a):
    def loss(p):
        logits, new = japply(p, jcfg, jmb, jnp.asarray(feats), train=False,
                             dropout_rng=None, h_hist=[jnp.asarray(x) for x in h],
                             agg_hist=[jnp.asarray(x) for x in a])
        return jxent(logits, jmb.labels, jmb.seed_mask), (logits, new)

    (jl, (jlogits, jnew)), jg = jax.value_and_grad(loss, has_aux=True)(jp)
    return float(jl), np.asarray(jlogits), [np.asarray(x) for x in jnew], \
        params_from_jax(jax.device_get(jg))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_layers", [1, 2, 3])
def test_cv_apply_and_grads_match_jax(small_ds, n_layers, dtype):
    """Logits, fresh histories and every parameter's gradient from the same
    parameters, batch and random histories: f32 within 1e-5; at bf16
    compute the logits and histories within 3e-2 of each output's largest
    magnitude and the gradients within bf16 rounding of JAX's."""
    jcfg, tcfg = model_cfgs("gcn_cv", n_layers=n_layers, preprocess=True)
    jmb, tmb, feats = sample_pair(small_ds, jcfg, "host")
    h, a = _histories(jmb, jcv.layer_widths(jcfg), seed=n_layers)
    jp = jcv.init_params(jax.random.PRNGKey(5), jcfg)
    japply = jcv.apply if dtype == "float32" else jcast_cv(jcv.apply, jnp.bfloat16)
    jl, jlogits, jnew, jg = _jax_value_and_grad(japply, jcfg, jp, jmb, feats, h, a)
    model = get_model(tcfg)
    model.load_state_dict(params_from_jax(jax.device_get(jp)))
    tapply = tcast_cv(model, torch.float32 if dtype == "float32" else torch.bfloat16)
    logits, new = tapply(tmb, _t(feats), h_hist=[_t(x) for x in h],
                         agg_hist=[_t(x) for x in a])
    assert logits.dtype == torch.float32 and all(x.dtype == torch.float32 for x in new)
    assert not any(x.requires_grad for x in new)
    loss = tobj.masked_cross_entropy(logits, tmb.labels, tmb.seed_mask)
    loss.backward()
    tol = 1e-5 if dtype == "float32" else 3e-2

    def close(got, want, name):
        scale = 1.0 if dtype == "float32" else float(np.abs(want).max()) + 1e-30
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale, err_msg=name)

    close(logits.detach().numpy(), jlogits, "logits")
    assert abs(loss.item() - jl) <= tol * max(1.0, abs(jl))
    assert len(new) == n_layers
    for b, (x, y) in enumerate(zip(new, jnew, strict=True)):
        close(x.numpy(), y, f"new_hists[{b}]")
    assert set(jg) == {n for n, _ in model.named_parameters()}
    if dtype == "float32":
        for name, p in model.named_parameters():
            close(p.grad.numpy(), jg[name].numpy(), name)
        return
    # bf16 gradients: each package's rounding moves them from the f32
    # gradient by up to several percent of its norm (the wide reductions
    # of dense.w); the two packages' are no farther apart than 1.5 times
    # the larger of those moves (tests/test_torch_gcn.py check_bf16_grads)
    exact = _jax_value_and_grad(jcv.apply, jcfg, jp, jmb, feats, h, a)[3]
    for name, p in model.named_parameters():
        scale = float(exact[name].norm()) + 1e-30
        port_err = float((p.grad - exact[name]).norm()) / scale
        jax_err = float((jg[name] - exact[name]).norm()) / scale
        apart = float((p.grad - jg[name]).norm()) / scale
        assert apart <= 1.5 * max(port_err, jax_err) + 1e-6, (name, apart, port_err, jax_err)


@pytest.mark.parametrize("n_layers", [1, 2])
def test_zero_histories_equal_plain_mean_aggregation(small_ds, n_layers):
    """With zero histories the control variate vanishes: the logits are a
    preprocess GCN's with the mean aggregation of the raw activations (and
    the output layer's doubled width)."""
    jcfg, tcfg = model_cfgs("gcn_cv", n_layers=n_layers, preprocess=True)
    _, tmb, feats = sample_pair(small_ds, jcfg, "host")
    model = get_model(tcfg)
    widths = tcv.layer_widths(tcfg)
    h = [torch.zeros(len(tmb.layer_nids[b]), w) for b, w in enumerate(widths)]
    a = [torch.zeros(len(tmb.layer_nids[b + 1]), w) for b, w in enumerate(widths)]
    with torch.no_grad():
        logits, _ = model(tmb, _t(feats), h_hist=h, agg_hist=a)
        gcn = get_model(pt.ModelConfig(**{**tcfg.__dict__, "arch": "gcn",
                                          "skip_connection": True}))
        gcn.load_state_dict(model.state_dict())
        want = gcn(tmb, _t(feats))
    np.testing.assert_allclose(logits.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_cv_history_matches_jax(datasets):
    """``CVHistory`` against the JAX class: gather equal, scatter equal,
    refresh (the host library's SpMM against scipy's in JAX) within 1e-6."""
    jds, tds = datasets
    jcfg, tcfg = cv_cfgs()
    jh = jcv.CVHistory(jcfg.model, jds.graph, jds.num_nodes)
    th = tcv.CVHistory(tcfg.model, tds.graph, tds.num_nodes)
    jmb, tmb, _ = sample_pair(jds, jcfg.model, "host", batch=32, fanout=2)
    rng = np.random.default_rng(3)
    new = [rng.normal(size=(len(jmb.layer_nids[b]), w)).astype(np.float32)
           for b, w in enumerate(th.widths)]
    jh.scatter(jmb, [jnp.asarray(x) for x in new])
    th.scatter(tmb, [_t(x) for x in new])
    for b in range(2):
        np.testing.assert_array_equal(th.hist[b], jh.hist[b])
    assert np.abs(th.hist[0]).sum() > 0
    jh.refresh_agg()
    th.refresh_agg()
    for b in range(2):
        np.testing.assert_allclose(th.agg[b], jh.agg[b], rtol=1e-6, atol=1e-6)
    (jg_h, jg_a), (tg_h, tg_a) = jh.gather(jmb), th.gather(tmb, "cpu")
    for x, y in zip(tg_h + tg_a, jg_h + jg_a, strict=True):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6, atol=1e-6)


def _cv_state(tr):
    """Histories and aggregates of either path as numpy ``[N, w]`` arrays."""
    aux = tr._cv_aux()
    return [np.asarray(torch.as_tensor(x).detach().cpu()) for x in aux["hist"] + aux["agg"]]


def _jax_cv_state(jtr):
    if jtr._device_mode:
        return [np.asarray(x) for x in (*jtr._dev_hists, *jtr._dev_aggs)]
    return jtr.cv_history.hist + jtr.cv_history.agg


@pytest.mark.parametrize("device", [False, True])
def test_cv_trainer_lockstep_with_jax(datasets, device):
    """Two epochs of both Trainers from JAX's parameters (the host path on
    the same numpy batches, the device path on JAX's random integers):
    equal batches, edges and miss rates, losses within 1e-4, histories and
    aggregates within 1e-5, and the loss falling."""
    jds, tds = datasets
    jcfg, tcfg = cv_cfgs(device=device)
    jtr = JTrainer.from_dataset(jcfg, jds, seed=0)
    ttr = TTrainer.from_dataset(tcfg, tds, seed=0, device="cpu")
    ttr.state.model.load_state_dict(params_from_jax(jax.device_get(jtr.state.params)))
    if device:
        n_train = len(tds.train_nids)
        ttr.epoch_randomness = lambda e, out=None: _jax_epoch_randomness(0, e, n_train, tcfg)
    jtr.train(2)
    ttr.train(2)
    for jm, tm in zip(jtr.epoch_metrics, ttr.epoch_metrics, strict=True):
        assert (tm.num_batches, tm.edges, tm.vertices) == (jm.num_batches, jm.edges,
                                                             jm.vertices)
        assert tm.miss_rate == jm.miss_rate
        assert abs(tm.mean_loss - jm.mean_loss) < 1e-4, (tm.mean_loss, jm.mean_loss)
    assert ttr.epoch_metrics[1].mean_loss < ttr.epoch_metrics[0].mean_loss
    for got, want in zip(_cv_state(ttr), _jax_cv_state(jtr), strict=True):
        assert np.abs(want).sum() > 0
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if not device:
        assert "cv-refresh" in ttr.timers.total


def test_scatter_last_rule():
    """Of the valid positions that hold one id, the last one's row is
    written; masked positions write nothing but the spare row.  The JAX
    package's ``hists.at[where(mask, ids, N)].set(v, mode="drop")`` gives
    the same rows on the CPU; the rule holds on repeated calls too."""
    rng = np.random.default_rng(0)
    n, cap, w = 40, 300, 3
    ids = rng.integers(0, n, cap).astype(np.int32)
    mask = rng.random(cap) < 0.8
    vals = rng.normal(size=(cap, w)).astype(np.float32)
    table = torch.full((n + 1, w), 7.0)
    scatter_last(table, _t(ids), _t(mask), _t(vals))
    want = np.full((n, w), 7.0, np.float32)
    for i in range(cap):
        if mask[i]:
            want[ids[i]] = vals[i]
    np.testing.assert_array_equal(table[:n].numpy(), want)
    jout = jnp.full((n, w), 7.0).at[np.where(mask, ids, n)].set(vals, mode="drop")
    np.testing.assert_array_equal(np.asarray(jout), want)
    again = torch.full((n + 1, w), 7.0)
    scatter_last(again, _t(ids), _t(mask), _t(vals))
    assert torch.equal(again[:n], table[:n])


@pytest.mark.parametrize("dispatch", ["steps", "pipelined"])
def test_cv_per_step_dispatch_modes_raise(datasets, dispatch):
    _, tds = datasets
    tcfg = cv_cfgs(device=True, dispatch=dispatch)[1]
    with pytest.raises(ValueError, match="does not support gcn_cv"):
        TTrainer.from_dataset(tcfg, tds, seed=0, device="cpu")


@pytest.mark.parametrize("device", [False, True])
def test_cv_resume_with_aux_equals_uninterrupted(tmp_path, datasets, device):
    """A run resumed from epoch 0's checkpoint (train state, sampler state
    and the ``.aux`` histories) equals the uninterrupted run at epoch 1:
    loss, parameters, histories and aggregates, bit for bit on the CPU."""
    _, tds = datasets
    tcfg = cv_cfgs(device=device, ckpt_dir=str(tmp_path), ckpt_every=1)[1]
    full = TTrainer.from_dataset(tcfg, tds, seed=0, device="cpu")
    full.train(2)
    aux = os.path.join(str(tmp_path), "gcn_cv_0.aux")
    assert os.path.isfile(aux)
    resumed = TTrainer.from_dataset(tcfg, tds, seed=0, device="cpu")
    start = resumed.resume(0)
    assert start == 1
    resumed.train(2, start_epoch=start)
    assert resumed.epoch_metrics[-1].mean_loss == full.epoch_metrics[-1].mean_loss
    for (name, p), q in zip(full.state.model.named_parameters(),
                            resumed.state.model.parameters()):
        assert torch.equal(p, q), name
    for got, want in zip(_cv_state(resumed), _cv_state(full), strict=True):
        np.testing.assert_array_equal(got, want)


def test_cv_resume_missing_aux_warns(tmp_path, datasets):
    """A checkpoint without the sidecar resumes with zero histories and a
    ``RuntimeWarning``, as the JAX package's does."""
    _, tds = datasets
    tcfg = cv_cfgs(ckpt_dir=str(tmp_path), ckpt_every=1)[1]
    TTrainer.from_dataset(tcfg, tds, seed=0, device="cpu").train(1)
    os.remove(os.path.join(str(tmp_path), "gcn_cv_0.aux"))
    tr = TTrainer.from_dataset(tcfg, tds, seed=0, device="cpu")
    tr.cv_history.hist[0][:] = 1.0
    with pytest.warns(RuntimeWarning, match="no .*aux CV histories"):
        assert tr.resume() == 1
    assert all(np.abs(x).sum() == 0 for x in _cv_state(tr))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tr.train(2, start_epoch=1)


def test_cv_host_step_calls(datasets, monkeypatch):
    """2 blocks: 1 assembly, 2 gather_reduce (mean), 2 gather_reduce_bwd
    (every block's source needs a gradient: block 0's through dense)."""
    calls = count_step_calls(datasets, dict(arch="gcn_cv", n_layers=2, preprocess=True),
                             monkeypatch, fanouts=(3, 2))
    assert calls == {"assemble": 1, "gather_reduce": 2, "gather_reduce_bwd": 2}


@pytest.mark.parametrize("backend", ["host", "device"])
def test_cv_full_graph_logits_match_jax(backend):
    """gcn_cv evaluates as a preprocess GCN with the concat-skip forced on
    (even with ``skip_connection=False``), against the JAX package's host
    backend within 1e-4 of each row's largest logit; ``evaluate`` equal."""
    g = _graph(300, 2400, 40, seed=4)
    x = np.random.default_rng(2).normal(size=(300, FEAT)).astype(np.float32)
    kw = dict(arch="gcn_cv", n_layers=2, hidden=8, feat_dim=FEAT, n_classes=CLASSES,
              preprocess=True, skip_connection=False)
    jcfg, tcfg = pg.ModelConfig(**kw), pt.ModelConfig(**kw)
    jp = jax.device_get(jcv.init_params(jax.random.PRNGKey(3), jcfg))
    model = get_model(tcfg)
    model.load_state_dict(params_from_jax(jp))
    want = np.asarray(jinf.full_graph_logits(jp, jcfg, g, x, backend="host"))
    got = tinf.full_graph_logits(model, tcfg, _tgraph(g), x, backend=backend)
    _assert_rows_close(got, want, backend)
    labels = np.random.default_rng(5).integers(0, CLASSES, 300)
    mask = np.random.default_rng(6).random(300) < 0.4
    assert tinf.evaluate(model, tcfg, _tgraph(g), x, labels, mask, backend=backend) == \
        jinf.evaluate(jp, jcfg, g, x, labels, mask, backend="host")


def test_cv_convert_round_trip():
    jcfg, tcfg = model_cfgs("gcn_cv", n_layers=2, preprocess=True)
    check_convert_round_trip(jcv.init_params(jax.random.PRNGKey(1), jcfg), tcfg)


def test_cv_loss_rises_at_the_chip_shape_as_in_jax():
    """At the shape of ``chip_smoke.py``'s ``cv_gcn`` phase (hidden 256,
    fan-outs (15, 10), batch 1024, Adam 1e-2) CV-GCN's loss rises at epoch
    1 in the JAX package as in the port: the control variate built from
    epoch 0's stale histories does not hold at that learning rate.  On
    RMAT-12 (2 steps an epoch), dropout 0, from JAX's parameters, both
    rise by more than 1 and stay within 1e-3 of each other."""
    from pagraph_tpu.data.formats import Dataset as JDataset
    from pagraph_tpu.graph import CSRGraph as JGraph
    from pagraph_tpu_torch.data import synthetic
    from pagraph_tpu_torch.data.formats import Dataset as TDataset

    g = pt.CSRGraph.from_coo(synthetic.rmat_coo(12, 16, seed=42))
    feats = np.random.default_rng(7).random((g.num_nodes, 100), dtype=np.float32)
    labels = synthetic.neighborhood_labels(g, feats, 47, seed=1)
    train, val, test = synthetic.random_split_masks(g.num_nodes, seed=11)
    train[np.nonzero(train)[0][2048:]] = False
    cfgs = [mod.Config(
        model=mod.ModelConfig(arch="gcn_cv", n_layers=2, hidden=256, feat_dim=100,
                              n_classes=47, dropout=0.0, preprocess=True),
        sampler=mod.SamplerConfig(batch_size=1024, fanouts=(15, 10), num_hops=2, seed=0),
        cache=mod.CacheConfig(capacity=int(g.num_nodes * 0.4)),
        train=mod.TrainConfig(lr=1e-2)) for mod in (pg, pt)]
    jtr = JTrainer.from_dataset(cfgs[0], JDataset(JGraph(g.indptr, g.indices, g.out_degrees),
                                                  feats, labels, train, val, test), seed=0)
    ttr = TTrainer.from_dataset(cfgs[1], TDataset(g, feats, labels, train, val, test), seed=0,
                                device="cpu")
    ttr.state.model.load_state_dict(params_from_jax(jax.device_get(jtr.state.params)))
    jtr.train(2)
    ttr.train(2)
    jl = [m.mean_loss for m in jtr.epoch_metrics]
    tl = [m.mean_loss for m in ttr.epoch_metrics]
    assert jl[1] > jl[0] + 1 and tl[1] > tl[0] + 1, (jl, tl)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-3)
