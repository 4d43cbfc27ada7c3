"""The port's data-parallel CV-GCN (``DataParallelTrainer`` with
``model.arch="gcn_cv"`` on the device, the ``cache`` and ``edge`` sources)
against ``pagraph_tpu.parallel.DataParallelTrainer`` with the same model.

The port's ranks are gloo processes (``tests/torch_dp_worker.py``
``run_jobs``, as in ``tests/test_torch_dp.py``); the JAX package's trainer
runs here on ``make_mesh(2)`` or ``make_mesh(4)``.  Both start from the JAX
package's initial parameters at dropout 0, over the same hash partitions,
the port given JAX's random integers (``jax_dp_randomness``).

* The ``cache`` and ``edge`` CV epochs on 2 and 4 ranks: per epoch
  ``mean_loss`` and ``mean_acc`` within 1e-5 of JAX's (3e-2 at bf16
  compute), batches, edges and vertices equal; final parameters within
  1e-5 at f32.
* Every rank's histories and aggregates within 1e-5 of JAX's rows of that
  rank (JAX's ``[max_nodes, w]`` stacks compared on the rank's first
  ``n_local`` rows): the history scatter's winner (the last valid
  occurrence of an id in a layer) and the refresh (the port's window
  reduction, JAX's chunked edge-list sum) on every rank.
* Replicas bit-equal, one lockstep step count and one all-reduce a step.
* World size 1 (a one-rank group in this process) equals the single-device
  CV ``Trainer`` to the bit: losses, parameters, histories, aggregates.
* Checkpoints: every rank writes its own ``.aux.p<rank>`` shard, a run
  resumed from epoch 0 equals the uninterrupted one to the bit (dropout
  0.2); stale shards of another world size are ignored with a warning, a
  complete set of another world size raises ``ValueError``, and no shard at
  all resumes with zero histories and a ``RuntimeWarning``.
* The JAX package's three refusals, with its messages and exception types.
"""
import os
import warnings

import jax
import numpy as np
import pytest
import torch

from pagraph_tpu.data.synthetic import synthetic_dataset as jsynthetic
from pagraph_tpu.parallel import DataParallelTrainer as JDP
from pagraph_tpu.parallel import make_mesh
from pagraph_tpu_torch.convert import params_from_jax
from pagraph_tpu_torch.data.formats import PartitionArtifact
from pagraph_tpu_torch.data.synthetic import synthetic_dataset as tsynthetic
from pagraph_tpu_torch.parallel import DataParallelTrainer
from pagraph_tpu_torch.storage.feature_store import FeatureStore
from pagraph_tpu_torch.train.checkpoint import open_aux_shards, save_aux_shards
from pagraph_tpu_torch.train.loop import Trainer
from tests.test_torch_dp import DATA, jax_config, jax_dp_randomness, one_rank_group, spawn  # noqa: F401
from tests.torch_dp_worker import make_config

EPOCHS = 2
TOL = 1e-5
BF16_TOL = 3e-2


def cv_sections(on_device=True, dropout=0.0, compute="float32", **train):
    """CV-GCN with 2 layers of 8 (2 histories), preprocess, batch 32,
    fan-out 2 over 2 hops, hash parts at 2 hops, the full cache."""
    return dict(model=dict(arch="gcn_cv", n_layers=2, hidden=8, feat_dim=12, n_classes=4,
                           dropout=dropout, preprocess=True),
                sampler=dict(batch_size=32, fanout=2, num_hops=2, seed=2),
                cache=dict(capacity=None),
                partition=dict(method="hash", num_hops=2),
                train=dict(lr=1e-2, on_device_sampling=on_device, dtype=compute, **train))


SCENARIOS = {
    # name: (world, source, sections)
    "cache2": (2, "cache", cv_sections()),
    "edge2": (2, "edge", cv_sections()),
    "cache4": (4, "cache", cv_sections()),
    "edge4": (4, "edge", cv_sections()),
    "cache2_bf16": (2, "cache", cv_sections(compute="bfloat16")),
}
F32 = tuple(n for n in SCENARIOS if not n.endswith("bf16"))


def jax_cv_rows(jtr, rank, n_local):
    """JAX's histories then aggregates of ``rank``, its first ``n_local``
    rows (its ``[max_nodes, w]`` stacks pad past them)."""
    return [np.asarray(x)[rank, :n_local] for x in (*jtr._dev_hists, *jtr._dev_aggs)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX runs here; the port's in two spawns (2 ranks, 4 ranks),
    with a checkpointed run and its resume on 2 ranks."""
    tmp = tmp_path_factory.mktemp("dp_cv")
    jds = jsynthetic(**DATA)
    jax_runs, jobs = {}, {2: [], 4: []}
    for name, (world, source, sec) in SCENARIOS.items():
        jcfg = jax_config(sec)
        jtr = JDP.from_dataset(jcfg, jds, mesh=make_mesh(world), seed=0,
                               feature_source=source)
        params = str(tmp / f"{name}_params.pt")
        torch.save(params_from_jax(jax.device_get(jtr.state.params)), params)
        rand = str(tmp / f"{name}_randomness.pt")
        torch.save(jax_dp_randomness(jtr, EPOCHS, jcfg), rand)
        jtr.train(EPOCHS)
        jax_runs[name] = jtr
        jobs[world].append(dict(name=name, data=DATA, cfg=sec, epochs=EPOCHS, params=params,
                                randomness=rand, source=source))
    ck = str(tmp / "ck")
    jobs[2].append(dict(name="resume", data=DATA, epochs=3, resume_from=0, source="cache",
                        cfg=cv_sections(dropout=0.2, ckpt_dir=ck, ckpt_every=1)))
    port = {}
    for world in (2, 4):
        out = tmp / f"out{world}"
        out.mkdir()
        port.update(spawn(jobs[world], world, str(out)))
    return jax_runs, port, ck


@pytest.mark.parametrize("name", tuple(SCENARIOS))
def test_cv_lockstep_metrics_match_jax(runs, name):
    jax_runs, port, _ = runs
    got, want = port[name][0]["metrics"], jax_runs[name].epoch_metrics
    tol = BF16_TOL if name.endswith("bf16") else TOL
    assert len(got) == len(want) == EPOCHS
    for g, w in zip(got, want):
        assert (g["num_batches"], g["edges"], g["vertices"]) == (w.num_batches, w.edges,
                                                                 w.vertices)
        for k in ("mean_loss", "mean_acc"):
            assert abs(g[k] - getattr(w, k)) <= tol, (k, g[k], getattr(w, k))


@pytest.mark.parametrize("name", F32)
def test_cv_lockstep_params_match_jax(runs, name):
    jax_runs, port, _ = runs
    want = params_from_jax(jax.device_get(jax_runs[name].state.params))
    got = port[name][0]["params"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=TOL,
                                   err_msg=k)


@pytest.mark.parametrize("name", F32)
def test_scatter_last_winner_and_refresh_on_every_rank(runs, name):
    """Each rank's histories (the last valid occurrence of a repeated id in
    a layer wins) and aggregates (its own refresh) against JAX's rows of
    that rank, within 1e-5."""
    jax_runs, port, _ = runs
    for r, rk in enumerate(port[name]):
        want = jax_cv_rows(jax_runs[name], r, rk["part_nodes"])
        assert len(rk["cv"]) == len(want) == 4
        for b, (g, w) in enumerate(zip(rk["cv"], want)):
            assert g.shape == w.shape
            assert np.abs(w).sum() > 0
            np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL,
                                       err_msg=f"rank {r} array {b}")


@pytest.mark.parametrize("name", tuple(SCENARIOS) + ("resume",))
def test_cv_replicas_identical_and_lockstep(runs, name):
    ranks = runs[1][name]
    for r in ranks[1:]:
        for k, v in ranks[0]["params"].items():
            assert torch.equal(v, r["params"][k]), k
    steps = max(r["own_batches"] for r in ranks)
    epochs = len(ranks[0]["metrics"])
    for r in ranks:
        assert r["steps"] == steps
        assert r["grad_syncs"] == steps * epochs
        assert [m["num_batches"] for m in r["metrics"]] == [steps] * epochs


def test_cv_shards_written_and_resume_equals_uninterrupted(runs):
    """Every rank wrote its shard each epoch, each over its own partition;
    every rank resumed from epoch 0 equals its uninterrupted run: losses,
    parameters, histories and aggregates, to the bit."""
    _, port, ck = runs
    ranks = port["resume"]
    for e in range(3):
        shards = open_aux_shards(ck, "gcn_cv", e)
        assert sorted(shards) == [0, 1]
        for r, rk in enumerate(ranks):
            assert shards[r]["hist0"].shape[0] == rk["part_nodes"]
    final = open_aux_shards(ck, "gcn_cv", 2)
    for r, rk in enumerate(ranks):
        for b, name in enumerate(("hist0", "hist1", "agg0", "agg1")):
            assert torch.equal(final[r][name], rk["cv"][b]), (r, name)
        res = rk["resumed"]
        assert res["start"] == 1
        assert [m["mean_loss"] for m in res["metrics"]] == [
            m["mean_loss"] for m in rk["metrics"][1:]]
        for k, v in rk["params"].items():
            assert torch.equal(res["params"][k], v), k
        for g, w in zip(res["cv"], rk["cv"], strict=True):
            assert torch.equal(g, w)


# -- one rank in this process -------------------------------------------------------

@pytest.fixture(scope="module")
def tds():
    return tsynthetic(**DATA)


def whole_part(tds, cut=None):
    return PartitionArtifact(tds.graph, tds.train_nids[:cut], np.arange(tds.num_nodes),
                             tds.labels)


def cv_dp(tds, sec, source="cache", part=None):
    cfg = make_config(sec)
    store = FeatureStore.build(tds.graph, tds.features, preprocess="gcn")
    return DataParallelTrainer(cfg, store, part or whole_part(tds), seed=0, device="cpu",
                               feature_source=source)


@pytest.mark.parametrize("source", ["cache", "edge"])
def test_cv_world_size_one_equals_single_trainer(one_rank_group, tds, source):
    """World size 1 from the same parameters and random integers, over a
    train set of whole batches: losses, parameters, histories and
    aggregates equal to the single-device CV Trainer's to the bit."""
    cut = len(tds.train_nids) // 32 * 32
    sec = cv_sections()
    single = Trainer(make_config(sec), FeatureStore.build(tds.graph, tds.features,
                                                          preprocess="gcn"),
                     tds.graph, tds.train_nids[:cut], tds.labels, seed=0, device="cpu")
    dp = cv_dp(tds, sec, source, whole_part(tds, cut))
    dp.state.model.load_state_dict(single.state.model.state_dict())
    rand = {e: single.epoch_randomness(e) for e in range(EPOCHS)}
    for t_ in (single, dp):
        t_.epoch_randomness = lambda e, out=None: rand[e]
        t_.train(EPOCHS)
    assert [m.mean_loss for m in dp.epoch_metrics] == [m.mean_loss for m in single.epoch_metrics]
    for (k, p), q in zip(single.state.model.state_dict().items(),
                         dp.state.model.state_dict().values()):
        assert torch.equal(p, q), k
    for a, b in zip(single.cv_state.hist_views() + list(single.cv_state.aggs),
                    dp.cv_state.hist_views() + list(dp.cv_state.aggs), strict=True):
        assert torch.equal(a, b)
        assert a.abs().sum() > 0


def test_cv_stale_shards_ignored_with_a_warning(one_rank_group, tds, tmp_path):
    """A leftover shard claiming a 4-rank layout next to a complete
    one-rank set: the JAX package's warning, and the true rows restored."""
    sec = cv_sections(ckpt_dir=str(tmp_path), ckpt_every=1)
    tr = cv_dp(tds, sec)
    tr.train(1)
    want = [t.clone() for t in tr.cv_state.hist_views()]
    poisoned = {"hist": [torch.full_like(h, 1e9) for h in want], "agg": []}
    save_aux_shards(str(tmp_path), "gcn_cv", 0, poisoned, 1, 4)
    again = cv_dp(tds, sec)
    with pytest.warns(RuntimeWarning, match="stale CV aux shard"):
        assert again.resume(0) == 1
    for a, b in zip(again.cv_state.hist_views(), want, strict=True):
        assert torch.equal(a, b)


def test_cv_shard_set_of_another_world_size_raises(one_rank_group, tds, tmp_path):
    """A complete set written by 2 ranks, restored by 1: the JAX package's
    ``ValueError``."""
    sec = cv_sections(ckpt_dir=str(tmp_path), ckpt_every=1)
    tr = cv_dp(tds, sec)
    tr.train(1)
    os.remove(os.path.join(str(tmp_path), "gcn_cv_0.aux.p0"))
    aux = tr._cv_aux()
    for r in range(2):
        save_aux_shards(str(tmp_path), "gcn_cv", 0, aux, r, 2)
    with pytest.raises(ValueError, match="different mesh size"):
        cv_dp(tds, sec).resume(0)


def test_cv_no_shard_resumes_with_zero_histories(one_rank_group, tds, tmp_path):
    sec = cv_sections(ckpt_dir=str(tmp_path), ckpt_every=1)
    cv_dp(tds, sec).train(1)
    os.remove(os.path.join(str(tmp_path), "gcn_cv_0.aux.p0"))
    tr = cv_dp(tds, sec)
    tr.cv_state.hists[0].fill_(1.0)
    with pytest.warns(RuntimeWarning, match="no .*aux CV histories"):
        assert tr.resume() == 1
    assert all(float(t.abs().sum()) == 0 for t in tr.cv_state.hist_views() + list(
        tr.cv_state.aggs))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tr.train(2, start_epoch=1)


@pytest.mark.parametrize("change,exc,match", [
    (dict(on_device_sampling=False), NotImplementedError,
     "multi-chip gcn_cv needs device-resident per-partition histories"),
    (dict(feature_source="ici"), NotImplementedError, "divergent histories"),
    (dict(feature_source="edge", halo_pipeline=True), NotImplementedError,
     "halo_pipeline is not implemented for the gcn_cv edge epoch"),
])
def test_cv_refusals_as_in_jax(tds, change, exc, match):
    """The JAX package's three refusals of data-parallel CV-GCN, raised by
    both packages with the same type and message."""
    sec, change = cv_sections(), dict(change)
    source = change.pop("feature_source", "cache")
    sec["train"].update(change)
    with pytest.raises(exc, match=match):
        JDP.from_dataset(jax_config(sec), jsynthetic(**DATA), mesh=make_mesh(2),
                         feature_source=source)
    with pytest.raises(exc, match=match):
        DataParallelTrainer.from_dataset(make_config(sec), tds, device="cpu",
                                         feature_source=source)
