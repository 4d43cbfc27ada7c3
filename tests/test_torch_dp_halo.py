"""The port's halo feature sources (``DataParallelTrainer(feature_source=
"ici" | "edge")``, ``train.halo_pipeline``) against
``pagraph_tpu.parallel.DataParallelTrainer`` with the same source.

The port's ranks are gloo processes (``tests/torch_dp_worker.py``
``run_jobs``, as in ``tests/test_torch_dp.py``); the JAX package's trainer
runs here on ``make_mesh(2)`` or ``make_mesh(4)``.  Both start from the JAX
package's initial parameters at dropout 0.

* ``ici`` on the host path: GraphSAGE mean over ``hash`` parts on 2 ranks,
  GCN over ``dg`` parts on 4, and the int8 tier; ``ici`` and ``edge`` on
  the device on 2 ranks, given JAX's random integers (``ici``: the shared
  ``permutation(perm_key, n_train)`` and ``fold_in(split(sample_key,
  num_batches)[i], rank)``; ``edge``: the dp schedule's); ``edge`` with
  ``halo_pipeline``.  Per epoch ``mean_loss`` and ``mean_acc`` within 1e-5
  of JAX's, ``num_batches``, ``edges``, ``vertices`` and ``halo_drops``
  equal, the miss rate 0; final parameters within 1e-5.
* A narrow halo width forced in both packages (8 rows an owner) on the
  host planner and on the device planner: equal ``halo_drops`` each
  epoch, and the ``RuntimeWarning`` on every rank as in JAX.
* ``halo_pipeline`` equals the unpipelined edge epoch to the bit; every
  rank's parameters are bit-equal; every rank ran the lockstep step count
  with one gradient all-reduce and one exchange a step.
* World size 1: ``ici`` on the host path equals the ``cache`` source to the
  bit, and the ``edge`` device epoch the dp ``cache`` device epoch.
* Checkpoints and evaluation work as on the ``cache`` source: an ``edge``
  run resumed from epoch 0's checkpoint equals the uninterrupted run to
  the bit (dropout 0.2), and ``ici``'s ``val_acc`` equals JAX's.
"""
import warnings

import jax
import numpy as np
import pytest
import torch

import pagraph_tpu.parallel.halo as jhalo
from pagraph_tpu.data.synthetic import synthetic_dataset as jsynthetic
from pagraph_tpu.parallel import DataParallelTrainer as JDP
from pagraph_tpu.parallel import make_mesh
from pagraph_tpu_torch.convert import params_from_jax
from tests.test_torch_device_epoch import _jax_step_draws
from tests.test_torch_dp import DATA, jax_config, jax_dp_randomness, sections, spawn

EPOCHS = 2
TOL = 1e-5
NARROW = 8


def jax_ici_randomness(jtr, epochs, cfg):
    """Each rank's ``{epoch: (perm, draws)}`` as JAX's ``ici`` device epoch
    derives them (``make_ici_device_epoch_fn``): one permutation for every
    rank, each rank's step keys folded with its rank."""
    n_train, nb = len(jtr._full_train_nids), jtr._dev_num_batches
    world = jtr.mesh.devices.size
    out = {r: {} for r in range(world)}
    for e in range(epochs):
        perm_key, sample_key = jax.random.split(jax.random.fold_in(jtr._epoch_key, e))
        perm = torch.from_numpy(np.array(jax.random.permutation(perm_key, n_train)))
        keys = jax.random.split(sample_key, nb)
        for r in range(world):
            steps = [_jax_step_draws(jax.random.fold_in(k, r), cfg) for k in keys]
            out[r][e] = (perm, tuple(torch.stack([s[h] for s in steps])
                                     for h in range(cfg.sampler.num_hops)))
    return out


def run_jax(jtr, epochs):
    """Epoch by epoch (and its evaluation), each epoch's halo drops and
    warnings beside its metrics."""
    drops, warned = [], []
    for e in range(epochs):
        before = jtr.halo_drops
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            jtr.run_epoch(e)
            jtr._maybe_eval(e)
        drops.append(jtr.halo_drops - before)
        warned.append(any("halo requests overflowed" in str(w.message) for w in caught))
    return drops, warned


SCENARIOS = {
    # name: (world, source, sections, narrow width forced)
    "ici_host_sage_hash": (2, "ici", sections(eval_every=2), False),
    "ici_host_gcn_dg": (4, "ici", sections(arch="gcn", method="dg"), False),
    "ici_host_int8": (2, "ici", dict(sections(), cache=dict(capacity=90, dtype="int8")), False),
    "ici_device": (2, "ici", sections(on_device=True), False),
    "edge_device": (2, "edge", sections(on_device=True), False),
    "edge_pipelined": (2, "edge", sections(on_device=True, halo_pipeline=True), False),
    "ici_host_narrow": (2, "ici", sections(), True),
    "edge_narrow": (2, "edge", sections(on_device=True), True),
}
LOCKSTEP = tuple(SCENARIOS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, monkeypatch_module):
    """Every scenario once: the JAX runs here, the port's in three spawns
    (2 ranks, 4 ranks, 1 rank)."""
    tmp = tmp_path_factory.mktemp("dp_halo")
    jds = jsynthetic(**DATA)
    jax_runs, jobs = {}, {1: [], 2: [], 4: []}
    for name, (world, source, sec, narrow) in SCENARIOS.items():
        with monkeypatch_module.context() as mp:
            if narrow:
                mp.setattr(jhalo, "halo_width_for", lambda cap0, num_shards, slack=1.5: NARROW)
            jtr = JDP.from_dataset(jax_config(sec), jds, mesh=make_mesh(world), seed=0,
                                   feature_source=source)
        params = str(tmp / f"{name}_params.pt")
        torch.save(params_from_jax(jax.device_get(jtr.state.params)), params)
        job = dict(name=name, data=DATA, cfg=sec, epochs=EPOCHS, params=params, source=source,
                   halo_width=NARROW if narrow else None)
        if sec["train"]["on_device_sampling"]:
            job["randomness"] = str(tmp / f"{name}_randomness.pt")
            make = jax_ici_randomness if source == "ici" else jax_dp_randomness
            torch.save(make(jtr, EPOCHS, jax_config(sec)), job["randomness"])
        jax_runs[name] = (jtr, *run_jax(jtr, EPOCHS))
        jobs[world].append(job)
    ck = sections(on_device=True, dropout=0.2, ckpt_dir=str(tmp / "ck"), ckpt_every=1)
    jobs[2].append(dict(name="edge_resume", data=DATA, cfg=ck, epochs=3, resume_from=0,
                        source="edge"))
    for name, source, on_device in (("w1_cache_host", "cache", False),
                                    ("w1_ici_host", "ici", False),
                                    ("w1_cache_device", "cache", True),
                                    ("w1_edge_device", "edge", True)):
        jobs[1].append(dict(name=name, data=DATA, cfg=sections(on_device=on_device),
                            epochs=EPOCHS, source=source))
    port = {}
    for world in (2, 4, 1):
        out = tmp / f"out{world}"
        out.mkdir()
        port.update(spawn(jobs[world], world, str(out)))
    return jax_runs, port


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.mark.parametrize("name", LOCKSTEP)
def test_lockstep_metrics_match_jax(runs, name):
    jax_runs, port = runs
    jtr, jdrops, _ = jax_runs[name]
    got, want = port[name][0]["metrics"], jtr.epoch_metrics
    assert len(got) == len(want) == EPOCHS
    for g, w, d in zip(got, want, jdrops):
        assert (g["num_batches"], g["edges"], g["vertices"], g["halo_drops"]) == (
            w.num_batches, w.edges, w.vertices, d)
        assert g["miss_rate"] == w.miss_rate == 0.0
        for k in ("mean_loss", "mean_acc"):
            assert abs(g[k] - getattr(w, k)) <= TOL, (k, g[k], getattr(w, k))
    assert port[name][0]["summary"]["halo_drops"] == jtr.halo_drops
    if SCENARIOS[name][3]:
        assert all(d > 0 for d in jdrops)
    else:
        assert jtr.halo_drops == 0


@pytest.mark.parametrize("name", LOCKSTEP)
def test_lockstep_params_match_jax(runs, name):
    jax_runs, port = runs
    want = params_from_jax(jax.device_get(jax_runs[name][0].state.params))
    got = port[name][0]["params"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=TOL,
                                   err_msg=k)


@pytest.mark.parametrize("name", LOCKSTEP)
def test_replicas_identical_and_lockstep(runs, name):
    """Every rank's parameters equal rank 0's to the bit; every rank ran the
    lockstep step count with one gradient all-reduce and one exchange a
    step, and never filled its cache."""
    ranks = runs[1][name]
    for r in ranks[1:]:
        for k, v in ranks[0]["params"].items():
            assert torch.equal(v, r["params"][k]), k
    steps = ranks[0]["metrics"][0]["num_batches"]
    for r in ranks:
        assert r["steps"] == steps
        assert r["grad_syncs"] == r["exchanges"] == steps * EPOCHS
        assert [m["num_batches"] for m in r["metrics"]] == [steps] * EPOCHS


@pytest.mark.parametrize("name", ["ici_host_narrow", "edge_narrow"])
def test_halo_drops_warn_as_in_jax(runs, name):
    jax_runs, port = runs
    _, jdrops, jwarned = jax_runs[name]
    assert all(jwarned) and all(d > 0 for d in jdrops)
    for r in port[name]:
        msgs = [w for w in r["warnings"] if "halo requests overflowed" in w]
        assert len(msgs) == EPOCHS, r["warnings"]
        assert all(f"static halo width {NARROW}" in w for w in msgs)
        assert r["summary"]["halo_drops"] == sum(jdrops)


def test_halo_pipeline_equals_unpipelined_to_the_bit(runs):
    port = runs[1]
    for a, b in zip(port["edge_device"], port["edge_pipelined"]):
        assert [m["mean_loss"] for m in a["metrics"]] == [m["mean_loss"] for m in b["metrics"]]
        for k, v in a["params"].items():
            assert torch.equal(v, b["params"][k]), k


@pytest.mark.parametrize("halo,cache", [("w1_ici_host", "w1_cache_host"),
                                        ("w1_edge_device", "w1_cache_device")])
def test_world_size_one_equals_the_cache_source(runs, halo, cache):
    got, want = runs[1][halo][0], runs[1][cache][0]
    assert [m["mean_loss"] for m in got["metrics"]] == [m["mean_loss"] for m in want["metrics"]]
    assert [(m["edges"], m["vertices"]) for m in got["metrics"]] == [
        (m["edges"], m["vertices"]) for m in want["metrics"]]
    assert all(m["miss_rate"] == 0.0 for m in got["metrics"])
    for k, v in want["params"].items():
        assert torch.equal(got["params"][k], v), k


def test_edge_resume_equals_uninterrupted(runs):
    for r in runs[1]["edge_resume"]:
        res = r["resumed"]
        assert res["start"] == 1
        assert [m["mean_loss"] for m in res["metrics"]] == [
            m["mean_loss"] for m in r["metrics"][1:]]
        for k, v in r["params"].items():
            assert torch.equal(res["params"][k], v), k


def test_ici_eval_every_matches_jax(runs):
    jax_runs, port = runs
    want = jax_runs["ici_host_sage_hash"][0].epoch_metrics[-1].val_acc
    assert want is not None
    for r in port["ici_host_sage_hash"]:
        assert r["metrics"][-1]["val_acc"] == pytest.approx(want, abs=1e-9)
