"""The port's sampling service (``pagraph_tpu_torch.sampling.service``)
against ``pagraph_tpu.sampling.service`` on the same graph, config, caps
and seed, and the trainers that take ``train.remote_sampling``.

* one2one ``epoch()`` (two epochs), and one2all for 2 consumers, one
  service a consumer (a data-parallel rank's own pool) whose ``epoch()`` is
  JAX's ``epoch_for(r)``: every batch equal to JAX's batch of the same
  seeds, array by array (the order is the workers' completion order in
  both packages, so batches are keyed by their seeds).
* An epoch covers the train set; one2all's consumers cover it disjointly,
  apart from the make-up chunks.
* ``num_slots=1``: a batch held while the next is taken keeps its values in
  the port; the JAX package's batch, a view into the slot, shows the next
  batch's rows.
* A ``Trainer`` with ``remote_sampling`` at the JAX package's
  ``test_trainer_with_remote_sampling`` configuration trains and its loss
  falls, as JAX's does; 2 gloo ranks with one2one and with one2all give
  bit-equal replicas, one2all's ranks disjoint seeds apart from the
  make-up chunks.
* ``close()`` leaves no live worker and no ``/dev/shm`` segment; every
  worker killed makes the epoch raise ``RuntimeError``.
"""
import os

import numpy as np
import pytest
import torch

import pagraph_tpu as pg
import pagraph_tpu_torch as pt
from pagraph_tpu.data.synthetic import synthetic_dataset as jsynthetic
from pagraph_tpu.sampling.service import SampleService as JService
from pagraph_tpu.train.loop import Trainer as JTrainer
from pagraph_tpu_torch.data.synthetic import synthetic_dataset as tsynthetic
from pagraph_tpu_torch.sampling import service as tservice
from pagraph_tpu_torch.sampling.service import SampleService as TService
from pagraph_tpu_torch.train.loop import Trainer as TTrainer
from tests.test_torch_dp import spawn

DATA = dict(num_nodes=400, num_edges=3000, feat_dim=8, num_classes=4, seed=31, learnable=True)
CAPS = (256, 160, 64)


def sampler_cfgs(batch_size=64, fanout=2, seed=7):
    return tuple(mod.SamplerConfig(batch_size=batch_size, fanout=fanout, num_hops=2, seed=seed)
                 for mod in (pg, pt))


@pytest.fixture(scope="module")
def datasets():
    return jsynthetic(**DATA), tsynthetic(**DATA)


def batch_arrays(mb) -> list:
    """A host batch's arrays, copied, in a fixed order."""
    out = [*mb.layer_nids, *mb.layer_mask, mb.labels]
    for b in mb.blocks:
        out += [b.neigh_pos, b.neigh_mask, b.self_pos]
    return [np.array(x) for x in out]


def keyed(batches) -> dict:
    """``{seeds bytes: arrays}`` of an epoch's batches, each copied as it
    is taken (the JAX package's batches are views into a slot)."""
    out = {}
    for mb in batches:
        arrays = batch_arrays(mb)
        n = int(arrays[len(mb.layer_nids) * 2 - 1].sum())
        out[arrays[len(mb.layer_nids) - 1][:n].astype(np.int64).tobytes()] = arrays
    return out


def assert_same_batches(got: dict, want: dict) -> None:
    assert set(got) == set(want) and len(got) > 0
    for k, arrays in want.items():
        for i, (g, w) in enumerate(zip(got[k], arrays, strict=True)):
            np.testing.assert_array_equal(g.astype(w.dtype), w, err_msg=f"array {i}")


@pytest.fixture(scope="module")
def jax_batches(datasets):
    """JAX's one2one epochs 0 and 1 and one2all's epoch for consumers 0
    and 1, keyed by seeds."""
    jds, _ = datasets
    jcfg, _ = sampler_cfgs()
    out = {}
    svc = JService(jds.graph, jds.train_nids, jcfg, labels=jds.labels, caps=CAPS, seed=3,
                   num_workers=1, num_slots=4)
    try:
        out["one2one"] = [keyed(svc.epoch()) for _ in range(2)]
    finally:
        svc.close()
    svc = JService(jds.graph, jds.train_nids, jcfg, labels=jds.labels, caps=CAPS, seed=3,
                   num_workers=2, num_slots=2, num_consumers=2)
    try:
        out["one2all"] = [keyed(svc.epoch_for(r)) for r in range(2)]
        out["one2all_batches"] = svc.num_batches
    finally:
        svc.close()
    return out


def test_one2one_batches_equal_jax(datasets, jax_batches):
    _, tds = datasets
    _, tcfg = sampler_cfgs()
    svc = TService(tds.graph, tds.train_nids, tcfg, labels=tds.labels, caps=CAPS, seed=3,
                   num_workers=2, num_slots=4)
    try:
        for e in range(2):
            assert_same_batches(keyed(svc.epoch()), jax_batches["one2one"][e])
    finally:
        svc.close()


@pytest.mark.parametrize("consumer", [0, 1])
def test_one2all_batches_equal_jax(datasets, jax_batches, consumer):
    """A service for consumer r of 2 (a rank's own pool): its epoch is
    JAX's ``epoch_for(r)`` from the shared pool."""
    _, tds = datasets
    _, tcfg = sampler_cfgs()
    svc = TService(tds.graph, tds.train_nids, tcfg, labels=tds.labels, caps=CAPS, seed=3,
                   num_workers=2, num_slots=2, num_consumers=2, consumer=consumer)
    try:
        assert svc.num_batches == jax_batches["one2all_batches"]
        assert_same_batches(keyed(svc.epoch()), jax_batches["one2all"][consumer])
    finally:
        svc.close()
    with pytest.raises(ValueError, match="consumer 2 of 2"):
        TService(tds.graph, tds.train_nids, tcfg, num_consumers=2, consumer=2)


def test_service_covers_epoch_and_one2all_disjointly(datasets):
    """one2one: every train vertex once an epoch; one2all: the consumers'
    shares cover the train set, and overlap only in the make-up chunks."""
    _, tds = datasets
    _, tcfg = sampler_cfgs(batch_size=32, seed=5)
    svcs = [TService(tds.graph, tds.train_nids, tcfg, labels=tds.labels, num_workers=2,
                     num_slots=4, num_consumers=2, consumer=r) for r in range(2)]
    try:
        shares = [[mb.layer_nids[-1][:int(mb.seed_mask.sum())] for mb in svc.epoch()]
                  for svc in svcs]
        assert len(shares[0]) == len(shares[1]) == svcs[0].num_batches
        seen = np.concatenate(shares[0] + shares[1])
        np.testing.assert_array_equal(np.unique(seen), np.sort(tds.train_nids))
        total = -(-len(tds.train_nids) // 32)
        makeup = 2 * svcs[0].num_batches - total
        assert len(seen) - len(tds.train_nids) <= makeup * 32
    finally:
        for svc in svcs:
            svc.close()
    one = TService(tds.graph, tds.train_nids, tcfg, labels=tds.labels, num_workers=2,
                   num_slots=4)
    try:
        seeds = [mb.layer_nids[-1][:int(mb.seed_mask.sum())] for mb in one.epoch()]
        assert len(seeds) == one.num_batches
        np.testing.assert_array_equal(np.sort(np.concatenate(seeds)), np.sort(tds.train_nids))
        for mb in one.epoch():          # labels travel with the batch
            n = int(mb.seed_mask.sum())
            np.testing.assert_array_equal(mb.labels[:n], tds.labels[mb.layer_nids[-1][:n]])
    finally:
        one.close()


def test_held_batch_keeps_its_values_with_one_slot(datasets):
    """One slot, one worker: take a batch, keep it, take the next.  The
    JAX package's held batch is a view of the slot and shows the next
    batch's seeds; the port's owns its memory and is unchanged."""
    jds, tds = datasets
    jcfg, tcfg = sampler_cfgs()
    held = {}
    for name, cls, ds, cfg in (("jax", JService, jds, jcfg), ("port", TService, tds, tcfg)):
        svc = cls(ds.graph, ds.train_nids, cfg, labels=ds.labels, caps=CAPS, seed=3,
                  num_workers=1, num_slots=1)
        try:
            it = svc.epoch()
            first = next(it)
            before = batch_arrays(first)
            second = batch_arrays(next(it))
            after = batch_arrays(first)
            held[name] = (before, second, after)
            it.close()
        finally:
            svc.close()
    before, second, after = held["jax"]
    assert not np.array_equal(before[2], second[2])
    np.testing.assert_array_equal(after[2], second[2])       # overwritten in the reference
    before, second, after = held["port"]
    np.testing.assert_array_equal(held["port"][0][2], held["jax"][0][2])
    assert not np.array_equal(before[2], second[2])
    for a, b in zip(after, before, strict=True):
        np.testing.assert_array_equal(a, b)


def test_close_leaves_no_worker_and_no_segment(datasets):
    _, tds = datasets
    _, tcfg = sampler_cfgs()
    svc = TService(tds.graph, tds.train_nids, tcfg, labels=tds.labels, num_workers=2)
    workers, names = list(svc.workers), [m.name for m in svc._registry]
    assert all(os.path.exists(os.path.join("/dev/shm", n)) for n in names)
    it = svc.epoch()
    next(it)
    it.close()                      # an epoch left early waits for its batches in flight
    svc.close()
    svc.close()
    assert not any(w.is_alive() for w in workers)
    assert not any(os.path.exists(os.path.join("/dev/shm", n)) for n in names)


def test_every_worker_killed_raises(datasets, monkeypatch):
    _, tds = datasets
    _, tcfg = sampler_cfgs()
    monkeypatch.setattr(tservice, "POLL_S", 0.2)
    svc = TService(tds.graph, tds.train_nids, tcfg, labels=tds.labels, num_workers=1)
    try:
        for w in svc.workers:
            w.kill()
            w.join(timeout=10)
        with pytest.raises(RuntimeError, match="all sampling workers died"):
            list(svc.epoch())
    finally:
        svc.close()


def trainer_cfgs():
    """The JAX package's ``test_trainer_with_remote_sampling``: GCN, one
    layer of 8, batch 64, fan-out 2 over 2 hops, Adam 1e-2 (a cache of
    half the vertices: a CPU device needs a capacity)."""
    return tuple(mod.Config(
        model=mod.ModelConfig(arch="gcn", n_layers=1, hidden=8, feat_dim=8, n_classes=4),
        sampler=mod.SamplerConfig(batch_size=64, fanout=2, num_hops=2),
        cache=mod.CacheConfig(capacity=None if mod is pg else 200),
        train=mod.TrainConfig(lr=1e-2, remote_sampling=True)) for mod in (pg, pt))


def test_trainer_with_remote_sampling(datasets):
    """Both Trainers train through their services for 3 epochs; the loss
    falls in both (the batch order is the workers', so the trajectories
    are not compared step by step: the services are, above)."""
    jds, tds = datasets
    jcfg, tcfg = trainer_cfgs()
    jtr = JTrainer.from_dataset(jcfg, jds, seed=0)
    try:
        jtr.train(3)
    finally:
        jtr.sampler.close()
    tr = TTrainer.from_dataset(tcfg, tds, seed=0, device="cpu")
    try:
        assert isinstance(tr.sampler, TService)
        assert tr.sampler.caps == tr.loader.sampler.caps
        tr.train(3)
    finally:
        tr.close()
    for ms in (jtr.epoch_metrics, tr.epoch_metrics):
        losses = [m.mean_loss for m in ms]
        assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
        assert [m.num_batches for m in ms] == [-(-len(tds.train_nids) // 64)] * 3
    assert not tr.sampler.workers


def test_service_trainer_checkpoint_holds_no_sampler_state(datasets, tmp_path):
    _, tds = datasets
    _, tcfg = trainer_cfgs()
    tcfg.train.ckpt_dir, tcfg.train.ckpt_every = str(tmp_path), 1
    tr = TTrainer.from_dataset(tcfg, tds, seed=0, device="cpu")
    try:
        tr.train(1)
        assert torch.load(os.path.join(str(tmp_path), "gcn_0"), weights_only=False)[
            "sampler"] is None
        assert tr.resume() == 1
    finally:
        tr.close()


def dp_sections():
    return dict(model=dict(arch="gcn", n_layers=1, hidden=8, feat_dim=8, n_classes=4),
                sampler=dict(batch_size=32, fanout=2, num_hops=2, seed=2),
                cache=dict(capacity=150),
                partition=dict(method="hash", num_hops=2),
                train=dict(lr=1e-2, remote_sampling=True))


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp_service")
    jobs = [dict(name=d, data=DATA, cfg=dp_sections(), epochs=2, dispatch=d)
            for d in ("one2one", "one2all")]
    jobs.append(dict(name="ici_one2one", data=DATA, cfg=dp_sections(), epochs=2,
                     dispatch="one2one", source="ici"))
    return spawn(jobs, 2, str(out))


@pytest.mark.parametrize("dispatch", ["one2one", "one2all", "ici_one2one"])
def test_dp_service_replicas_equal(dp_runs, dispatch):
    """Two gloo ranks: parameters bit-equal, one lockstep count (one2all's
    the round robin's share), the loss finite, the workers gone after
    ``close()`` and no shared memory left.  ``ici_one2one``: the host
    ``ici`` source, whose loader plans each step's exchange from the
    service's batches: one exchange a step, the halo drops summed over the
    ranks alike on both."""
    ranks = dp_runs[dispatch]
    for r in ranks[1:]:
        for k, v in ranks[0]["params"].items():
            assert torch.equal(v, r["params"][k]), k
    n_train = len(tsynthetic(**DATA).train_nids)
    steps = {r["steps"] for r in ranks}
    if dispatch == "one2all":
        total = -(-n_train // 32)
        assert steps == {-(-total // 2)}
    assert len(steps) == 1
    for r in ranks:
        assert [m["num_batches"] for m in r["metrics"]] == [r["steps"]] * 2
        assert np.isfinite([m["mean_loss"] for m in r["metrics"]]).all()
        assert r["closed"] == {"alive": False, "shm_left": []}
        assert len(r["seeds"]) == 2
        if dispatch == "ici_one2one":
            assert r["exchanges"] == r["grad_syncs"] == 2 * r["steps"]
            drops = [m["halo_drops"] for m in r["metrics"]]
            assert drops == [m["halo_drops"] for m in ranks[0]["metrics"]]
            assert r["summary"]["halo_drops"] == sum(drops)
        else:
            assert r["exchanges"] == 0


def test_dp_one2all_ranks_disjoint_apart_from_makeup(dp_runs):
    """Each epoch the two ranks' seeds cover the train set; a seed is on
    both ranks only through a make-up chunk."""
    ranks = dp_runs["one2all"]
    train = np.sort(tsynthetic(**DATA).train_nids)
    total = -(-len(train) // 32)
    steps = ranks[0]["steps"]
    for e in range(2):
        shares = [torch.cat(r["seeds"][e]).numpy() for r in ranks]
        np.testing.assert_array_equal(np.unique(np.concatenate(shares)), train)
        both = np.intersect1d(shares[0], shares[1])
        assert len(both) <= (2 * steps - total) * 32
