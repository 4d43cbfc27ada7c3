"""The port's data-parallel trainer (``pagraph_tpu_torch.parallel``) against
``pagraph_tpu.parallel.DataParallelTrainer``.

The port's ranks are gloo processes started by ``spawn_local`` over a
``file://`` store, each running ``tests/torch_dp_worker.py`` (which imports
no JAX); the JAX package's trainer runs here on ``make_mesh(2)`` or
``make_mesh(4)`` of the conftest's 8 virtual CPU devices.  Both start from
the JAX package's initial parameters (``convert.params_from_jax``), at
dropout 0, on the same partitions.

* Host-path lockstep: GraphSAGE mean over ``hash`` and GCN over ``dg``
  (both packages' ``from_dataset``), and GraphSAGE over 4 uneven partitions
  from disk (the wrap-around and the lockstep maximum), each with a partial
  cache: per epoch ``mean_loss``, ``mean_acc`` and ``miss_rate`` within
  1e-5 of JAX's, batches, ``edges`` and ``vertices`` equal; final
  parameters within 1e-5.
* On-device lockstep over 2 uneven partitions, given JAX's random integers
  (``fold_in(epoch_key, rank)``, the uniform ``argsort``, ``split(sample_key,
  num_batches)``): the same, within 1e-5.
* Every rank's parameters bit-equal after training; every rank ran the
  lockstep step count, the largest of the ranks' own, with one gradient
  all-reduce a step.
* World size 1 equals the single-device ``Trainer`` to the bit on the CPU,
  on the host path and on the on-device path (given the same random
  integers and a train set that fills every batch: the single-device
  schedule masks a short last batch where the data-parallel one wraps).
* A resume from a checkpoint on the on-device path equals the
  uninterrupted run to the bit (dropout 0.2: each rank's dropout stream is
  reseeded an epoch).
* ``train.eval_every``: ``val_acc`` equals JAX's.
* Every refusal raises: the JAX package's own validation of the halo
  sources (``edge`` off the device, ``halo_pipeline`` off ``edge``) and
  the paths still to port with their ROADMAP item; a failed rank fails
  ``spawn_local``, and ``nccl`` with more ranks than GPUs is a
  ``ValueError`` before any process group exists.
"""
import os

import jax
import numpy as np
import pytest
import torch

import pagraph_tpu as pg
import pagraph_tpu_torch as pt
from pagraph_tpu.data import formats as jfmt
from pagraph_tpu.data.synthetic import synthetic_dataset as jsynthetic
from pagraph_tpu.parallel import DataParallelTrainer as JDP
from pagraph_tpu.parallel import make_mesh
from pagraph_tpu.storage.feature_store import FeatureStore as JStore
from pagraph_tpu_torch.convert import params_from_jax
from pagraph_tpu_torch.data import formats as tfmt
from pagraph_tpu_torch.data.synthetic import synthetic_dataset as tsynthetic
from pagraph_tpu_torch.parallel import DataParallelTrainer, spawn_local
from pagraph_tpu_torch.parallel.multihost import init_distributed
from pagraph_tpu_torch.partition import extract_partition
from pagraph_tpu_torch.storage.feature_store import FeatureStore as TStore
from pagraph_tpu_torch.train.loop import Trainer as TTrainer
from tests.test_torch_device_epoch import _jax_step_draws
from tests.torch_dp_worker import fail_on_rank_one, make_config, run_jobs

DATA = dict(num_nodes=600, num_edges=4800, feat_dim=12, num_classes=4, seed=5,
            learnable=True)
EPOCHS = 2
TOL = 1e-5


def sections(arch="graphsage", method="hash", on_device=False, capacity=90,
             eval_every=0, dropout=0.0, **train):
    model = dict(arch=arch, n_layers=1, hidden=8, feat_dim=12, n_classes=4, dropout=dropout)
    hops = pt.ModelConfig(**model).num_sampled_hops
    return dict(model=model,
                sampler=dict(batch_size=32, fanout=2, num_hops=hops, seed=2),
                cache=dict(capacity=None if on_device else capacity),
                partition=dict(method=method, num_hops=hops),
                train=dict(lr=1e-2, on_device_sampling=on_device, eval_every=eval_every,
                           **train))


def jax_config(sec) -> pg.Config:
    return pg.Config(model=pg.ModelConfig(**sec["model"]),
                     sampler=pg.SamplerConfig(**sec["sampler"]),
                     cache=pg.CacheConfig(**sec["cache"]),
                     partition=pg.PartitionConfig(**sec["partition"]),
                     train=pg.TrainConfig(**sec["train"]))


def uneven_parts(ds, fractions, hops):
    """The train set split into consecutive chunks of the given fractions,
    each expanded to its ``hops`` closure (the port's partitioner)."""
    cuts = np.cumsum(np.round(np.asarray(fractions) * len(ds.train_nids)).astype(int))[:-1]
    return [extract_partition(ds.graph, chunk, ds.labels, hops)
            for chunk in np.split(ds.train_nids, cuts)]


def jax_dp_randomness(jtr, epochs, cfg):
    """Each rank's ``{epoch: (perm, draws)}`` as JAX's data-parallel device
    epoch derives them (``make_dp_device_epoch_fn``)."""
    counts = [len(p.train_nids) for p in jtr.parts]
    max_train, nb = max(counts), jtr._dev_num_batches
    out = {}
    for r, count in enumerate(counts):
        out[r] = {}
        for e in range(epochs):
            key = jax.random.fold_in(jax.random.fold_in(jtr._epoch_key, e), r)
            perm_key, sample_key = jax.random.split(key)
            u = jax.random.uniform(perm_key, (max_train,))
            u = jax.numpy.where(jax.numpy.arange(max_train) < count, u, jax.numpy.inf)
            perm = np.asarray(jax.numpy.argsort(u))[:count].astype(np.int64)
            steps = [_jax_step_draws(k, cfg) for k in jax.random.split(sample_key, nb)]
            draws = tuple(torch.stack([s[h] for s in steps])
                          for h in range(cfg.sampler.num_hops))
            out[r][e] = (torch.from_numpy(perm), draws)
    return out


def spawn(jobs, world, out, timeout=240):
    spawn_local(run_jobs, world, jobs, out, backend="gloo", timeout=timeout)
    return {j["name"]: [torch.load(os.path.join(out, f"{j['name']}_rank{r}.pt"))
                        for r in range(world)] for j in jobs}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every scenario once: the JAX runs here, the port's in three spawns
    (2 ranks, 4 ranks, 1 rank)."""
    tmp = tmp_path_factory.mktemp("dp")
    jds = jsynthetic(**DATA)
    tds = tsynthetic(**DATA)
    jax_runs, jobs2, jobs4, jobs1 = {}, [], [], []

    def jax_job(name, sec, jtr, jobs, parts=None, randomness=False):
        params = str(tmp / f"{name}_params.pt")
        torch.save(params_from_jax(jax.device_get(jtr.state.params)), params)
        job = dict(name=name, data=DATA, cfg=sec, epochs=EPOCHS, parts=parts, params=params)
        if randomness:
            job["randomness"] = str(tmp / f"{name}_randomness.pt")
            torch.save(jax_dp_randomness(jtr, EPOCHS, jax_config(sec)), job["randomness"])
        jtr.train(EPOCHS)
        jax_runs[name] = jtr
        jobs.append(job)

    for name, sec in (("sage_hash", sections(eval_every=2)),
                      ("gcn_dg", sections(arch="gcn", method="dg"))):
        jtr = JDP.from_dataset(jax_config(sec), jds, mesh=make_mesh(2), seed=0)
        jax_job(name, sec, jtr, jobs2)
    for name, fractions, sec, jobs in (
            ("sage_uneven4", (0.4, 0.3, 0.2, 0.1), sections(), jobs4),
            ("sage_device", (0.7, 0.3), sections(on_device=True), jobs2)):
        d = str(tmp / name)
        parts = uneven_parts(tds, fractions, 2)
        for r, p in enumerate(parts):
            tfmt.save_partition(d, r, p)
        jparts = [jfmt.load_partition(d, r) for r in range(len(parts))]
        jtr = JDP(jax_config(sec), JStore.build(jds.graph, jds.features), jparts,
                  mesh=make_mesh(len(parts)), seed=0)
        jax_job(name, sec, jtr, jobs, parts=d, randomness=sec["train"]["on_device_sampling"])
    ck = sections(on_device=True, dropout=0.2, ckpt_dir=str(tmp / "ck"), ckpt_every=1)
    jobs2.append(dict(name="device_resume", data=DATA, cfg=ck, epochs=3, resume_from=0,
                      parts=None))
    # world size 1 against the single-device Trainer: a train set of whole batches
    cut = len(tds.train_nids) // 32 * 32
    single = {}
    for name, sec in (("w1_host", sections()), ("w1_device", sections(on_device=True))):
        cfg = make_config(sec)
        tr = TTrainer(cfg, TStore.build(tds.graph, tds.features), tds.graph,
                      tds.train_nids[:cut], tds.labels, seed=0, device="cpu")
        job = dict(name=name, data=DATA, cfg=sec, epochs=EPOCHS, parts="identity",
                   train_cut=cut)
        if sec["train"]["on_device_sampling"]:
            job["randomness"] = str(tmp / f"{name}_randomness.pt")
            rand = {e: tr.epoch_randomness(e) for e in range(EPOCHS)}
            torch.save({0: rand}, job["randomness"])
            tr.epoch_randomness = lambda e, out=None, rand=rand: rand[e]
        tr.train(EPOCHS)
        single[name] = tr
        jobs1.append(job)
    port = {}
    for jobs, world in ((jobs2, 2), (jobs4, 4), (jobs1, 1)):
        out = tmp / f"out{world}"
        out.mkdir()
        port.update(spawn(jobs, world, str(out)))
    return jax_runs, port, single


LOCKSTEP = ("sage_hash", "gcn_dg", "sage_uneven4", "sage_device")


@pytest.mark.parametrize("name", LOCKSTEP)
def test_lockstep_metrics_match_jax(runs, name):
    jax_runs, port, _ = runs
    got = port[name][0]["metrics"]
    want = jax_runs[name].epoch_metrics
    assert len(got) == len(want) == EPOCHS
    for g, w in zip(got, want):
        assert (g["num_batches"], g["edges"], g["vertices"]) == (w.num_batches, w.edges,
                                                                 w.vertices)
        for k in ("mean_loss", "mean_acc", "miss_rate"):
            assert abs(g[k] - getattr(w, k)) <= TOL, (k, g[k], getattr(w, k))
    if name != "sage_device":
        assert 0.0 < got[-1]["miss_rate"] < 1.0            # a partial cache


@pytest.mark.parametrize("name", LOCKSTEP)
def test_lockstep_params_match_jax(runs, name):
    jax_runs, port, _ = runs
    want = params_from_jax(jax.device_get(jax_runs[name].state.params))
    got = port[name][0]["params"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=TOL,
                                   err_msg=k)


@pytest.mark.parametrize("name", LOCKSTEP + ("device_resume",))
def test_replicas_identical_and_lockstep(runs, name):
    """Every rank's parameters equal rank 0's to the bit; every rank ran the
    largest of the ranks' own batch counts, one all-reduce a step."""
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
    if name in ("sage_uneven4", "sage_device"):
        assert len({r["own_batches"] for r in ranks}) > 1    # the wrap-around ran


def test_eval_every_matches_jax(runs):
    jax_runs, port, _ = runs
    want = jax_runs["sage_hash"].epoch_metrics[-1].val_acc
    for r in port["sage_hash"]:
        assert r["metrics"][-1]["val_acc"] == pytest.approx(want, abs=1e-9)
        assert r["summary"]["val_acc"] == r["metrics"][-1]["val_acc"]


# the keys of pagraph_tpu's DataParallelTrainer.train summary
JAX_SUMMARY_KEYS = {"epochs", "num_devices", "num_processes", "mean_epoch_time_s",
                    "edges_per_epoch", "first_loss", "final_loss", "final_acc", "miss_rate",
                    "val_acc", "halo_drops", "phase_timers"}


def test_summary_keys_match_jax(runs):
    jax_runs, port, _ = runs
    got = port["sage_hash"][0]["summary"]
    assert set(got) | {"phase_timers"} >= JAX_SUMMARY_KEYS
    assert (got["num_devices"], got["num_processes"], got["halo_drops"]) == (2, 2, 0)
    jm = jax_runs["sage_hash"].epoch_metrics
    assert got["edges_per_epoch"] == jm[-1].edges
    assert abs(got["first_loss"] - jm[0].mean_loss) <= TOL


@pytest.mark.parametrize("name", ["w1_host", "w1_device"])
def test_world_size_one_equals_single_trainer(runs, name):
    _, port, single = runs
    tr, got = single[name], port[name][0]
    assert [m["mean_loss"] for m in got["metrics"]] == [m.mean_loss for m in tr.epoch_metrics]
    assert [(m["edges"], m["vertices"], m["miss_rate"]) for m in got["metrics"]] == [
        (m.edges, m.vertices, m.miss_rate) for m in tr.epoch_metrics]
    for k, v in tr.state.model.state_dict().items():
        assert torch.equal(got["params"][k], v), k


def test_device_checkpoint_resume_equals_uninterrupted(runs):
    for r in runs[1]["device_resume"]:
        res = r["resumed"]
        assert res["start"] == 1
        assert [m["mean_loss"] for m in res["metrics"]] == [
            m["mean_loss"] for m in r["metrics"][1:]]
        for k, v in r["params"].items():
            assert torch.equal(res["params"][k], v), k


@pytest.mark.parametrize("change,exc,match", [
    (dict(feature_source="edge"), NotImplementedError, "is an on-device mode"),
    (dict(halo_pipeline=True), ValueError, "pipelines the EDGE mode"),
    (dict(feature_source="ici", halo_pipeline=True), ValueError, "pipelines the EDGE mode"),
    (dict(feature_source="edge", on_device_sampling=True, arch="gcn_cv"), NotImplementedError,
     "item 7c, step 4"),
    (dict(arch="gcn_cv"), NotImplementedError, "item 7c"),
    (dict(remote_sampling=True), NotImplementedError, "item 8"),
    (dict(dispatch="one2all"), NotImplementedError, "item 8"),
    (dict(epoch_dispatch="steps"), NotImplementedError, "single-chip Trainer mode.*item 7b"),
])
def test_refusals(change, exc, match):
    cfg = make_config(sections())
    kw = {}
    for k, v in change.items():
        if k in ("feature_source", "dispatch"):
            kw[k] = v
        elif k == "arch":
            cfg.model.arch, cfg.model.preprocess = v, True
        else:
            setattr(cfg.train, k, v)
    ds = tsynthetic(**DATA)
    with pytest.raises(exc, match=match):
        DataParallelTrainer.from_dataset(cfg, ds, device="cpu", **kw)


def test_needs_a_process_group():
    cfg = make_config(sections())
    ds = tsynthetic(**DATA)
    part = extract_partition(ds.graph, ds.train_nids, ds.labels, 2)
    with pytest.raises(RuntimeError, match="process group is up"):
        DataParallelTrainer(cfg, TStore.build(ds.graph, ds.features), part, device="cpu")


def test_nccl_with_more_ranks_than_gpus_raises(tmp_path):
    gpus = torch.cuda.device_count() if torch.cuda.is_available() else 0
    init = "file://" + str(tmp_path / "store")
    with pytest.raises(ValueError, match="NCCL refuses two ranks on one GPU"):
        init_distributed(0, gpus + 1, backend="nccl", init_method=init)
    with pytest.raises(ValueError, match="NCCL refuses two ranks on one GPU"):
        spawn_local(fail_on_rank_one, gpus + 1, backend="nccl")
    assert not os.path.exists(tmp_path / "store")


def test_a_failed_rank_fails_the_run():
    """Rank 1 raises while rank 0 waits at a barrier: spawn_local ends both
    and raises, with rank 1's non-zero exit code."""
    with pytest.raises(RuntimeError, match="a rank failed"):
        spawn_local(fail_on_rank_one, 2, backend="gloo", timeout=120)


@pytest.fixture
def one_rank_group():
    """A one-rank gloo group in this process, for the pieces that need one."""
    import torch.distributed as dist

    init_distributed(0, 1, backend="gloo")
    yield
    dist.destroy_process_group()


def test_make_dp_train_step_at_world_size_one_equals_the_single_step(one_rank_group):
    """One group of K steps through ``make_dp_train_step`` (a GradSync on
    the state) and through ``make_multistep_train_step`` from the same
    state and batches: equal losses and parameters to the bit."""
    from pagraph_tpu_torch.parallel import make_dp_train_step
    from pagraph_tpu_torch.sampling.pack import stack
    from pagraph_tpu_torch.train.state import make_multistep_train_step

    ds = tsynthetic(**DATA)
    cfg = make_config(sections())
    trs = [TTrainer.from_dataset(cfg, ds, seed=0, device="cpu") for _ in range(2)]
    for t_ in trs:
        t_._maybe_fill_cache()
    group = stack(list(trs[0].loader.epoch())[:3])
    accs = [torch.zeros(2) for _ in trs]
    make_dp_train_step(trs[0].state, trs[0].cache.cache_values)(group, accs[0])
    make_multistep_train_step(trs[1].state, trs[1].cache.cache_values)(group, accs[1])
    assert trs[0].state.grad_sync.calls == 3
    assert torch.equal(accs[0], accs[1])
    for (k, a), b in zip(trs[0].state.model.state_dict().items(),
                         trs[1].state.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_grad_sync_refuses_freed_gradients(one_rank_group):
    """The gradients must stay views of the flat buffer: after
    ``zero_grad(set_to_none=True)`` the sync raises rather than reduce a
    buffer the gradients no longer use."""
    from pagraph_tpu_torch.parallel import GradSync
    from pagraph_tpu_torch.train.state import create_state

    state = create_state(make_config(sections()), seed=0, device="cpu")
    sync = GradSync(state.model)
    assert all(p.grad.data_ptr() >= sync.flat.data_ptr() for p in state.model.parameters())
    sync.sync()
    state.optimizer.zero_grad(set_to_none=True)
    with pytest.raises(RuntimeError, match="no longer a view"):
        sync.sync()


def test_one_rank_is_not_multiprocess(one_rank_group):
    from pagraph_tpu_torch.parallel import is_multiprocess
    from pagraph_tpu_torch.parallel.multihost import local_dp_rows

    assert not is_multiprocess()
    assert local_dp_rows() == [0]
    with pytest.raises(RuntimeError, match="initialized already"):
        init_distributed(0, 1, backend="gloo")
