"""The port's on-device epoch against ``pagraph_tpu``'s, on CPU tensors.

Same numpy data, the same initial parameters (``params_from_jax``), dropout
0, and the JAX package's random integers reproduced from its own keys and
handed to the port (the two packages' generators differ).  The layer-0
fetch is exact at every cache tier; losses and parameters drift apart only
by float32 reassociation in forward, backward and Adam: within 1e-5 after
one step, 1e-4 after two epochs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pagraph_tpu as pg
import pagraph_tpu_torch as pt
from pagraph_tpu.data.synthetic import synthetic_dataset as jsynthetic
from pagraph_tpu.ops.gather import chunked_take
from pagraph_tpu.storage.cache import dequantize_fused
from pagraph_tpu.train.device_epoch import _make_batch_body
from pagraph_tpu.train.loop import Trainer as JTrainer
from pagraph_tpu_torch.convert import params_from_jax
from pagraph_tpu_torch.data.synthetic import synthetic_dataset as tsynthetic
from pagraph_tpu_torch.ops.gather import take_rows
from pagraph_tpu_torch.sampling.device_sampler import draw_width, hop_sizes
from pagraph_tpu_torch.train import device_epoch as tde
from pagraph_tpu_torch.train.loop import Trainer as TTrainer

HIGH = 2**31 - 1
DATA = dict(num_nodes=600, num_edges=4800, feat_dim=32, num_classes=6, seed=21,
            learnable=True)


@pytest.fixture(scope="module")
def datasets():
    return jsynthetic(**DATA), tsynthetic(**DATA)


def _cfgs(dtype="float32", paired=False, batch=64, dispatch="scan", capacity=None):
    kw = dict(
        model=dict(arch="graphsage", n_layers=1, hidden=16, feat_dim=32, n_classes=6,
                   aggregator="mean", dropout=0.0),
        sampler=dict(batch_size=batch, fanouts=(3, 2), num_hops=2, seed=7,
                     paired_draws=paired),
        cache=dict(capacity=capacity, dtype=dtype),
        train=dict(lr=1e-2, on_device_sampling=True, epoch_dispatch=dispatch),
    )
    return tuple(
        mod.Config(model=mod.ModelConfig(**kw["model"]),
                   sampler=mod.SamplerConfig(**kw["sampler"]),
                   cache=mod.CacheConfig(**kw["cache"]),
                   train=mod.TrainConfig(**kw["train"]))
        for mod in (pg, pt))


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_step_draws(skey, cfg):
    """The integers JAX's sample_minibatch_device draws from a step key."""
    s = cfg.sampler
    fanouts = s.hop_fanouts()
    keys = jax.random.split(skey, s.num_hops)
    return [_t(jax.random.randint(keys[h], (n, draw_width(f, s.paired_draws)), 0,
                                  jnp.int32(HIGH), dtype=jnp.int32))
            for h, (n, f) in enumerate(zip(hop_sizes(s.batch_size, fanouts), fanouts))]


def _jax_epoch_randomness(seed, epoch, n_train, cfg):
    """``(perm, draws)`` as JAX's Trainer derives them for ``epoch``."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed ^ 0x5EED), epoch)
    perm_key, sample_key = jax.random.split(key)
    num_batches = -(-n_train // cfg.sampler.batch_size)
    steps = [_jax_step_draws(k, cfg) for k in jax.random.split(sample_key, num_batches)]
    draws = tuple(torch.stack([s[h] for s in steps]) for h in range(cfg.sampler.num_hops))
    return _t(jax.random.permutation(perm_key, n_train)), draws


def _assert_params_close(ttr, jparams, atol):
    want = params_from_jax(jax.device_get(jparams))
    for name, p in ttr.state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_take_rows_matches_jax(datasets, dtype):
    """The layer-0 fetch equals ``dequantize_fused(chunked_take(...))``,
    chunked (chunk 64) or not, at each tier."""
    jds, tds = datasets
    jcfg, tcfg = _cfgs(dtype)
    jtr = JTrainer.from_dataset(jcfg, jds, seed=0)
    ttr = TTrainer.from_dataset(tcfg, tds, seed=0, device="cpu")
    jtr._maybe_fill_cache()
    ttr._maybe_fill_cache()
    ids = np.random.default_rng(4).integers(0, jds.num_nodes, 300).astype(np.int32)
    got = take_rows(ttr.cache.cache_values, _t(ids), ttr.cache.dequant_scale_dev)
    assert got.dtype == torch.float32 and got.shape == (300, 32)
    for chunk in (None, 64):
        want = dequantize_fused(chunked_take(jtr.cache.cache_values, jnp.asarray(ids),
                                             chunk=chunk), jtr.cache.dequant_scale_padded)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:, :32])


@pytest.mark.parametrize("dtype,paired", [("float32", False), ("bfloat16", True),
                                          ("int8", True)])
def test_device_batch_step_matches_jax(datasets, dtype, paired):
    """One step (sample, fetch, forward, loss, backward, Adam) against
    ``_make_batch_body``: metrics, and parameters after Adam within 1e-5."""
    jds, tds = datasets
    jcfg, tcfg = _cfgs(dtype, paired)
    jtr = JTrainer.from_dataset(jcfg, jds, seed=0)
    jtr._maybe_fill_cache()
    ttr = TTrainer.from_dataset(tcfg, tds, seed=0, device="cpu")
    ttr._maybe_fill_cache()
    ttr.state.model.load_state_dict(params_from_jax(jax.device_get(jtr.state.params)))
    batch = jcfg.sampler.batch_size
    seeds = jds.train_nids[:batch].astype(np.int32)
    smask = np.arange(batch) < batch - 9
    skey = jax.random.PRNGKey(13)
    body = _make_batch_body(jcfg, jtr._tx, jtr.cache.field_offsets,
                            jtr.cache.dequant_scale_padded)
    jstate, jacc = jax.jit(body)(jtr.state, jnp.zeros(5, jnp.float32), jnp.asarray(seeds),
                                 jnp.asarray(smask), skey, jtr._dev_labels, jtr._dev_csr,
                                 jtr.cache.cache_values)
    acc = tde.EpochAccumulator.zeros("cpu")
    tde.device_batch_step(tcfg, ttr.state, acc, _t(seeds), _t(smask),
                          _jax_step_draws(skey, tcfg), ttr._dev_labels, ttr._dev_csr,
                          ttr.cache.cache_values, ttr.cache.dequant_scale_dev)
    got, want = acc.values(), dict(zip(tde.METRIC_NAMES, np.asarray(jacc).tolist()))
    assert got["steps"] == 1 and got["edges"] == want["edges"] > 0
    assert got["vertices"] == want["vertices"] > got["edges"]
    np.testing.assert_allclose(got["loss_sum"], want["loss_sum"], rtol=1e-5)
    np.testing.assert_allclose(got["acc_sum"], want["acc_sum"], atol=1e-6)
    _assert_params_close(ttr, jstate.params, 1e-5)
    assert ttr.state.step == 1


@pytest.mark.parametrize("paired", [False, True])
def test_device_epochs_lockstep_with_jax(datasets, paired):
    """Two epochs of the port's Trainer (the JAX permutation and draws
    injected) against JAX's ``make_device_epoch_fn`` through its Trainer,
    with a tail batch: losses within 1e-4, edges and vertices equal."""
    jds, tds = datasets
    jcfg, tcfg = _cfgs(paired=paired, batch=128)
    jtr = JTrainer.from_dataset(jcfg, jds, seed=3)
    ttr = TTrainer.from_dataset(tcfg, tds, seed=3, device="cpu")
    ttr.state.model.load_state_dict(params_from_jax(jax.device_get(jtr.state.params)))
    n_train = len(tds.train_nids)
    assert n_train % 128
    ttr.epoch_randomness = lambda e, out=None: _jax_epoch_randomness(3, e, n_train, tcfg)
    jtr.train(2)
    ttr.train(2)
    for jm, tm in zip(jtr.epoch_metrics, ttr.epoch_metrics, strict=True):
        assert tm.num_batches == jm.num_batches == -(-n_train // 128)
        assert tm.edges == jm.edges and tm.vertices == jm.vertices
        assert tm.miss_rate == jm.miss_rate == 0.0 and tm.h2d_bytes == 0
        assert abs(tm.mean_loss - jm.mean_loss) < 1e-4, (tm.mean_loss, jm.mean_loss)
        assert abs(tm.mean_acc - jm.mean_acc) < 1e-3
    _assert_params_close(ttr, jtr.state.params, 1e-4)


@pytest.mark.parametrize("paired", [False, True])
def test_dispatch_modes_share_one_trajectory(datasets, paired):
    """``scan``, ``steps`` and ``pipelined`` are three code paths, one
    function each (``DeviceEpochRunner``; CUDA graphs on the card, their
    eager forms on the CPU), and on the CPU they give bit-equal epochs,
    parameters and device step counts: the same arithmetic in the same
    order, whether a batch is a view of the schedule (``scan``) or taken
    at a device index (``steps``, ``pipelined``), and whether batch i+1 is
    fetched before batch i trains (``pipelined``)."""
    _, tds = datasets
    runs = {}
    for dispatch in ("scan", "steps", "pipelined"):
        tr = TTrainer.from_dataset(_cfgs(paired=paired, batch=128, dispatch=dispatch)[1],
                                   tds, seed=1, device="cpu")
        tr.train(2)
        runs[dispatch] = tr
    ref = runs["scan"]
    for dispatch in ("steps", "pipelined"):
        tr = runs[dispatch]
        for a, b in zip(ref.epoch_metrics, tr.epoch_metrics, strict=True):
            assert (a.mean_loss, a.mean_acc, a.edges, a.vertices, a.num_batches) == \
                (b.mean_loss, b.mean_acc, b.edges, b.vertices, b.num_batches)
        for (name, p), q in zip(ref.state.model.named_parameters(),
                                tr.state.model.parameters()):
            assert torch.equal(p, q), name
        assert tr.state.step == ref.state.step == 2 * ref.epoch_metrics[0].num_batches
    for dispatch, tr in runs.items():
        runner = tr.epoch_runner
        assert (runner.mode, runner.graph, runner.graphs) == (dispatch, False, [])
        assert int(tr.state.step_t) == tr.state.step
        assert runner.inputs is tr.epoch_inputs
        assert torch.equal(tr.epoch_inputs.acc.sums, ref.epoch_inputs.acc.sums)


def test_device_trainer_learns_on_cpu(datasets):
    """``Trainer(on_device_sampling=True, device="cpu")`` lowers the loss over
    3 epochs on learnable data, with nothing missed or shipped."""
    _, tds = datasets
    tr = TTrainer.from_dataset(_cfgs(batch=64)[1], tds, seed=0, device="cpu")
    assert tr.sampler is None and tr.loader is None
    s = tr.train(3)
    losses = [m.mean_loss for m in tr.epoch_metrics]
    assert losses[-1] < losses[0] * 0.9, losses
    for m in tr.epoch_metrics:
        assert m.miss_rate == 0.0 and m.h2d_bytes == 0
        assert m.num_batches == -(-len(tds.train_nids) // 64)
        assert m.edges > 0 and m.vertices > m.edges
    assert tr.cache.fully_cached
    np.testing.assert_array_equal(tr.cache.cache_map, np.arange(tds.num_nodes))
    assert s["epochs"] == 3 and s["miss_rate"] == 0.0


def test_device_trainer_refuses_a_partial_cache(datasets):
    _, tds = datasets
    tr = TTrainer.from_dataset(_cfgs(capacity=tds.num_nodes - 1)[1], tds, seed=0,
                               device="cpu")
    with pytest.raises(ValueError, match="full feature set"):
        tr.train(1)


def test_device_trainer_needs_a_card_unless_cpu_is_asked(datasets, monkeypatch):
    _, tds = datasets
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TTrainer.from_dataset(_cfgs()[1], tds, seed=0)


def test_epoch_randomness_replays(datasets):
    """An epoch's permutation and draws depend on (seed, epoch) only."""
    _, tds = datasets
    cfg = _cfgs(paired=True)[1]
    a = TTrainer.from_dataset(cfg, tds, seed=4, device="cpu")
    b = TTrainer.from_dataset(cfg, tds, seed=4, device="cpu")
    b.epoch_randomness(0)
    perm_a, draws_a = a.epoch_randomness(1)
    perm_b, draws_b = b.epoch_randomness(1)
    assert torch.equal(perm_a, perm_b)
    assert all(torch.equal(x, y) for x, y in zip(draws_a, draws_b, strict=True))
    n_train = len(tds.train_nids)
    assert sorted(perm_a.tolist()) == list(range(n_train))
    nb = -(-n_train // 64)
    assert [tuple(d.shape) for d in draws_a] == [(nb, 64, 1), (nb, 192, 1)]
    assert not torch.equal(perm_a, a.epoch_randomness(0)[0])
