"""The port's on-device sampler against ``pagraph_tpu``'s, on CPU tensors.

torch's and ``jax.random``'s streams differ, so each test reproduces the JAX
package's own ``randint``/``split``/``permutation`` calls from the same keys
and hands the integers to the port: given the same random integers the
CSRs, hops, minibatches and epoch schedules must be exactly equal.  The
graphs cover the cases the two could part on: an edge count that is not a
multiple of 8, fewer than 8 edges, trailing vertices with no in-edges when
the edge count is already a multiple of 8 (the generic draw's read at
``indices[E]``, which the port clamps), degrees 0 to 40 (take-all, draws
with replacement, several paired windows).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pagraph_tpu.graph import CSRGraph as JGraph
from pagraph_tpu.sampling import device_sampler as jds
from pagraph_tpu.train.device_epoch import _epoch_schedule
from pagraph_tpu_torch.graph import CSRGraph as TGraph
from pagraph_tpu_torch.sampling import device_sampler as tds
from pagraph_tpu_torch.train.device_epoch import epoch_schedule

HIGH = 2**31 - 1


def _graph(num_nodes, degrees, seed=0):
    """Both packages' CSRGraph from one in-degree vector and random sources."""
    rng = np.random.default_rng(seed)
    indptr = np.concatenate([[0], np.cumsum(degrees)]).astype(np.int64)
    indices = rng.integers(0, num_nodes, int(indptr[-1])).astype(np.int32)
    out_deg = np.bincount(indices, minlength=num_nodes).astype(np.int32)
    return (JGraph(indptr=indptr, indices=indices, out_degrees=out_deg),
            TGraph(indptr=indptr, indices=indices, out_degrees=out_deg))


def _tail_graph():
    """300 vertices with in-degrees 0-40; the last 20 have none, and the edge
    count is a multiple of 8, so a tail vertex's list starts at E."""
    rng = np.random.default_rng(3)
    deg = rng.integers(0, 41, 300)
    deg[:12] = np.arange(12)            # every small degree appears
    deg[280:] = 0
    deg[279] += (-deg.sum()) % 8
    assert deg.sum() % 8 == 0 and deg[279] > 0
    return _graph(300, deg)


GRAPHS = {
    "E%8!=0": lambda: _graph(40, np.r_[np.random.default_rng(1).integers(0, 9, 39), 4]),
    "E<8": lambda: _graph(10, np.r_[0, 2, 0, 1, 2, 0, 0, 0, 0, 0]),
    "tail E%8==0": _tail_graph,
}


@pytest.fixture(scope="module")
def tail():
    jg, tg = _tail_graph()
    return jg, tg, jds.DeviceCSR.from_graph(jg), tds.DeviceCSR.from_graph(tg, "cpu")


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_device_csr_matches_jax(name, paired):
    jg, tg = GRAPHS[name]()
    if name != "E%8!=0":
        assert (jg.num_edges < 8) == (name == "E<8")
    else:
        assert jg.num_edges % 8
    j = jds.DeviceCSR.from_graph(jg, paired=paired)
    t = tds.DeviceCSR.from_graph(tg, "cpu")
    assert t.num_nodes == j.num_nodes
    for f in ("indptr", "indices", "ptr_pairs"):
        got, want = getattr(t, f), _np(getattr(j, f))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f)
    assert (j.indices_rows is None) == (not paired)
    if paired:
        # JAX's host-built row table is the port's free view of indices
        np.testing.assert_array_equal(t.indices.view(-1, 8).numpy(), _np(j.indices_rows))
        assert t.nbytes() == j.nbytes() - 4 * j.indices_rows.size
    else:
        assert t.nbytes() == j.nbytes()


def test_from_graph_refuses_int32_overflow():
    class Huge:
        num_edges = 2**31
    with pytest.raises(ValueError, match="2\\^31"):
        tds.DeviceCSR.from_graph(Huge(), "cpu")


def _dst(n_nodes):
    """Every vertex (the zero-degree tail included), then repeats; every
    fifth slot masked."""
    dst = np.r_[np.arange(n_nodes), np.arange(0, n_nodes, 3)].astype(np.int32)
    mask = np.ones(dst.shape[0], bool)
    mask[::5] = False
    return dst, mask


def _jax_hop_draws(key, n, fanout, paired):
    """The integers JAX's sample_hop draws from ``key``: [n, fanout], or one
    a window of 8 slots on the paired path."""
    width = -(-fanout // 8) if paired and fanout >= 2 else fanout
    return jax.random.randint(key, (n, width), 0, jnp.int32(HIGH), dtype=jnp.int32)


@pytest.mark.parametrize("fanout,paired", [(f, False) for f in (1, 2, 3, 7)]
                         + [(f, True) for f in (2, 5, 8, 9, 17)])
def test_sample_hop_matches_jax(tail, fanout, paired):
    jg, _, jcsr, tcsr = tail
    dst, mask = _dst(jg.num_nodes)
    key = jax.random.PRNGKey(100 + fanout)
    nbr_j, m_j = jds.sample_hop(jcsr, jnp.asarray(dst), jnp.asarray(mask), fanout, key,
                                paired=paired)
    draws = _t(_jax_hop_draws(key, dst.shape[0], fanout, paired))
    assert tuple(draws.shape) == (dst.shape[0], tds.draw_width(fanout, paired))
    nbr_t, m_t = tds.sample_hop(tcsr, _t(dst), _t(mask), fanout, draws, paired=paired)
    assert nbr_t.dtype == torch.int32 and m_t.dtype == torch.bool
    np.testing.assert_array_equal(m_t.numpy(), _np(m_j))
    np.testing.assert_array_equal(nbr_t.numpy(), _np(nbr_j))
    # the tail's slots are masked, masked dst rows are, and draws were used
    assert not m_t[280:300].any() and not m_t[::5].any()
    deg = np.diff(jg.indptr)[dst]
    assert m_t.numpy()[(deg > fanout) & mask].all()


def test_sample_hop_refuses_wrong_draws(tail):
    _, _, _, tcsr = tail
    dst = torch.arange(10, dtype=torch.int32)
    mask = torch.ones(10, dtype=torch.bool)
    with pytest.raises(ValueError, match="draws"):
        tds.sample_hop(tcsr, dst, mask, 9, torch.zeros(10, 9, dtype=torch.int32),
                       paired=True)


def _jax_minibatch_draws(key, batch, fanouts, paired):
    """JAX's per-hop integers: ``split(key, hops)``, one randint a hop."""
    keys = jax.random.split(key, len(fanouts))
    return [_t(_jax_hop_draws(keys[h], n, f, paired))
            for h, (n, f) in enumerate(zip(tds.hop_sizes(batch, fanouts), fanouts))]


@pytest.mark.parametrize("paired", [False, True])
def test_sample_minibatch_device_matches_jax(tail, paired):
    jg, _, jcsr, tcsr = tail
    rng = np.random.default_rng(5)
    batch, fanouts = 40, (3, 2)
    seeds = np.r_[rng.integers(0, 300, batch - 4), 299, 298, 0, 281].astype(np.int32)
    smask = np.ones(batch, bool)
    smask[-6:] = False
    labels = rng.integers(0, 5, 300).astype(np.int32)
    key = jax.random.PRNGKey(9)
    mb_j = jds.sample_minibatch_device(jcsr, jnp.asarray(seeds), jnp.asarray(smask), 2,
                                       fanouts, key, labels=jnp.asarray(labels), paired=paired)
    mb_t = tds.sample_minibatch_device(tcsr, _t(seeds), _t(smask), 2, fanouts,
                                       _jax_minibatch_draws(key, batch, fanouts, paired),
                                       labels=_t(labels), paired=paired)
    assert [x.shape[0] for x in mb_t.layer_nids] == [batch * 12, batch * 4, batch]
    for a, b in zip(mb_t.layer_nids + mb_t.layer_mask, mb_j.layer_nids + mb_j.layer_mask):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    np.testing.assert_array_equal(mb_t.labels.numpy(), _np(mb_j.labels))
    for bt, bj in zip(mb_t.blocks, mb_j.blocks):
        assert bt.prefix_layout and bj.prefix_layout
        for f in ("neigh_pos", "neigh_mask", "self_pos"):
            np.testing.assert_array_equal(getattr(bt, f).numpy(), _np(getattr(bj, f)),
                                          err_msg=f)
        assert bt.neigh_pos.dtype == bt.self_pos.dtype == torch.int32


@pytest.mark.parametrize("n_train,batch", [(1000, 128), (256, 128)])
def test_epoch_schedule_matches_jax(n_train, batch):
    """With a tail batch (1000 = 7 x 128 + 104) the permutation wraps and
    the wrapped seeds are masked; without one nothing is."""
    train_nids = np.random.default_rng(2).permutation(3000)[:n_train].astype(np.int32)
    key = jax.random.PRNGKey(41)
    seeds_j, mask_j, _ = _epoch_schedule(key, jnp.asarray(train_nids), batch)
    perm = jax.random.permutation(jax.random.split(key)[0], n_train)
    seeds_t, mask_t = epoch_schedule(_t(perm), _t(train_nids), batch)
    assert seeds_t.dtype == torch.int32
    np.testing.assert_array_equal(seeds_t.numpy(), _np(seeds_j))
    np.testing.assert_array_equal(mask_t.numpy(), _np(mask_j))
    assert int(mask_t.sum()) == n_train
