"""The port's gather kernels (plain versions, as run on the CPU) and block
aggregations against the JAX package.

On the CPU every wrapper of ``pagraph_tpu_torch.ops.gather_kernels`` runs its
plain version; the CUDA kernels are held against those same plain versions on
the card by ``chip_smoke.py``.  Here the plain versions and the autograd
Functions around them are held against the Pallas kernels in interpret mode,
``jnp.take``, ``pagraph_tpu.ops.aggregate`` and ``jax.vjp``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pagraph_tpu as pg
from pagraph_tpu.ops import aggregate as jagg
from pagraph_tpu.ops.pallas_gather import gather_mean_pallas, gather_rows_pallas
from pagraph_tpu.sampling.block import Block as JBlock
from pagraph_tpu.sampling.sampler import NeighborSampler as JSampler
from pagraph_tpu_torch.ops import aggregate as tagg
from pagraph_tpu_torch.ops import gather_kernels as gk
from pagraph_tpu_torch.sampling.block import Block as TBlock


def _t(x):
    return torch.from_numpy(np.array(x))


def _tblock(b) -> TBlock:
    return TBlock(neigh_pos=np.asarray(b.neigh_pos), neigh_mask=np.asarray(b.neigh_mask),
                  self_pos=np.asarray(b.self_pos),
                  prefix_layout=b.prefix_layout).to("cpu")


@pytest.mark.parametrize("d", [128, 100, 32])
def test_gather_rows_matches_jax(d):
    """Exact: a gather copies values.  D=128 also runs the Pallas kernel
    (it needs 128-lane rows); D=100 and 32 are the main path's widths."""
    rng = np.random.default_rng(d)
    src = rng.normal(size=(500, d)).astype(np.float32)
    ids = rng.integers(0, 500, size=300).astype(np.int32)
    got = gk.gather_rows(_t(src), _t(ids)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.take(src, ids, axis=0)))
    if d % 128 == 0:
        want = gather_rows_pallas(jnp.asarray(src), jnp.asarray(ids), tile=64,
                                  interpret=True)
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("fanout", [2, 4])
def test_gather_mean_matches_pallas(fanout):
    """rtol 1e-5: the Pallas kernel sums the fan-out in its own order."""
    rng = np.random.default_rng(fanout)
    src = rng.normal(size=(400, 128)).astype(np.float32)
    pos = rng.integers(0, 400, size=(200, fanout)).astype(np.int32)
    mask = rng.random((200, fanout)) > 0.3
    want = gather_mean_pallas(jnp.asarray(src), jnp.asarray(pos), jnp.asarray(mask),
                              fanout=fanout, tile=64, interpret=True)
    got = gk.gather_reduce(_t(src), _t(pos), _t(mask), "mean").numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["mean", "sum"])
@pytest.mark.parametrize("d", [100, 32])
def test_gather_reduce_matches_formula(kind, d):
    """rtol 1e-6: float32 sums of at most 3 terms; empty rows give zeros."""
    rng = np.random.default_rng(7)
    src = rng.normal(size=(300, d)).astype(np.float32)
    pos = rng.integers(0, 300, size=(150, 3)).astype(np.int32)
    mask = rng.random((150, 3)) > 0.4
    mask[:5] = False
    want = (src[pos] * mask[..., None]).sum(1)
    if kind == "mean":
        want = want / np.maximum(mask.sum(1, keepdims=True), 1)
    got = gk.gather_reduce(_t(src), _t(pos), _t(mask), kind).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert not got[:5].any()


@pytest.fixture(scope="module")
def sampled(small_ds):
    cfg = pg.SamplerConfig(batch_size=64, fanout=3, num_hops=2, seed=3)
    s = JSampler(small_ds.graph, small_ds.train_nids, cfg, backend="numpy")
    return s.sample(small_ds.train_nids[:64])


@pytest.mark.parametrize("kind", ["mean", "sum"])
@pytest.mark.parametrize("bi", [0, 1])
def test_block_ops_match_jax(sampled, kind, bi):
    """Values and gradients of block_aggregate and block_self against the
    JAX functions and jax.grad on a host-sampled (non-prefix) block.
    rtol 1e-5 / atol 1e-6: float32 reassociation of short sums."""
    jb = jax.tree.map(np.asarray, sampled.blocks[bi])
    n_src = sampled.layer_nids[bi].shape[0]
    rng = np.random.default_rng(bi)
    h = rng.normal(size=(n_src, 24)).astype(np.float32)
    w_agg = rng.normal(size=(jb.neigh_pos.shape[0], 24)).astype(np.float32)
    w_self = rng.normal(size=(jb.neigh_pos.shape[0], 24)).astype(np.float32)

    def jloss(hh):
        a = jagg.block_aggregate(hh, jb, kind)
        s = jagg.block_self(hh, jb)
        return jnp.sum(a * w_agg) + jnp.sum(s * w_self), (a, s)

    (_, (ja, js)), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(h))
    th = _t(h).requires_grad_(True)
    tb = _tblock(jb)
    ta = tagg.block_aggregate(th, tb, kind)
    ts = tagg.block_self(th, tb)
    ((ta * _t(w_agg)).sum() + (ts * _t(w_self)).sum()).backward()
    np.testing.assert_allclose(ta.detach().numpy(), np.asarray(ja), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ts.detach().numpy(), np.asarray(js))
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["mean", "sum"])
def test_prefix_layout_matches_jax(kind):
    """Prefix layout: self rows and neighbor messages are contiguous slices."""
    rng = np.random.default_rng(11)
    n, f, d = 40, 3, 16
    h = rng.normal(size=(n + n * f, d)).astype(np.float32)
    mask = rng.random((n, f)) > 0.3
    jb = JBlock(neigh_pos=(n + np.arange(n * f, dtype=np.int32)).reshape(n, f),
                neigh_mask=mask, self_pos=np.arange(n, dtype=np.int32),
                prefix_layout=True)
    tb = _tblock(jb)
    np.testing.assert_allclose(
        tagg.block_aggregate(_t(h), tb, kind).numpy(),
        np.asarray(jagg.block_aggregate(jnp.asarray(h), jb, kind)), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tagg.block_self(_t(h), tb).numpy(),
                                  np.asarray(jagg.block_self(jnp.asarray(h), jb)))


@pytest.mark.parametrize("kind", ["mean", "sum"])
def test_backward_scatter_adds_match_vjp(kind):
    """The autograd Functions' backwards (plain scatter-adds on the CPU)
    against jax.vjp of jnp.take and of the masked reduction.  rtol 1e-5:
    scatter-adds sum repeated indices in another order."""
    rng = np.random.default_rng(5)
    src = rng.normal(size=(80, 20)).astype(np.float32)
    ids = rng.integers(0, 80, size=200).astype(np.int32)      # repeats
    pos = rng.integers(0, 80, size=(120, 4)).astype(np.int32)
    mask = rng.random((120, 4)) > 0.3
    g_rows = rng.normal(size=(200, 20)).astype(np.float32)
    g_red = rng.normal(size=(120, 20)).astype(np.float32)

    _, vjp_rows = jax.vjp(lambda s: jnp.take(s, ids, axis=0), jnp.asarray(src))
    jb = JBlock(neigh_pos=pos, neigh_mask=mask, self_pos=np.zeros(120, np.int32))
    _, vjp_red = jax.vjp(lambda s: jagg.block_aggregate(s, jb, kind), jnp.asarray(src))

    ts = _t(src).requires_grad_(True)
    gk.GatherRows.apply(ts, _t(ids)).backward(_t(g_rows))
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(vjp_rows(jnp.asarray(g_rows))[0]),
                               rtol=1e-5, atol=1e-6)
    ts.grad = None
    gk.GatherReduce.apply(ts, _t(pos), _t(mask), kind).backward(_t(g_red))
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(vjp_red(jnp.asarray(g_red))[0]),
                               rtol=1e-5, atol=1e-6)


def test_wrappers_refuse_bad_input():
    src = torch.zeros(10, 4)
    pos = torch.zeros(3, 2, dtype=torch.int32)
    mask = torch.ones(3, 2, dtype=torch.bool)
    with pytest.raises(NotImplementedError):
        tagg.block_aggregate(src, TBlock(pos, mask, pos[:, 0].contiguous()), "max")
    with pytest.raises(ValueError):
        gk.gather_reduce(src, pos, mask, "median")
    # neither CPU nor CUDA: no plain version, no kernel
    with pytest.raises(ValueError):
        gk.gather_rows(src.to("meta"), pos[:, 0].to("meta"))
