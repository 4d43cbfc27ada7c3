"""The port's halo exchange (``pagraph_tpu_torch.parallel.halo``) against
``pagraph_tpu.parallel.halo`` on the same numpy inputs.

* ``shard_features``, ``HaloPlanner.plan`` and ``halo_width_for`` equal
  JAX's to the bit, and ``device_halo_plan`` (on CPU tensors) equals JAX's
  jitted one and the host planner's, on random ids and on ids all owned by
  one rank, which overflow the static width ``H`` (the first ``H`` by
  position are kept).
* ``exchange_features`` on 2 and 4 gloo ranks (one ``spawn_local`` each,
  ``tests/torch_dp_worker.py`` ``exchange_ranks``) equals JAX's
  ``exchange_features`` in ``shard_map`` on ``make_mesh(2)`` and
  ``make_mesh(4)``, then ``dequantize_fused``, to the bit at the f32, bf16
  and int8 tiers (int8 with its scale), dropped rows zero.
"""
import os
from functools import partial

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from pagraph_tpu.parallel import halo as jhalo
from pagraph_tpu.parallel.mesh import make_mesh
from pagraph_tpu.storage.cache import dequantize_fused
from pagraph_tpu_torch.parallel import halo as thalo
from pagraph_tpu_torch.parallel import spawn_local
from pagraph_tpu_torch.storage.cache import bucket_size
from tests.torch_dp_worker import exchange_ranks

N, D, CAP0 = 1000, 12, 96


def plan_inputs(kind, world, seed):
    """``(nids, mask)`` of one rank's batch: ``random`` ids with a masked
    tail, or ``skewed`` ids all owned by rank 0 (they overflow ``H``)."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        nids = rng.integers(0, N, size=CAP0)
    else:
        nids = world * rng.integers(0, N // world, size=CAP0)
    mask = np.ones(CAP0, dtype=bool)
    mask[-7:] = False
    mask[rng.integers(0, CAP0, size=5)] = False
    return nids.astype(np.int64), mask


def assert_plans_equal(got, want):
    for name in ("req", "slot", "valid"):
        g, w = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype and np.array_equal(g, w), name


@pytest.mark.parametrize("world", [1, 2, 4])
def test_shard_features_matches_jax(world):
    feats = np.random.default_rng(0).normal(size=(N + 3, D)).astype(np.float32)
    got, want = thalo.shard_features(feats, world), jhalo.shard_features(feats, world)
    assert got[1] == want[1] and np.array_equal(got[0], want[0])
    for r in range(world):
        ids = thalo.shard_ids(r, world, N + 3)
        assert np.array_equal(got[0][r, :len(ids)], feats[ids])


@pytest.mark.parametrize("cap0,world,slack", [(96, 2, 1.5), (54_000, 2, 1.5),
                                              (54_000, 4, 1.5), (100_000, 8, 3.0),
                                              (700, 4, 1.0), (10, 3, 8.0)])
def test_halo_width_matches_jax(cap0, world, slack):
    assert thalo.halo_width_for(cap0, world, slack) == jhalo.halo_width_for(cap0, world, slack)
    assert bucket_size(cap0, cap0) == jhalo.bucket_size(cap0, cap0)


@pytest.mark.parametrize("kind,world,width", [("random", 2, 64), ("random", 4, 32),
                                              ("skewed", 2, 16), ("skewed", 4, 8)])
def test_planners_match_jax(kind, world, width):
    """The host planner and the device planner equal JAX's to the bit; on
    skewed ids exactly ``H`` requests of the overloaded owner survive."""
    nids, mask = plan_inputs(kind, world, seed=world)
    shard_rows = -(-N // world)
    want = jhalo.HaloPlanner(world, shard_rows, width).plan(nids, mask)
    got = thalo.HaloPlanner(world, shard_rows, width).plan(nids, mask)
    assert_plans_equal(got, want)
    jdev = jax.jit(lambda n, m: jhalo.device_halo_plan(n, m, shard_rows, world, width))(
        jnp.asarray(nids, jnp.int32), jnp.asarray(mask))
    assert_plans_equal(jdev, want)
    tdev = thalo.device_halo_plan(torch.from_numpy(nids.astype(np.int32)),
                                  torch.from_numpy(mask), world, width)
    assert_plans_equal(tdev, want)
    if kind == "skewed":
        assert int(np.asarray(want.valid).sum()) == width < mask.sum()
    assert np.array_equal(thalo.src_rows(got),
                          np.where(want.valid, want.slot, -1).astype(np.int32))
    assert torch.equal(thalo.src_rows(tdev), torch.from_numpy(thalo.src_rows(got)))


def jax_exchange(world, shards, plans, scale):
    """JAX's ``exchange_features`` in ``shard_map`` over ``make_mesh(world)``,
    then ``dequantize_fused``: ``[world, cap0, D]`` f32."""
    stacked = jax.tree.map(lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]), *plans)

    @jax.jit
    @partial(shard_map, mesh=make_mesh(world), in_specs=(P("dp"), P("dp")),
             out_specs=P("dp"), check_vma=False)
    def go(shard, plan):
        plan = jax.tree.map(lambda x: x[0], plan)
        return dequantize_fused(jhalo.exchange_features(shard[0], plan, "dp"), scale)[None]

    return np.asarray(go(jnp.asarray(shards), stacked))


@pytest.mark.parametrize("world", [2, 4])
def test_exchange_matches_jax_on_gloo_ranks(world, tmp_path):
    """Every tier, random and skewed batches, one spawn of ``world`` gloo
    ranks: the port's rows equal JAX's to the bit, dropped rows zero."""
    rng = np.random.default_rng(10 + world)
    feats = rng.normal(size=(N, D)).astype(np.float32)
    scale = np.abs(feats).max(axis=0) / 127.0
    tiers = {"float32": (feats, None),
             "bfloat16": (feats.astype(ml_dtypes.bfloat16), None),
             "int8": (np.clip(np.rint(feats / scale), -127, 127).astype(np.int8), scale)}
    shard_rows = -(-N // world)
    cases, want = {}, {}
    for kind, width in (("random", 64 if world == 2 else 32), ("skewed", 16)):
        planner = jhalo.HaloPlanner(world, shard_rows, width)
        plans = [planner.plan(*plan_inputs(kind, world, seed=100 * world + r))
                 for r in range(world)]
        for tier, (table, sc) in tiers.items():
            shards, _ = jhalo.shard_features(table, world)
            name = f"{kind}_{tier}"
            want[name] = jax_exchange(world, shards, plans, sc)
            tshards = (torch.from_numpy(shards.astype(np.float32)).to(torch.bfloat16)
                       if tier == "bfloat16" else torch.from_numpy(shards))
            cases[name] = dict(
                shards=tshards, scale=None if sc is None else torch.from_numpy(sc),
                plans=[tuple(torch.from_numpy(np.asarray(a)) for a in (p.req, p.slot, p.valid))
                       for p in plans])
    path = str(tmp_path / "cases.pt")
    torch.save(cases, path)
    spawn_local(exchange_ranks, world, path, str(tmp_path), backend="gloo", timeout=180)
    for r in range(world):
        got = torch.load(os.path.join(tmp_path, f"exchange_rank{r}.pt"))
        for name, w in want.items():
            g = got[name]
            assert g.dtype == torch.float32 and g.shape == (CAP0, D)
            assert np.array_equal(g.numpy(), w[r]), (name, r)
    dropped = ~np.asarray(cases["skewed_float32"]["plans"][0][2].numpy())
    assert np.all(want["skewed_float32"][0][dropped] == 0.0) and dropped.sum() > 7 + 5
