"""``pagraph_tpu_torch/utils/platform.py`` against
``pagraph_tpu/utils/platform.py``: the threaded random fill bit-equal, the
host allocator helpers, and the device-memory budget on stubbed CUDA memory
calls (keys, types and the JAX package's arithmetic), which a CPU device, or
no card, refuses."""
import types

import numpy as np
import pytest
import torch

from pagraph_tpu.utils import platform as jplatform
from pagraph_tpu_torch import utils as tutils
from pagraph_tpu_torch.utils import platform as tplatform

GIB = 1 << 30


@pytest.mark.parametrize("shape,dtype,seed,threads", [
    ((1000,), "float32", 0, 4), ((37, 11), "float64", 5, 3), ((5, 7, 3), "float32", 9, 1),
    ((3,), "float32", 2, 8)])
def test_parallel_random_bit_equal(shape, dtype, seed, threads):
    t = tplatform.parallel_random(shape, dtype=dtype, seed=seed, threads=threads)
    j = jplatform.parallel_random(shape, dtype=dtype, seed=seed, threads=threads)
    assert t.shape == shape and t.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(t, j)


def test_host_allocator_helpers_run():
    tplatform.tune_host_allocator(1 << 20, threads=2)
    assert tplatform._allocator_tuned
    tplatform.tune_host_allocator(1 << 20)      # once a process: a no-op now
    tplatform.trim_host_allocator()


def _stub_card(monkeypatch, free, total, in_use):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (free, total))
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device=None: in_use)


def _jax_device(stats):
    return types.SimpleNamespace(memory_stats=lambda: stats)


@pytest.mark.parametrize("free,in_use", [(40 * GIB, 2 * GIB), (GIB // 2, 0),
                                         (12_345_678_901, 987_654_321)])
def test_device_memory_stats_keys_types_and_budget(monkeypatch, free, in_use):
    """The stats carry the JAX package's keys as ints; ``free_hbm_bytes`` is
    JAX's ``bytes_limit - bytes_in_use - reserve`` (floored at 0) on the
    same stats, which is the card's free bytes less the reserve."""
    _stub_card(monkeypatch, free, 80 * GIB, in_use)
    for device in (None, "cuda", torch.device("cuda", 0)):
        s = tplatform.device_memory_stats(device)
        j = jplatform.device_memory_stats(_jax_device(dict(s)))
        assert set(s) == set(j) == {"bytes_in_use", "bytes_limit"}
        assert all(type(v) is int for v in s.values()) and s == j
        assert s == {"bytes_in_use": in_use, "bytes_limit": in_use + free}
    for reserve in (0, 1 << 20, GIB, free, free + 1):
        want = jplatform.free_hbm_bytes(_jax_device(tplatform.device_memory_stats()),
                                        reserve=reserve)
        assert tplatform.free_hbm_bytes(reserve=reserve) == want == max(0, free - reserve)
    assert tplatform.free_hbm_bytes() == max(0, free - GIB)     # the default reserve
    assert tutils.free_hbm_bytes is tplatform.free_hbm_bytes
    assert tutils.device_memory_stats is tplatform.device_memory_stats


def test_cache_sizes_from_free_hbm_bytes(monkeypatch):
    """``FeatureCache.auto_capacity`` is ``free_hbm_bytes(device, reserve)``
    over the tier's row bytes, as before the budget moved here."""
    from pagraph_tpu_torch.data.synthetic import synthetic_dataset
    from pagraph_tpu_torch.storage import cache as tcache
    from pagraph_tpu_torch.storage.feature_store import FeatureStore

    ds = synthetic_dataset(num_nodes=300, num_edges=1500, feat_dim=16, num_classes=3)
    store = FeatureStore.build(ds.graph, ds.features)
    c = tcache.FeatureCache(store, ["features"], ds.graph, device="cpu", dtype="bfloat16",
                            reserve_bytes=1 << 20)
    seen = []

    def budget(device, reserve):
        seen.append((device, reserve))
        return 16 * 2 * 100 + 5
    monkeypatch.setattr(tcache, "free_hbm_bytes", budget)
    assert c.auto_capacity() == 100 and c.auto_capacity(reserve_bytes=7) == 100
    assert seen == [(c.device, 1 << 20), (c.device, 7)]


def test_a_cpu_device_or_no_card_raises(monkeypatch):
    with pytest.raises(ValueError, match="give a capacity on a CPU device"):
        tplatform.device_memory_stats("cpu")
    with pytest.raises(ValueError):
        tplatform.free_hbm_bytes(torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tplatform.free_hbm_bytes()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tplatform.device_memory_stats()
