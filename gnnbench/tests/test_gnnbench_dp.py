"""The data-parallel path on the CPU: four gloo ranks at a small size,
held to ``sage-products.dp4``'s limits.  A sound run is correct; the
exchange of gradients left out, or half of each rank's batch left out, make
``correct`` false, the latter also in the epochs after epoch 0 alone.  A
module of JAX loaded in a rank keeps the run from printing a result.  (The
ranks are spawned processes: each plants the fault itself,
``Run.fault``.)"""
import pytest

from conftest import tiny_cell
from gnnbench import run as bench_run
from gnnbench.harness import Run, checks_block, checks_pass, load_cell
from gnnbench.paths import dp_device


@pytest.fixture(scope="module")
def dp_cell(cache_root):
    wl, _ = load_cell("sage-products.dp4")
    _, cfg = tiny_cell("graphsage", "sage-products.device")
    cfg["sampler"]["batch_size"] = 64
    return {**wl, "name": "tiny.dp4", "trace_epochs": 1}, cfg, cache_root


@pytest.mark.parametrize("fault", [None, "no_exchange", "half_batch", "replay_half_batch"])
def test_dp_run(dp_cell, fault):
    wl, cfg, cache = dp_cell
    run = Run(workload=wl, config=cfg, seed=2**31 + 23, seconds=0.5, trace=False, device="cpu",
              cache=cache, fault=fault)
    out = dp_device.run_cell(run)
    block = checks_block(out["numbers"], wl["limits"])
    assert checks_pass(block) == (fault is None), block
    if fault is None:
        assert out["attempted"] > 0 and out["e2e"]["seeds_per_s"] > 0


def test_jax_in_a_rank_is_found(dp_cell):
    wl, cfg, cache = dp_cell
    run = Run(workload=wl, config=cfg, seed=2**31 + 29, seconds=0.2, trace=False, device="cpu",
              cache=cache, fault="jax_loaded")
    out = dp_device.run_cell(run)
    assert out["forbidden"] == ["jax"]
    assert bench_run.leaked(out) == ["jax"]
