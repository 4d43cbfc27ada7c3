"""The harness's device path on the CPU at a small size, held to the real
cells' limits: a sound run is correct; the control (the program's bfloat16
path) and each fault a cell can have, planted in the program underneath the
run, make ``correct`` false, also where it is planted in the epochs after
the eager epoch 0 alone (``replay_``: on a card, the replayed graphs)."""
import pytest

from conftest import tiny_cell
from gnnbench import faults
from gnnbench.harness import Run, checks_block, checks_pass
from gnnbench.paths import device as path


def run_tiny(wl, cfg, fault=None, dtype=None, seed=2**31 + 17):
    run = Run(workload=wl, config=cfg, seed=seed, seconds=0.2, trace=False, device="cpu")
    if dtype:
        cfg = {**cfg, "train": {**cfg["train"], "dtype": dtype}}
        run.config = cfg
    if fault:
        with faults.planted(fault, run):
            out = path.run_cell(run)
    else:
        out = path.run_cell(run)
    block = checks_block(out["numbers"], wl["limits"])
    return checks_pass(block), block, out


def test_sound_run_is_correct(tiny):
    ok, block, out = run_tiny(*tiny)
    assert ok, block
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["e2e"]["seeds_per_s"] > 0 and out["e2e"]["setup_s"] > 0


def test_control_is_not_correct(tiny):
    ok, block, _ = run_tiny(*tiny, dtype="bfloat16")
    assert not ok, block


@pytest.mark.parametrize("fault", ["frozen", "half_batch", "altered_fetch", "altered_sample",
                                   "replay_frozen"])
def test_fault_is_not_correct(tiny, fault):
    ok, block, _ = run_tiny(*tiny, fault=fault)
    assert not ok, (fault, block)


def test_replay_fault_leaves_the_first_steps_sound(tiny):
    """A fault of the replayed epochs alone fails only the replay's numbers:
    the first-step check alone would pass it."""
    ok, block, _ = run_tiny(*tiny, fault="replay_frozen")
    assert not ok
    failed = {k for k, c in block.items() if not c["value"] <= c["limit"]}
    assert failed and all(k.startswith("replay_") for k in failed), block


def test_replay_half_batch_is_not_correct():
    """Half the batch left out in the replayed epochs alone, held to
    ``gcn-reddit.device``'s limits (its epoch's mean loss).  The SAGE cell
    holds it by the change over its 193-step epoch, which a tiny epoch of
    six steps moves too little: the card test covers it at the cell's size."""
    ok, block, _ = run_tiny(*tiny_cell("gcn", "gcn-reddit.device"), fault="replay_half_batch")
    assert not ok, block
