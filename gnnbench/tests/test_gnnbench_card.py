"""On a card (skipped without one), at a cell's own size: the control, the
program's bfloat16 path read as a run reads the program, fails the cell's
limits on every seed, and a sound run on the same seeds passes them; and a
whole run whose replayed graphs alone carry a fault (a frozen state, half
the batch) comes out not correct."""
import pytest

from gnnbench import calibrate, faults
from gnnbench.harness import Run, checks_block, checks_pass, load_cell
from gnnbench.paths import device as path


@pytest.mark.card
@pytest.mark.parametrize("cell", ["gcn-reddit.device", "sage-products.device"])
def test_control_fails_at_the_cells_size(card, cell):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wl, cfg = load_cell(cell)
    base = Run(workload=wl, config=cfg, seed=2147470000, seconds=0, trace=False, device="cuda")
    plan = [(kind, 2147470000 + i, None) for i, kind in
            enumerate(["sound", "control", "control", "control"])]
    for row in calibrate.single_device(base, plan):
        ok = checks_pass(checks_block(row["numbers"], wl["limits"]))
        assert ok == (row["kind"] == "sound"), row


@pytest.mark.card
@pytest.mark.parametrize("cell", ["gcn-reddit.device", "sage-products.device"])
@pytest.mark.parametrize("fault", ["replay_frozen", "replay_half_batch"])
def test_fault_in_the_replay_alone_is_not_correct(card, fault, cell):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wl, cfg = load_cell(cell)
    run = Run(workload=wl, config=cfg, seed=2147471000, seconds=2, trace=False, device="cuda")
    with faults.planted(fault, run):
        out = path.run_cell(run)
    block = checks_block(out["numbers"], wl["limits"])
    assert not checks_pass(block), block
    assert all(c["value"] <= c["limit"] for k, c in block.items() if not k.startswith("replay_"))
