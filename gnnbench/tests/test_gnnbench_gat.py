"""The GAT configuration's benchmark pieces: ``flops/gat.py``'s FLOPs and
the attention kernels' least bytes against hand-worked counts of a tiny
model, ``gat_attention_roofline_pct`` read from a hand-made trace, and a
tiny GAT cell through the harness's device path on the CPU, held to the
``gat-products.device`` cell's limits: a sound run is correct, the control
(bfloat16 compute) and a planted fault are not."""
import copy

import pytest

from conftest import tiny_cell
from gnnbench import check, faults, harness
from gnnbench.flops import gat
from gnnbench.harness import Run, checks_block, checks_pass
from gnnbench.metrics import Readings, gat_attention_roofline_pct
from gnnbench.paths import gat_device
from gnnbench.trace import SPAN, Trace

TINY = {"n_layers": 1, "hidden": 3, "num_heads": 2, "feat_dim": 5, "n_classes": 4,
        "residual": True}
ROWS = [18, 6, 2]            # batch 2, fan-out 2 at both blocks


def test_gat_flops_by_hand():
    # block 0: projection 18 x 5 -> 6, skip 6 x 5 -> 6; block 1: 6 x 6 -> 8,
    # skip 2 x 6 -> 4; block 0 twice (no input gradient), block 1 three times
    b0 = 2 * 18 * 5 * 6 + 2 * 6 * 5 * 6
    b1 = 2 * 6 * 6 * 8 + 2 * 2 * 6 * 4
    assert gat.step_flops(TINY, ROWS) == 2 * b0 + 3 * b1 == 4896
    plain = {**TINY, "residual": False}
    assert gat.step_flops(plain, ROWS) == 2 * (2 * 18 * 5 * 6) + 3 * (2 * 6 * 6 * 8)


def test_gat_flops_of_the_cell():
    _, cfg = harness.load_cell("gat-products.device")
    rows = check.layer_rows(cfg)
    assert rows == [681472, 61952, 5632, 512]
    assert gat.step_flops(cfg["model"], rows) == 261880283136


def test_attention_bytes_by_hand():
    # a block of S source rows, n destinations, v valid slots, K heads of H
    # (kh = K H): forward the rows of z of the destinations and the valid
    # slots, mask, vectors, output, stats; backward the same rows of z, g,
    # output, stats, mask, vectors, z's whole gradient, the vectors'
    # gradients
    def block(s, n, v, kh, heads):
        z = 4 * (n + v) * kh
        fwd = z + (s - n) + 8 * kh + 4 * n * kh + 8 * n * heads
        bwd = z + 8 * n * kh + 8 * n * heads + (s - n) + 8 * kh + 4 * s * kh + 8 * kh
        return fwd + bwd

    assert gat.attention_bytes(TINY, ROWS) == block(18, 6, 12, 6, 2) + block(6, 2, 4, 8, 2) \
        == 3120
    assert gat.attention_bytes(TINY, ROWS, [5, 1]) == block(18, 6, 5, 6, 2) + block(
        6, 2, 1, 8, 2) == 3120 - 2 * 4 * (7 * 6 + 3 * 8)


def test_attention_bytes_of_the_traced_steps():
    """``paths/gat_device.py`` counts each step's valid slots: on a
    one-block model they are the sampler's valid edges.  The same pass
    gives ``check.take_rows_bytes``'s count."""
    from gnnbench import data
    from gnnbench.paths import gat_device
    from gnnbench.reference import sampler

    _, cfg = tiny_gat()
    cfg = {**cfg, "model": {**cfg["model"], "n_layers": 0},
           "sampler": {"batch_size": 128, "fanouts": [6]}}
    inp = check.Inputs(data.generate(cfg["data"]), "cpu")
    want = sum(gat.attention_bytes(cfg["model"], check.layer_rows(cfg),
                                   [sampler.valid_edge_count(layers)])
               for e in (2, 3) for layers, *_ in inp.batches(cfg, 5, e))
    assert gat_device.traced_bytes(inp, cfg, 5, [2, 3]) == (
        check.take_rows_bytes(inp, cfg, 5, [2, 3]), want)
    every = gat.attention_bytes(cfg["model"], check.layer_rows(cfg)) * 2 * inp.num_batches(cfg)
    assert want < every


def events(kernels):
    ev = [{"ph": "X", "cat": "user_annotation", "name": SPAN, "ts": 0.0, "dur": 1000.0,
           "pid": 1, "tid": 1}]
    for name, ts, dur in kernels:
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": float(ts),
                   "dur": float(dur), "pid": 0, "tid": 7})
    return ev


def test_gat_attention_roofline_read_by_hand():
    tr = Trace(events([("void (anonymous namespace)::gat_attention_fwd_kernel<4, 1>", 10, 200),
                       ("gemm", 300, 100),
                       ("void (anonymous namespace)::gat_attention_bwd_kernel<4, 1>", 500, 300),
                       ("(anonymous namespace)::gat_attention_bwd_reduce_kernel", 850, 20)]))
    r = Readings(trace=tr, epochs=1, steps=2, flops=1.0, take_rows_bytes=None, enqueue_s=0,
                 enqueue_count=0, capture_s=None)
    assert gat_attention_roofline_pct.read(r) is None        # no bytes counted
    r.gat_attention_bytes = 1.5e9
    assert gat_attention_roofline_pct.read(r) == pytest.approx(100 * 1.5e9 / 3.35e12 / 520e-6)
    none = Readings(trace=Trace(events([("gemm", 0, 10)])), epochs=1, steps=2, flops=1.0,
                    take_rows_bytes=None, enqueue_s=0, enqueue_count=0, capture_s=None)
    none.gat_attention_bytes = 1.5e9
    assert gat_attention_roofline_pct.read(none) is None


def tiny_gat():
    wl, cfg = tiny_cell("graphsage", "gat-products.device")
    wl = copy.deepcopy(wl)
    wl["name"] = "tiny.gat"
    cfg = {**cfg, "name": "tiny-gat",
           "model": {"arch": "gat", "n_layers": 2, "hidden": 8, "num_heads": 2, "feat_dim": 12,
                     "n_classes": 5, "dropout": 0.5, "residual": True,
                     "feature_dropout": False},
           "sampler": {"batch_size": 128, "fanouts": [3, 4, 5]},
           "train": {"lr": 0.001, "dtype": "float32"}}
    return wl, cfg


@pytest.mark.parametrize("variant", ["sound", "control", "half_batch"])
def test_tiny_gat_cell(variant, cache_root):
    wl, cfg = tiny_gat()
    if variant == "control":
        cfg = {**cfg, "train": {**cfg["train"], "dtype": "bfloat16"}}
    run = Run(workload=wl, config=cfg, seed=2**31 + 29, seconds=0.2, trace=False,
              device="cpu", cache=cache_root)
    take_rows_bytes = check.take_rows_bytes
    if variant == "half_batch":
        with faults.planted("half_batch", run):
            out = gat_device.run_cell(run)
    else:
        out = gat_device.run_cell(run)
    assert check.take_rows_bytes is take_rows_bytes
    ok = checks_pass(checks_block(out["numbers"], wl["limits"]))
    assert ok == (variant == "sound"), out["numbers"]
