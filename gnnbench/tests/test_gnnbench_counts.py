"""The benchmark's own counts: model FLOPs a step and ``take_rows``' least
bytes against hand-worked shapes, and the trace reduction on a hand-made
trace."""
import pytest
import torch

from gnnbench import check, harness
from gnnbench.flops import gcn, graphsage
from gnnbench.metrics import Readings
from gnnbench.metrics import (device_idle_pct, mfu, step_device_ms, take_rows_roofline_pct,
                              allreduce_ms_per_step, enqueue_ms_per_epoch, capture_s)
from gnnbench.trace import SPAN, Trace


def test_sage_flops_by_hand():
    m = {"n_layers": 2, "hidden": 256, "feat_dim": 100, "n_classes": 47,
         "skip_connection": False}
    rows = [1081344, 180224, 16384, 1024]
    # forward: 2 linears a layer; weight grads the same again; input grads
    # for layers 1 and 2
    fwd = [2 * 2 * 180224 * 100 * 256, 2 * 2 * 16384 * 256 * 256, 2 * 2 * 1024 * 256 * 47]
    assert graphsage.step_flops(m, rows) == 2 * sum(fwd) + fwd[1] + fwd[2] == 49942626304


def test_gcn_flops_by_hand():
    m = {"n_layers": 1, "hidden": 32, "feat_dim": 602, "n_classes": 41, "skip_connection": True}
    fwd = [2 * 18000 * 602 * 32, 2 * 6000 * 64 * 41]
    assert gcn.step_flops(m, [54000, 18000, 6000]) == 2 * sum(fwd) + fwd[1] == 1481472000


def test_layer_rows_of_the_cells():
    _, sage = harness.load_cell("sage-products.device")
    _, red = harness.load_cell("gcn-reddit.device")
    assert check.layer_rows(sage) == [1081344, 180224, 16384, 1024]
    assert check.layer_rows(red) == [54000, 18000, 6000]


def test_take_rows_bytes_by_hand():
    class Inp:
        def batches(self, config, seed, e):
            assert e == 5
            for ids in (torch.tensor([3, 3, 0, 7, 3]), torch.tensor([1, 2, 1, 2, 1])):
                yield [(ids, None)], None, None, None, None

    cfg = {"data": {"feat_dim": 10}}
    # step 0: 5 ids, 5 rows out, 3 distinct rows in; step 1: 2 distinct
    want = (4 * 5 + 4 * 5 * 10 + 4 * 3 * 10) + (4 * 5 + 4 * 5 * 10 + 4 * 2 * 10)
    assert check.take_rows_bytes(Inp(), cfg, 0, [5]) == want


def events():
    ev = [{"ph": "X", "cat": "user_annotation", "name": SPAN, "ts": 100.0, "dur": 1000.0,
           "pid": 1, "tid": 1},
          {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 700.0, "dur": 200.0,
           "pid": 1, "tid": 1},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 110.0,
           "dur": 40.0, "pid": 1, "tid": 1}]
    for name, ts, dur in [("assemble_kernel<float>", 150, 100), ("gemm", 200, 300),
                          ("ncclDevKernel_AllReduce_Sum_f32", 600, 50), ("gemm", 950, 100),
                          ("late", 1090, 50)]:
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": float(ts),
                   "dur": float(dur), "pid": 0, "tid": 7})
    return ev


def test_trace_reduction_by_hand():
    tr = Trace(events())
    assert tr.window_s == pytest.approx(1e-3)
    # union: [150, 500], [600, 650], [950, 1050], [1090, 1100] clipped
    assert tr.busy_s == pytest.approx((350 + 50 + 100 + 10) * 1e-6)
    assert tr.kernel_seconds("assemble_kernel") == pytest.approx(100e-6)
    assert tr.kernel_seconds() == pytest.approx(600e-6)
    gaps = tr.idle_gaps()
    assert gaps[0] == ["aten::item", pytest.approx(300e-6)]      # [650, 950]
    assert [g[1] for g in gaps] == pytest.approx([300e-6, 100e-6, 50e-6, 40e-6])
    assert tr.device_ops()[0] == ["gemm", pytest.approx(400e-6)]


def test_a_trace_without_kernels_fails():
    with pytest.raises(RuntimeError, match="no CUDA kernel"):
        Trace([e for e in events() if e["cat"] != "kernel"])


def test_metric_readers_by_hand():
    tr = Trace(events())
    r = Readings(trace=tr, epochs=2, steps=4, flops=6.7e9, take_rows_bytes=3.35e5,
                 enqueue_s=0.004, enqueue_count=2, capture_s=1.5)
    assert device_idle_pct.read(r) == pytest.approx(100 * (1 - 510 / 1000))
    assert step_device_ms.read(r) == pytest.approx(0.6 / 4)
    assert mfu.read(r) == pytest.approx(100 * 6.7e9 / (1e-3 * 67e12))
    assert take_rows_roofline_pct.read(r) == pytest.approx(100 * 1e-7 / 100e-6)
    assert allreduce_ms_per_step.read(r) == pytest.approx(0.05 / 4)
    assert enqueue_ms_per_epoch.read(r) == pytest.approx(2.0)
    assert capture_s.read(r) == 1.5
    none = Readings(trace=tr, epochs=2, steps=4, flops=0, take_rows_bytes=None,
                    enqueue_s=0, enqueue_count=0, capture_s=None)
    assert mfu.read(none) is None and take_rows_roofline_pct.read(none) is None
