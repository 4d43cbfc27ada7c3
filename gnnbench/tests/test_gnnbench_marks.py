"""``marks.py`` and the six metrics that read it, on synthetic traces: a
sound sequence of phase marks, a missing or foreign mark, a data-parallel
epoch with its ``sync`` phase, and a trace with no marks at all."""
import importlib

import pytest

from gnnbench import marks
from gnnbench.metrics import Readings
from gnnbench.trace import SPAN, Trace

METRICS = ("sample_ms_per_step", "fetch_ms_per_step", "forward_ms_per_step",
           "backward_ms_per_step", "optimizer_ms_per_step", "epoch_gap_ms")
STEP = ("sample", "fetch", "forward", "backward", "optimizer", "accumulate")
# kernel microseconds a step of each phase (the marks' own: 1 us each)
WORK = {"epoch": 5.0, "sample": 30.0, "fetch": 20.0, "forward": 100.0, "backward": 200.0,
        "sync": 15.0, "optimizer": 40.0, "accumulate": 7.0}
GAP_US = 700.0          # the host's turn between two epochs
BETWEEN_US = 50.0       # a kernel inside that turn (the next epoch's randomness)


def events(epochs, steps, sync=False, drop=None, foreign=None, with_marks=True):
    """A Chrome trace's events: the traced span, and for each epoch its
    marks each followed by one kernel of the phase's work; ``drop`` leaves
    out the n-th mark, ``foreign`` renames the n-th."""
    ev, t, n = [], 0.0, 0
    step = STEP[:4] + (("sync",) if sync else ()) + STEP[4:]

    def kernel(name, dur):
        nonlocal t
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": t, "dur": dur,
                   "pid": 0, "tid": 7})
        t += dur + 1.0

    def mark(phase):
        nonlocal n
        if with_marks and n != drop:
            kernel(f"pg_mark_{'bogus' if n == foreign else phase}", 1.0)
        n += 1

    for e in range(epochs):
        if e:
            t += GAP_US / 2
            kernel("randperm_kernel", BETWEEN_US)
            t += GAP_US / 2
        mark("epoch")
        kernel("zero_kernel", WORK["epoch"])
        for _ in range(steps):
            for p in step:
                mark(p)
                kernel(f"{p}_work_kernel", WORK[p])
        mark("epoch_end")
    ev.append({"ph": "X", "cat": "user_annotation", "name": SPAN, "ts": -10.0,
               "dur": t + 20.0, "pid": 0, "tid": 1})
    return ev


def readings(ev, epochs, steps):
    return Readings(trace=Trace(ev), epochs=epochs, steps=steps, flops=0.0,
                    take_rows_bytes=None, enqueue_s=0.0, enqueue_count=0, capture_s=None)


def read_all(ctx):
    return {m: importlib.import_module(f"gnnbench.metrics.{m}").read(ctx) for m in METRICS}


@pytest.mark.parametrize("sync", [False, True], ids=["single", "data_parallel"])
def test_a_sound_sequence_splits_by_phase(sync):
    epochs, steps = 3, 4
    ctx = readings(events(epochs, steps, sync=sync), epochs, epochs * steps)
    got = read_all(ctx)
    for p in ("sample", "fetch", "forward", "backward", "optimizer"):
        # each phase's kernel and nothing of its neighbours'; backward stops at sync
        assert got[f"{p}_ms_per_step"] == pytest.approx(WORK[p] * 1e-3)
    # the host's turn: the stretch between epoch_end and epoch less the kernel in it
    assert got["epoch_gap_ms"] == pytest.approx((GAP_US + 2.0) * 1e-3)
    split = marks.phases(ctx)["seconds"]
    assert split["sync"] == pytest.approx(WORK["sync"] * 1e-6 * epochs * steps if sync else 0)
    assert split["epoch_end"] == pytest.approx(BETWEEN_US * 1e-6 * (epochs - 1))
    # every kernel but the marks is in one phase: the phases add up to the whole
    marker_s = sum(d for n, _, d in ctx.trace.kernels if n.startswith("pg_mark_")) * 1e-6
    assert sum(split.values()) == pytest.approx(ctx.trace.kernel_seconds() - marker_s)


@pytest.mark.parametrize("kind", ["missing", "foreign", "none", "count"])
def test_a_broken_sequence_reads_nothing(kind):
    epochs, steps = 2, 3
    ev = events(epochs, steps, drop=9 if kind == "missing" else None,
                foreign=4 if kind == "foreign" else None, with_marks=kind != "none")
    # "count": sound marks, but not the run's steps
    ctx = readings(ev, epochs, epochs * steps + (1 if kind == "count" else 0))
    assert marks.phases(ctx) is None
    assert read_all(ctx) == {m: None for m in METRICS}


def test_the_single_device_sequence_has_no_sync_between_data_parallel_steps():
    """A trace with ``sync`` in some steps and not in others is no epoch."""
    ev = events(1, 2, sync=True)
    first_sync = next(i for i, e in enumerate(ev) if e["name"] == "pg_mark_sync")
    del ev[first_sync:first_sync + 2]          # the mark and its kernel
    assert marks.phases(readings(ev, 1, 2)) is None


def test_one_traced_epoch_has_no_gap_to_read():
    ctx = readings(events(1, 5), 1, 5)
    got = read_all(ctx)
    assert got["epoch_gap_ms"] is None
    assert got["forward_ms_per_step"] == pytest.approx(WORK["forward"] * 1e-3)
