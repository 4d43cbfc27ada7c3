"""The traced stretch of a ``--trace 1`` run: ``torch.profiler`` over whole
epochs, its Chrome trace reduced to what the per-layer metrics read.

The traced span is the host range ``gnnbench.traced`` around the traced
epochs, from the first epoch's launch to the last epoch's sync.  Device time
is the CUDA kernels of the trace inside that span; busy time is the union of
their intervals.  A trace that holds no kernel fails the run: the profiler
saw no device work, and the benchmark does not fall back to another clock.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple

SPAN = "gnnbench.traced"
_HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")


class Trace:
    """Kernels ``(name, start_us, dur_us)`` inside the span ``(t0_us,
    t1_us)``, and the host events ``(name, start_us, dur_us)`` of the
    thread that ran the span."""

    def __init__(self, events: List[dict]):
        spans = [e for e in events if e.get("ph") == "X" and e.get("name") == SPAN
                 and e.get("cat") == "user_annotation"]
        if len(spans) != 1:
            raise RuntimeError(f"the trace holds {len(spans)} '{SPAN}' ranges, not one")
        s = spans[0]
        self.t0, self.t1 = float(s["ts"]), float(s["ts"]) + float(s["dur"])
        self.kernels: List[Tuple[str, float, float]] = []
        self.host: List[Tuple[str, float, float]] = []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            ts, dur = float(e["ts"]), float(e["dur"])
            if e.get("cat") == "kernel":
                if ts < self.t1 and ts + dur > self.t0:
                    self.kernels.append((e["name"], ts, dur))
            elif (e.get("cat") in _HOST_CATS and e.get("tid") == s.get("tid")
                  and e.get("pid") == s.get("pid") and ts < self.t1 and ts + dur > self.t0):
                self.host.append((e["name"], ts, dur))
        if not self.kernels:
            raise RuntimeError("the trace holds no CUDA kernel inside the traced epochs")

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the kernels' intervals, clipped to the span."""
        out: List[Tuple[float, float]] = []
        for _, ts, dur in sorted(self.kernels, key=lambda k: k[1]):
            a, b = max(ts, self.t0), min(ts + dur, self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def kernel_seconds(self, match: Optional[str] = None) -> float:
        """Summed device time of the kernels whose name holds ``match`` (all
        kernels when ``None``)."""
        return sum(d for n, _, d in self.kernels if match is None or match in n) * 1e-6

    def device_ops(self, top: int = 10) -> List[list]:
        by: Dict[str, float] = defaultdict(float)
        for n, _, d in self.kernels:
            by[n[:200]] += d * 1e-6
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """The longest stretches of the span with no kernel running, each
        named by the innermost host event running at its middle."""
        gaps, at = [], self.t0
        for a, b in self.busy_intervals():
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if self.t1 > at:
            gaps.append((at, self.t1))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:top]:
            mid = (a + b) / 2
            inside = [(d, n) for n, ts, d in self.host if ts <= mid <= ts + d and n != SPAN]
            out.append([min(inside)[1][:200] if inside else "host: no traced call", (b - a) * 1e-6])
        return out


@contextlib.contextmanager
def profiled(enabled: bool, cuda: bool = True) -> Iterator[dict]:
    """Profile the body when ``enabled``; the yielded dict gets ``"trace"``
    (a :class:`Trace`) once the body ends.  The Chrome trace goes to a file
    in the temporary directory and is deleted once read."""
    out: dict = {}
    if not enabled:
        yield out
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function(SPAN):
            yield out
        if cuda:
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    out["trace"] = Trace(events)
