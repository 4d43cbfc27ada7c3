"""Phase timers and profiling scopes (the port of
``pagraph_tpu/utils/timers.py``): named accumulating host wall-clock
timers, optional ``torch.profiler.record_function`` ranges, and a trace of a
region with ``torch.profiler``.

A scope measures host time: device work it enqueues may still be running
when it closes, unless the scope ends in a synchronize.  Scopes of one
``PhaseTimers`` may run in several threads at once (the loader's producers
beside the Trainer): the totals are updated under a lock.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch

from .device import resolve_device


class PhaseTimers:
    """Named accumulating wall-clock timers.  ``use_scopes``: each scope is
    also a ``torch.profiler.record_function`` range under its name (the JAX
    package's ``use_jax_scopes``), which a :func:`maybe_trace` trace shows.
    A scope left by an exception adds nothing."""

    def __init__(self, use_scopes: bool = False):
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)
        self.use_scopes = use_scopes
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def scope(self, name: str) -> Iterator[None]:
        ctx = (torch.profiler.record_function(name) if self.use_scopes
               else contextlib.nullcontext())
        t0 = time.perf_counter()
        with ctx:
            yield
        dt = time.perf_counter() - t0
        with self._lock:
            self.total[name] += dt
            self.count[name] += 1

    def reset(self) -> None:
        with self._lock:
            self.total.clear()
            self.count.clear()

    def summary(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                k: {
                    "total_s": self.total[k],
                    "count": self.count[k],
                    "mean_ms": 1e3 * self.total[k] / max(self.count[k], 1),
                }
                for k in sorted(self.total)
            }

    def report(self) -> str:
        lines = [f"{'phase':<16}{'total s':>10}{'count':>8}{'mean ms':>10}"]
        for k, v in self.summary().items():
            lines.append(
                f"{k:<16}{v['total_s']:>10.3f}{v['count']:>8}{v['mean_ms']:>10.3f}"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def maybe_trace(logdir: Optional[str], device=None) -> Iterator[None]:
    """Trace the region with ``torch.profiler`` when ``logdir`` is set, and
    write a Chrome trace (``trace_<pid>_<ns>.json``) into it; nothing when
    it is ``None``.  The run's ``device`` (``None``: the card, which must
    exist) decides what is recorded: CUDA activity beside the host's on a
    card, the host's alone on the CPU."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
