"""Phase timers (the port of ``pagraph_tpu/utils/timers.py``): named
accumulating host wall-clock timers.

A scope measures host time: device work it enqueues may still be running
when it closes, unless the scope ends in a synchronize.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator


class PhaseTimers:
    """Named accumulating wall-clock timers."""

    def __init__(self):
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def scope(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        self.total[name] += time.perf_counter() - t0
        self.count[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "total_s": self.total[k],
                "count": self.count[k],
                "mean_ms": 1e3 * self.total[k] / max(self.count[k], 1),
            }
            for k in sorted(self.total)
        }
