"""``pagraph_tpu_torch/utils/timers.py`` against
``pagraph_tpu/utils/timers.py``: ``report`` equal character for character,
``reset``, and ``maybe_trace``'s Chrome trace with the scope names in it."""
import glob
import json
import os

import pytest
import torch

from pagraph_tpu.utils.timers import PhaseTimers as JTimers
from pagraph_tpu_torch.utils.timers import PhaseTimers, maybe_trace

TOTALS = [
    {},
    {"step": (1.2345678, 114)},
    {"step": (0.25, 4), "capture": (0.0, 0), "h2d": (12.5, 3), "a_very_long_phase_name": (1e-4, 1)},
    {"cv-refresh": (123.456789, 7), "enqueue": (0.0004, 2)},
]


def _filled(cls, totals):
    t = cls()
    for k, (s, n) in totals.items():
        t.total[k], t.count[k] = s, n
    return t


@pytest.mark.parametrize("totals", TOTALS)
def test_report_equals_jax(totals):
    t, j = _filled(PhaseTimers, totals), _filled(JTimers, totals)
    assert t.report() == j.report()
    assert t.summary() == j.summary()


def test_reset_clears_totals_and_counts():
    t = PhaseTimers()
    with t.scope("step"):
        pass
    assert t.count["step"] == 1 and t.total["step"] >= 0
    t.reset()
    assert not t.total and not t.count and t.summary() == {}
    assert t.report() == JTimers().report()


def test_maybe_trace_writes_a_trace_with_the_scope_names(tmp_path):
    t = PhaseTimers(use_scopes=True)
    assert not PhaseTimers().use_scopes
    with maybe_trace(str(tmp_path), device="cpu"):
        with t.scope("pagraph_scope_under_trace"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = glob.glob(os.path.join(tmp_path, "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "pagraph_scope_under_trace" in names
    assert t.count["pagraph_scope_under_trace"] == 1


def test_maybe_trace_none_writes_nothing(tmp_path):
    ran = []
    with maybe_trace(None):
        ran.append(1)
    assert ran == [1] and not os.listdir(tmp_path)


def test_maybe_trace_needs_the_card_unless_cpu_is_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with maybe_trace(str(tmp_path)):
            pass
    assert not glob.glob(os.path.join(tmp_path, "trace_*.json"))
