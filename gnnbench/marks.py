"""The traced epochs' device time by phase of a step, read from the
program's phase marks.

The program launches an empty kernel ``pg_mark_<phase>`` where each phase
of an on-device epoch starts (``pagraph_tpu_torch/ops/gather_kernels.py``
``mark``), inside its CUDA graphs too, when its ``PhaseTimers.use_scopes``
is on, as it is over a ``--trace 1`` run's traced epochs.  Sorted by start,
the trace's kernels split at the marks: each other kernel belongs to the
phase of the last mark before it.  An epoch reads

    epoch (sample fetch forward backward [sync] optimizer accumulate) x steps epoch_end

(``sync``, the gradients' all-reduce, in every step of a data-parallel
epoch and in none of a single device's).  The kernels after ``epoch_end``
and before the next epoch's ``epoch`` are the host's turn between epochs
(the next epoch's randomness, the benchmark's own copies).  A trace whose
marks are not that sequence, over the run's epochs and steps, reads
nothing: each metric of this module is then left out of the line (a
program without the marks, such as an older commit's, has none).
"""
from __future__ import annotations

import functools
import re
from typing import Dict, List, Optional

MARK = "pg_mark_"
# a letter a phase, for matching the sequence
_CODES = {"epoch": "E", "sample": "s", "fetch": "f", "forward": "w", "backward": "b",
          "sync": "y", "optimizer": "o", "accumulate": "a", "epoch_end": "Z"}
_SEQUENCES = (re.compile(r"(?:E(?:sfwboa)+Z)+"), re.compile(r"(?:E(?:sfwbyoa)+Z)+"))


@functools.lru_cache(maxsize=1)
def _split(trace) -> Optional[dict]:
    """``{"seconds": {phase: kernel seconds}, "epochs": n, "steps": n,
    "gaps": [idle seconds between epoch_end and the next epoch]}`` of the
    kernels ``(name, start_us, dur_us)`` of ``trace`` (a ``trace.Trace``),
    or ``None`` when their marks are not the sequence of whole epochs."""
    ks = sorted(trace.kernels, key=lambda k: k[1])
    marks = [(i, name[len(MARK):]) for i, (name, _, _) in enumerate(ks) if name.startswith(MARK)]
    if any(p not in _CODES for _, p in marks):
        return None
    seq = "".join(_CODES[p] for _, p in marks)
    if not any(r.fullmatch(seq) for r in _SEQUENCES):
        return None
    seconds: Dict[str, float] = {p: 0.0 for p in _CODES}
    phase = None
    for name, _, dur in ks:
        if name.startswith(MARK):
            phase = name[len(MARK):]
        elif phase is not None:
            seconds[phase] += dur * 1e-6
    return {"seconds": seconds, "epochs": seq.count("E"), "steps": seq.count("s"),
            "gaps": _gaps(ks, marks)}


def _gaps(ks: List[tuple], marks: List[tuple]) -> List[float]:
    """Idle seconds from each ``epoch_end`` mark's end to the next
    ``epoch`` mark's start: that stretch less the union of the kernels run
    inside it."""
    out = []
    for (i, p), (j, q) in zip(marks, marks[1:]):
        if (p, q) != ("epoch_end", "epoch"):
            continue
        a, b = ks[i][1] + ks[i][2], ks[j][1]
        busy, at = 0.0, a
        for _, ts, dur in ks[i + 1:j]:
            lo, hi = max(ts, at), min(ts + dur, b)
            if hi > lo:
                busy += hi - lo
                at = hi
        out.append(max(b - a - busy, 0.0) * 1e-6)
    return out


def phases(ctx) -> Optional[dict]:
    """The split of ``ctx.trace`` (:func:`_split`) when it holds the run's
    epochs and steps (``ctx.epochs``, ``ctx.steps``), else ``None``."""
    got = _split(ctx.trace)
    if got is None or got["epochs"] != ctx.epochs or got["steps"] != ctx.steps:
        return None
    return got


def phase_ms(ctx, phase: str) -> Optional[float]:
    """Kernel time of ``phase`` a step over the traced epochs, in ms."""
    got = phases(ctx)
    return None if got is None else 1e3 * got["seconds"][phase] / ctx.steps


def epoch_gap_ms(ctx) -> Optional[float]:
    """Device idle time between one traced epoch's end and the next one's
    start, averaged over those boundaries, in ms."""
    got = phases(ctx)
    if got is None or not got["gaps"]:
        return None
    return 1e3 * sum(got["gaps"]) / len(got["gaps"])
