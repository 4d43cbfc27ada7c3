"""The on-device path of ``paths/device.py`` for a GAT cell: the same run,
whose traced readings also hold the least bytes of the traced steps'
attention kernels (``Readings.gat_attention_bytes``, which
``metrics/gat_attention_roofline_pct.py`` reads).  The kernels read a
neighbor slot's row of ``z`` only where the slot is valid, so the count
takes each traced step's valid slots from the reference sampler's batches.
``device.run_cell`` has no hook for a further reading, so for the length of
the run :func:`run_cell` stands in for ``check.take_rows_bytes``, which
``device.run_cell`` calls once with the inputs and the traced epochs, with
:func:`traced_bytes`: both counts from one pass over the batches."""
from __future__ import annotations

from typing import Tuple

from .. import check
from ..flops.gat import attention_bytes
from ..harness import Run
from . import device


def traced_bytes(inp: "check.Inputs", config: dict, seed: int, epochs) -> Tuple[float, int]:
    """``(check.take_rows_bytes(...), the attention kernels' least bytes)``
    over every step of ``epochs``, from one pass of the reference sampler."""
    rows = check.layer_rows(config)
    feat_dim = config["data"]["feat_dim"]
    take, gat = 0.0, 0
    for e in epochs:
        for layers, *_ in inp.batches(config, seed, e):
            take += check.fetch_bytes(layers[0][0], feat_dim)
            valid = [int(mask[n:].sum()) for (_, mask), n in zip(layers[:-1], rows[1:])]
            gat += attention_bytes(config["model"], rows, valid)
    return take, gat


def run_cell(run: Run) -> dict:
    counted = {}
    take_rows_bytes = check.take_rows_bytes

    def both(inp, config, seed, epochs):
        take, counted["gat"] = traced_bytes(inp, config, seed, epochs)
        return take

    check.take_rows_bytes = both
    try:
        out = device.run_cell(run)
    finally:
        check.take_rows_bytes = take_rows_bytes
    if "readings" in out:
        out["readings"].gat_attention_bytes = counted["gat"]
    return out
