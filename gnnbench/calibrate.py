"""The readings that a cell's limits are set from, on the card at the
cell's own size, in one process (the dataset loaded once):

* sound runs of the program as the configuration states it, one a seed;
* the control: the program's own ``train.dtype="bfloat16"`` path, the
  nearest precision below the configuration's float32;
* faults planted in the program (``faults.py``), before the first step or,
  with the prefix ``replay_``, in the replayed epochs alone.

Each reading is the program's epochs 0 to 2 (:func:`paths.device.
reading_epochs`: epoch 0 eager under :class:`probe.StepProbe`, epoch 1 the
capture, epoch 2 the second replay), the program freed, then the
reference's first steps, its epoch 2 from the program's state before it,
and both epochs' counts (``check.py``): the numbers a run compares, without
a measured window.  One JSON line a reading goes to standard output::

    python3 gnnbench/calibrate.py --workload gcn-reddit.device --base 1000 --sound 12 \
        --control 3 --faults replay_half_batch,half_batch --fault-seeds 3 \
        --look 1003 --seeds 2147480001

``--look`` reads those seeds against a float32 reference too, and the float32
reference against the float64 one, over the first steps and over the
replayed epoch (``check.witness``, ``check.replay_witness``): whether a
seed's gap lies in the program or in the rounding of the arithmetic.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    __package__ = "gnnbench"

from . import check, faults  # noqa: E402
from .harness import Run, cache_env, load_cell, log  # noqa: E402


def reading(run: Run, arrays: dict, inp: "check.Inputs", dtype=None, look=False) -> dict:
    from .paths import device as path

    tr = path.build_trainer(run, arrays, dtype)
    probe, snap, loss, counted = path.reading_epochs(run, tr)
    del tr
    path.free()
    numbers = path.checked(run, inp, probe, snap, loss, counted)
    if look:
        numbers["witness"] = check.witness(inp, run.config, run.seed, probe,
                                           run.workload["check_steps"])
        numbers["witness"]["replay_ref32_vs_ref64"] = check.replay_witness(inp, run.config,
                                                                           run.seed, snap)
    return numbers


def single_device(base: Run, plan, looks=()) -> list:
    """Readings of a one-card cell, the dataset made once."""
    from .paths import device as path

    arrays = path.load_arrays(base)
    inp = check.Inputs(arrays, base.device)
    rows = []
    for kind, seed, fault in plan:
        run = dataclasses.replace(base, seed=seed)
        t = time.perf_counter()
        with faults.planted(fault, run) if fault else contextlib.nullcontext():
            numbers = reading(run, arrays, inp, "bfloat16" if kind == "control" else None,
                              look=seed in looks)
        rows.append({"kind": kind, "seed": seed, "numbers": numbers,
                     "s": time.perf_counter() - t})
        log(json.dumps(rows[-1]))
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--base", type=int, default=1000, help="first seed")
    p.add_argument("--sound", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--look", default="", help="seeds also read against a float64 reference")
    p.add_argument("--seeds", default="", help="sound seeds to read besides --base's")
    args = p.parse_args(argv)
    cache_env()
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not torch.cuda.is_available():
        log("the readings are taken on a CUDA card; found none")
        return 2
    wl, config = load_cell(args.workload)
    base = Run(workload=wl, config=config, seed=args.base, seconds=0, trace=False)
    kinds = ([("sound", None)] * args.sound + [("control", None)] * args.control
             + [(f, f) for f in args.faults.split(",") if f for _ in range(args.fault_seeds)])
    plan = [(kind, args.base + i, fault) for i, (kind, fault) in enumerate(kinds)]
    plan += [("sound", int(x), None) for x in args.seeds.split(",") if x]
    looks = {int(x) for x in args.look.split(",") if x}
    if wl["path"] == "dp_device":
        from .paths import dp_device

        rows = dp_device.calibrate(base, plan)
    else:
        rows = single_device(base, plan, looks)
    for row in rows:
        print(json.dumps({"cell": args.workload, **row}), flush=True)
    log("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
