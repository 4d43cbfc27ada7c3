"""gnnbench: the benchmark of pagraph_tpu_torch, one run of one cell.

Run a cell from the root of a checkout, on a machine with the cards it asks
for::

    python3 gnnbench/run.py --workload sage-products.device --seed 7 --seconds 10 --trace 0

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (its first ``trace_epochs`` window epochs under
``torch.profiler``).  Both check the program against the plain reference
(``check.py``) and print the compared numbers beside their limits, as the
last lines on standard error and under ``checks`` at the end of the result,
the one JSON line printed last on standard output.  Without a CUDA card, or
with fewer than the cell asks for, the run fails and prints no result.

Caches, all inside the checkout and never written elsewhere: the datasets
(``gnnbench/.cache/data/<config>/``, made by ``data.py`` in a checkout's
first run of the configuration, about 1.5 GiB for the largest), the
program's nvcc and g++ builds (``pagraph_tpu_torch/_build/``), and the
PyTorch, Triton and CUDA kernel caches (``gnnbench/.cache/``).

Adding to the benchmark takes new files and entries, no edit:

* a configuration: ``configs/<name>.json`` (its ``data``, ``model``,
  ``sampler`` and ``train`` sections, with ``source``, ``assumed`` and
  ``reduced``) and, for a new architecture, ``reference/<arch>.py`` (the
  plain forward and the initial leaves) and ``flops/<arch>.py``;
* a cell: ``workloads/<cell>.json`` (its ``config``, ``path``, ``chips``,
  ``world_size``, the Trainer's ``train`` settings, ``trace_epochs``,
  ``check_steps`` and ``limits``) and its entry in ``BENCHMARK.json``; a new
  program path is a new ``paths/<path>.py``;
* a per-layer metric: ``metrics/<name>.py`` (``read(readings)``) and its
  entry in ``BENCHMARK.json``.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    __package__ = "gnnbench"

from .harness import (Run, benchmark_json, cache_env, card_identity, cell_metrics,  # noqa: E402
                      checks_block, checks_pass, forbidden_loaded, load_cell, log,
                      print_checks)


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result_line(run: Run, out: dict, e2e_specs, per_specs) -> dict:
    """The result line: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device`` (and ``breakdown`` when traced), ``checks``
    last."""
    checks = checks_block(out["numbers"], run.workload["limits"])
    metrics = {}
    if run.trace:
        mods = {m["name"]: importlib.import_module(f"{__package__}.metrics.{m['name']}")
                for m in per_specs}
        for m in per_specs:
            v = mods[m["name"]].read(out["readings"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in e2e_specs:
            metrics[m["name"]] = {"value": out["e2e"][m["name"]], "unit": m["unit"]}
    import torch

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": run.workload["chips"], "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": checks_pass(checks), "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    if run.trace:
        tr = out["readings"].trace
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        line["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    line["checks"] = checks
    return line


def leaked(out: dict) -> list:
    """The forbidden modules loaded in this process or, in a data-parallel
    cell, in any rank (``out["forbidden"]``), once the window has closed."""
    return sorted(set(forbidden_loaded()) | set(out.get("forbidden", ())))


def main(argv=None) -> int:
    args = parse(argv)
    cache_env()
    import torch

    wl, config = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        log(f"cell {args.workload} needs {wl['chips']} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    e2e_specs, per_specs = cell_metrics(benchmark_json(), args.workload)
    card = card_identity()
    card.update(torch=torch.__version__, cuda=torch.version.cuda)
    print(json.dumps({"card": card}), flush=True)
    run = Run(workload=wl, config=config, seed=args.seed, seconds=args.seconds,
              trace=bool(args.trace), t_start=T_START)
    path = importlib.import_module(f"{__package__}.paths.{wl['path']}")
    out = path.run_cell(run)
    found = leaked(out)
    if found:
        log(f"modules of JAX or the JAX package were loaded: {found}")
        return 3
    log(f"readings (compared and not): {json.dumps(out['numbers'])}")
    line = result_line(run, out, e2e_specs, per_specs)
    print(json.dumps({"cell": run.name, "memory_peak_bytes": out["memory_peak_bytes"],
                      "setup_s": out["e2e"]["setup_s"]}), flush=True)
    print(json.dumps(line), flush=True)
    print_checks(line["checks"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
