"""What every cell shares: finding a cell's files by name, the caches'
places inside the checkout, the card's identity, the table of peaks, the
check that no JAX module was loaded, and the result line."""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
CACHE_DIR = os.path.join(BENCH_DIR, ".cache")

# Published peaks of one NVIDIA H100 SXM at 700 W (NVIDIA's data sheet, dense):
# float32 outside the tensor cores (TF32 is off in every cell), and HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12

# top-level module names that no run may load (compared whole: the port,
# pagraph_tpu_torch, begins with the JAX package's name and is allowed)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "pagraph_tpu", "benchmarks")


def cache_env() -> Dict[str, str]:
    """Build and kernel caches at fixed places inside the checkout, and
    libraries kept from loading JAX (set before torch is imported)."""
    env = {
        "TORCH_EXTENSIONS_DIR": os.path.join(CACHE_DIR, "torch_extensions"),
        "TRITON_CACHE_DIR": os.path.join(CACHE_DIR, "triton"),
        "CUDA_CACHE_PATH": os.path.join(CACHE_DIR, "nv_compute"),
        "USE_FLAX": "0",
        "USE_JAX": "0",
    }
    os.environ.update(env)
    return env


def read_json(*parts: str) -> dict:
    with open(os.path.join(BENCH_DIR, *parts)) as f:
        return json.load(f)


def benchmark_json() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load_cell(name: str) -> tuple:
    """``(workload, config)``: ``workloads/<name>.json`` and the
    ``configs/<config>.json`` it names."""
    wl = read_json("workloads", f"{name}.json")
    wl.setdefault("name", name)
    return wl, read_json("configs", f"{wl['config']}.json")


def cell_metrics(bench: dict, cell: str) -> tuple:
    """``(end_to_end, per_layer)`` entries of ``BENCHMARK.json`` that cell
    ``cell`` reports: a metric with a ``workloads`` key where it lists the
    cell, one without where the cell reports the metric it moves."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, per


def forbidden_loaded() -> List[str]:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def card_identity() -> dict:
    """nvidia-smi's name, power limit and clocks of each visible card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,clocks.mem",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60, check=True)
    return {"nvidia_smi": [line.strip() for line in out.stdout.strip().splitlines()]}


def log(*parts) -> None:
    print("[gnnbench]", *parts, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Run:
    """One run of one cell: its arguments, files and clocks."""

    workload: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t_start: float = dataclasses.field(default_factory=time.perf_counter)
    cache: Optional[str] = None          # None: gnnbench/.cache
    # called with (phase, objects) at named points of a run: a test plants a
    # fault there; runs of the benchmark leave it None
    hook: Optional[Callable[[str, dict], None]] = None
    fault: Optional[str] = None          # a fault of faults.py each rank plants (tests)

    @property
    def name(self) -> str:
        return self.workload["name"]

    def cache_dir(self) -> str:
        return self.cache or CACHE_DIR

    def at(self, phase: str, **objects) -> None:
        if self.hook is not None:
            self.hook(phase, objects)


def checks_block(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each compared number beside its limit, in the limits' order; a number
    the run could not compute is ``None`` and fails."""
    missing = set(limits) - set(numbers)
    if missing:
        raise KeyError(f"no reading for the limits {sorted(missing)}")
    return {k: {"value": numbers[k], "limit": limits[k]} for k in limits}


def checks_pass(block: Dict[str, dict]) -> bool:
    return all(c["value"] is not None and c["value"] <= c["limit"] for c in block.values())


def print_checks(block: Dict[str, dict]) -> None:
    """The compared numbers as the last lines on standard error."""
    for k, c in block.items():
        ok = c["value"] is not None and c["value"] <= c["limit"]
        print(f"check {k} = {c['value']!r} limit {c['limit']!r} {'ok' if ok else 'FAIL'}",
              file=sys.stderr, flush=True)
