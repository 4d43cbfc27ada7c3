"""Time device inference and its window reduction for several checkouts of
the port, one after another on one card.

    python3 ab_window.py [--reps N] [--sweep] [--out FILE] ROOT [ROOT ...]

Each ROOT is a directory that holds a ``pagraph_tpu_torch`` package: ``.``
for this checkout, or another revision unpacked there with ``git archive``.
The roots run in the order given and then in the reverse order (A B, B A),
each run in a process of its own that imports the package from its root
and builds that root's kernels.  Every run builds ``chip_smoke.py``'s
RMAT-20 graph (scale 20, edge factor 16, seed 42; 100-dim uniform features,
seed 7) and reports, for the sum kind (mean) and the max kind (pool):

* ``window_ms``: ``gather_reduce`` on the F = 4096 bucket and on the hub
  table (470 windows of 4096), device ms a call from CUDA events, the L2
  cache flushed before each call (as ``chip_smoke.py`` times its kernels);
* ``aggregate_ms``: one layer's whole window reduction at the feature width
  (``_BucketedNeighborhoods.aggregate``: every table's launch and the hubs'
  second level), device ms from CUDA events;
* ``pass_s``: ``full_graph_logits(backend="device")`` of a 2-layer
  GraphSAGE (hidden 16, 47 classes, weights from seed 0), wall seconds of
  each of ``--reps`` passes after one warm-up pass;
* ``sweep_ms`` (with ``--sweep``, for a root whose ``gather_kernels`` has
  ``WINDOW_CTA_FANOUT``): ``gather_reduce`` (sum) on the buckets F = 128,
  256, 512, 1024 and 4096 with that threshold forced each way, a warp a
  row (``warp``) and a CTA of 8 warps a row (``cta``): where the threshold
  belongs.

Every run also holds its outputs against the plain version (sum within
F x 2^-24 of the largest, max exact) and exits non-zero if one disagrees.
The card's name and power limit, as ``nvidia-smi`` gives them, head the
output; each run prints one JSON line, and ``--out FILE`` also writes them
all to FILE.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

def time_ms(torch, fn, flush_buf, iters: int = 30, warmup: int = 3) -> float:
    """Mean device ms of ``fn`` a call, CUDA events around each call, the L2
    flushed (a write of 256 MB) and the stream kept busy before each."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush_buf.zero_()
        torch.cuda._sleep(1_000_000)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def run(root: str, reps: int, sweep: bool) -> dict:
    """One run: import the package under ``root`` and time it."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import pagraph_tpu_torch as pt
    from pagraph_tpu_torch.data import synthetic
    from pagraph_tpu_torch.graph import CSRGraph
    from pagraph_tpu_torch.models.inference import _BucketedNeighborhoods, full_graph_logits
    from pagraph_tpu_torch.models.sage import GraphSAGE
    from pagraph_tpu_torch.ops import _build
    from pagraph_tpu_torch.ops import gather_kernels as gk
    if not os.path.abspath(pt.__file__).startswith(root + os.sep):
        raise SystemExit(f"imported {pt.__file__}, not the package under {root}")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.load("gather_kernels")
    out = {"root": root, "build_s": time.perf_counter() - t0}

    graph = CSRGraph.from_coo(synthetic.rmat_coo(20, 16, seed=42))
    feats = np.random.default_rng(7).random((graph.num_nodes, 100), dtype=np.float32)
    x = torch.from_numpy(feats).to(dev)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    bn = _BucketedNeighborhoods(graph, dev)
    buckets = {p.shape[1]: (p, m) for lv, p, m in bn.tables() if lv == "bucket"}
    tables = {"F=4096": buckets[4096]}
    tables.update({f"hubs F={p.shape[1]}": (p, m) for lv, p, m in bn.tables()
                   if lv == "hubs"})
    bad = []
    out["window_ms"], out["aggregate_ms"], out["pass_s"] = {}, {}, {}
    for kind, agg in (("sum", "mean"), ("max", "pool")):
        for label, (pos, mask) in tables.items():
            got = gk.gather_reduce(x, pos, mask, kind)
            want = gk.gather_reduce_plain(x, pos, mask, kind)
            err = (got - want).abs().max().item()
            tol = pos.shape[1] * 2.0 ** -24 * want.abs().max().item() if kind == "sum" else 0.0
            if not err <= tol:
                bad.append(f"{kind} {label}: max |err| {err} > {tol}")
            out["window_ms"][f"{kind}, {label}"] = time_ms(
                torch, lambda p=pos, m=mask, k=kind: gk.gather_reduce(x, p, m, k), flush)
        out["aggregate_ms"][kind] = time_ms(torch, lambda k=kind: bn.aggregate(x, k), flush)

        cfg = pt.ModelConfig(arch="graphsage", n_layers=1, hidden=16, feat_dim=100,
                             n_classes=47, aggregator=agg, dropout=0.0)
        model = GraphSAGE(cfg, generator=torch.Generator().manual_seed(0)).to(dev)
        full_graph_logits(model, cfg, graph, feats, backend="device")
        passes = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            full_graph_logits(model, cfg, graph, feats, backend="device")
            torch.cuda.synchronize()
            passes.append(time.perf_counter() - t0)
        out["pass_s"][agg] = passes
    if sweep and hasattr(gk, "WINDOW_CTA_FANOUT"):
        threshold, out["sweep_ms"] = gk.WINDOW_CTA_FANOUT, {}
        for f in (128, 256, 512, 1024, 4096):
            pos, mask = buckets[f]
            want = gk.gather_reduce_plain(x, pos, mask, "sum")
            tol = f * 2.0 ** -24 * want.abs().max().item()
            row = out["sweep_ms"][f"F={f}"] = {}
            for form, forced in (("warp", 1 << 30), ("cta", 1)):
                gk.WINDOW_CTA_FANOUT = forced
                err = (gk.gather_reduce(x, pos, mask, "sum") - want).abs().max().item()
                if not err <= tol:
                    bad.append(f"sweep {form} F={f}: max |err| {err} > {tol}")
                row[form] = time_ms(
                    torch, lambda p=pos, m=mask: gk.gather_reduce(x, p, m, "sum"), flush)
        gk.WINDOW_CTA_FANOUT = threshold
    out["bad"] = bad
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--out")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        print(json.dumps(run(a.worker, a.reps, a.sweep)), flush=True)
        return
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: this script needs a CUDA card")
    if not a.roots:
        raise SystemExit("give at least one root")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    runs, failed = [], False
    for i, root in enumerate(a.roots + a.roots[::-1]):
        p = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root,
                            "--reps", str(a.reps)] + ["--sweep"] * a.sweep,
                           capture_output=True, text=True)
        sys.stderr.write(p.stderr[-4000:])
        lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
        if p.returncode or not lines:
            print(f"run {i} ({root}) failed with code {p.returncode}", flush=True)
            failed = True
            continue
        r = json.loads(lines[-1])
        r["run"] = i
        print(json.dumps(r), flush=True)
        failed |= bool(r["bad"])
        runs.append(r)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump({"nvidia_smi": smi, "runs": runs}, f, indent=1)
    if failed:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
