"""Nothing the benchmark runs imports JAX, the JAX package or the JAX
benchmarks (top-level names compared whole), the reference imports nothing
of the program, and a run without a card fails with no result."""
import ast
import json
import os
import subprocess
import sys

from conftest import ROOT

BENCH = os.path.join(ROOT, "gnnbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "pagraph_tpu", "benchmarks"}


def sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        if ".cache" in d:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def imported_tops(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    bad = {p: sorted(set(imported_tops(p)) & FORBIDDEN) for p in sources()}
    assert not {p: b for p, b in bad.items() if b}


def test_reference_imports_nothing_of_the_program():
    bad = {p: sorted(set(imported_tops(p)) & (FORBIDDEN | {"pagraph_tpu_torch"}))
           for p in sources("reference")}
    assert not {p: b for p, b in bad.items() if b}


def test_every_module_imports_clean_in_a_fresh_process():
    mods = sorted({"gnnbench." + os.path.relpath(p, BENCH)[:-3].replace(os.sep, ".")
                   .replace(".__init__", "") for p in sources() if "/tests/" not in p})
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "import pagraph_tpu_torch.train.loop, pagraph_tpu_torch.train.device_epoch\n"
            "print(sorted({n.split('.')[0] for n in sys.modules} & "
            f"set({sorted(FORBIDDEN)!r})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"}, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_a_card_fails_and_prints_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    for cell in ("sage-products.device", "gcn-reddit.device"):
        out = subprocess.run([sys.executable, "gnnbench/run.py", "--workload", cell, "--seed",
                              "2147483700", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                             capture_output=True, text=True, env=env, timeout=300)
        assert out.returncode != 0
        for line in out.stdout.splitlines():
            try:
                assert "correct" not in json.loads(line)
            except json.JSONDecodeError:
                pass
