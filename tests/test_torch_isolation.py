"""The port stands alone: ``pagraph_tpu_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of ``pagraph_tpu``, and its entry points refuse to
fall back to the CPU silently."""
import ast
import os
import subprocess
import sys

import pytest
import torch

import pagraph_tpu_torch as pt
from pagraph_tpu_torch.data.synthetic import synthetic_dataset
from pagraph_tpu_torch.train.loop import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "pagraph_tpu_torch")
SOURCES = sorted(
    [os.path.relpath(os.path.join(d, f), ROOT)
     for d, _, files in os.walk(PKG) for f in files if f.endswith(".py")]
    + ["chip_smoke.py"])
FORBIDDEN = ("jax", "jaxlib", "pagraph_tpu")


def test_import_loads_no_jax():
    """Importing every module of the port in a fresh interpreter leaves no
    JAX or pagraph_tpu module in sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import pagraph_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, 'pagraph_tpu_torch.')]\n"
        "assert len(mods) >= 15, mods\n"
        "for m in mods: importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("path", SOURCES)
def test_source_imports_no_jax(path):
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {n}"


def _tiny_cfg():
    return pt.Config(
        model=pt.ModelConfig(arch="graphsage", hidden=8, feat_dim=8, n_classes=3),
        sampler=pt.SamplerConfig(batch_size=16),
        cache=pt.CacheConfig(capacity=10))


def test_trainer_needs_a_card_unless_cpu_is_asked(monkeypatch):
    ds = synthetic_dataset(num_nodes=60, num_edges=300, feat_dim=8, num_classes=3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer.from_dataset(_tiny_cfg(), ds)
    assert Trainer.from_dataset(_tiny_cfg(), ds, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("train_kw", [dict(on_device_sampling=True),
                                      dict(remote_sampling=True),
                                      dict(eval_every=1),
                                      dict(lr_schedule="cosine", lr_decay_steps=5),
                                      dict(dtype="bfloat16")])
def test_unported_paths_raise(train_kw):
    ds = synthetic_dataset(num_nodes=60, num_edges=300, feat_dim=8, num_classes=3)
    cfg = _tiny_cfg()
    for k, v in train_kw.items():
        setattr(cfg.train, k, v)
    with pytest.raises(NotImplementedError):
        Trainer.from_dataset(cfg, ds, device="cpu")
