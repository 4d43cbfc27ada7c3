"""The port stands alone: ``pagraph_tpu_torch``, ``chip_smoke.py``,
``ab_window.py`` and ``bench_torch.py`` import neither JAX nor anything of
``pagraph_tpu``, and its entry points refuse to fall back to the CPU
silently."""
import ast
import os
import subprocess
import sys

import pytest
import torch

import pagraph_tpu_torch as pt
from pagraph_tpu_torch.data.synthetic import synthetic_dataset
from pagraph_tpu_torch.sampling.loader import PrefetchLoader
from pagraph_tpu_torch.storage.cache import FeatureCache
from pagraph_tpu_torch.train.loop import Trainer
from pagraph_tpu_torch.train.state import create_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "pagraph_tpu_torch")
SOURCES = sorted(
    [os.path.relpath(os.path.join(d, f), ROOT)
     for d, _, files in os.walk(PKG) for f in files if f.endswith(".py")]
    + ["chip_smoke.py", "ab_window.py", "bench_torch.py"])
FORBIDDEN = ("jax", "jaxlib", "pagraph_tpu")
# every source file of the port, C++ and CUDA included, and the scripts
ALL_SOURCES = sorted(
    [os.path.relpath(os.path.join(d, f), ROOT)
     for d, _, files in os.walk(PKG) for f in files
     if f.endswith((".py", ".cpp", ".cu", ".cuh", ".h"))]
    + ["chip_smoke.py", "ab_window.py", "bench_torch.py"])


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


def test_sampling_workers_import_no_torch():
    """The sampling service's workers import only host modules: its module,
    the native sampler and the slot layout load neither torch (so no
    worker initialises CUDA) nor JAX, and the package's names still
    resolve on first use."""
    code = (
        "import sys\n"
        "import pagraph_tpu_torch.sampling.service, pagraph_tpu_torch.sampling.native\n"
        "import pagraph_tpu_torch.sampling.pack\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {('torch',) + FORBIDDEN!r}]\n"
        "from pagraph_tpu_torch.sampling import MiniBatch, NeighborSampler, PrefetchLoader\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_scan_covers_the_host_path_modules():
    for m in ("sampling/native.py", "sampling/pack.py", "sampling/sampler.py",
              "storage/feature_store.py", "train/state.py", "train/loop.py",
              "models/inference.py", "train/checkpoint.py", "ops/aggregate.py",
              "parallel/__init__.py", "parallel/dp_trainer.py", "parallel/multihost.py",
              "parallel/train_step.py", "parallel/halo.py", "utils/sync.py",
              "sampling/service.py", "utils/platform.py", "utils/timers.py",
              "cli/__init__.py", "cli/common.py", "cli/train.py", "cli/launch.py",
              "cli/scalebench.py", "cli/preprocess.py", "cli/convert.py", "cli/partition.py",
              "cli/verify_partition.py", "cli/analyze.py", "cli/eval.py", "cli/infer.py"):
        assert os.path.join("pagraph_tpu_torch", m) in SOURCES
    assert os.path.join("pagraph_tpu_torch", "csrc", "host_native.cpp") in ALL_SOURCES
    assert "bench_torch.py" in SOURCES


@pytest.mark.parametrize("path", ALL_SOURCES)
def test_source_names_no_jax_native_library(path):
    """The port builds and loads its own host library
    (``csrc/host_native.cpp``): no source names the JAX package's."""
    with open(os.path.join(ROOT, path)) as f:
        text = f.read()
    for name in ("native/pagraph_native", "_pagraph_native"):
        assert name not in text, f"{path} names {name}"


def _tiny_cfg():
    return pt.Config(
        model=pt.ModelConfig(arch="graphsage", hidden=8, feat_dim=8, n_classes=3),
        sampler=pt.SamplerConfig(batch_size=16),
        cache=pt.CacheConfig(capacity=10))


def test_trainer_needs_a_card_unless_cpu_is_asked(monkeypatch):
    """Every public constructor of the port takes ``device=None`` as the GPU:
    without one it raises, and ``device="cpu"`` is the explicit CPU."""
    ds = synthetic_dataset(num_nodes=60, num_edges=300, feat_dim=8, num_classes=3)
    cfg = _tiny_cfg()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer.from_dataset(cfg, ds)
    tr = Trainer.from_dataset(cfg, ds, device="cpu")
    assert tr.device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_state(cfg, seed=0)
    assert next(create_state(cfg, seed=0, device="cpu").model.parameters()).device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FeatureCache(tr.store, ["features"], ds.graph)
    assert FeatureCache(tr.store, ["features"], ds.graph, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PrefetchLoader(tr.sampler, tr.cache)
    assert PrefetchLoader(tr.sampler, tr.cache, device="cpu").device.type == "cpu"


def test_dp_trainer_needs_a_card_unless_cpu_is_asked(monkeypatch):
    """The data-parallel trainer, in a one-rank gloo group, takes
    ``device=None`` as the GPU too."""
    import torch.distributed as dist

    from pagraph_tpu_torch.parallel import DataParallelTrainer, init_distributed

    ds = synthetic_dataset(num_nodes=60, num_edges=300, feat_dim=8, num_classes=3)
    cfg = _tiny_cfg()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    init_distributed(0, 1, backend="gloo")
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DataParallelTrainer.from_dataset(cfg, ds)
        assert DataParallelTrainer.from_dataset(cfg, ds, device="cpu").device.type == "cpu"
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("train_kw", [dict(remote_sampling=True),
                                      dict(arch="gcn_cv", preprocess=True)])
def test_unported_paths_raise(train_kw):
    """Nothing of the single-device Trainer is left to port: remote
    sampling builds its sampling service (tests/test_torch_service.py), and
    CV-GCN builds (tests/test_torch_cv_gcn.py), only its per-step device
    dispatch modes raising, with the JAX package's ``ValueError``.  (GCN,
    GIN and GAT are ported too: tests/test_torch_gcn.py, test_torch_gin.py,
    test_torch_gat.py.)"""
    from pagraph_tpu_torch.sampling.service import SampleService

    ds = synthetic_dataset(num_nodes=60, num_edges=300, feat_dim=8, num_classes=3)
    cfg = _tiny_cfg()
    for k, v in train_kw.items():
        setattr(cfg.model if hasattr(cfg.model, k) else cfg.train, k, v)
    if cfg.model.arch == "gcn_cv":
        cfg.sync_hops()
        assert Trainer.from_dataset(cfg, ds, device="cpu").cv_history is not None
        cfg.train.on_device_sampling, cfg.train.epoch_dispatch = True, "steps"
        with pytest.raises(ValueError, match="does not support gcn_cv"):
            Trainer.from_dataset(cfg, ds, device="cpu")
        return
    tr = Trainer.from_dataset(cfg, ds, device="cpu")
    try:
        assert isinstance(tr.sampler, SampleService) and tr.sampler.workers
    finally:
        tr.close()
    assert not tr.sampler.workers
